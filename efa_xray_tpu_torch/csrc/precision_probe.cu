// P: the precision probe.  C = A B for f32 A [n, k] and B [k, m] in one of
// three modes, so that what a product loses in each precision can be held
// against a float64 oracle on the card.
//
// Replaces: benchmarks/precision_probe.py, _make_kernel (launched by mm),
// which probes how the TPU's matrix unit takes f32 inputs.  The modes map
// the TPU's onto Hopper:
//   0 "ieee": plain fp32 FMA through shared-memory tiles (what "highest"
//             asks for, and what a torch f32 product does with TF32 off);
//   1 "tf32": tensor cores through nvcuda::wmma, m16n16k8 with
//             precision::tf32 and fp32 accumulators, the inputs rounded by
//             __float_to_tf32 (cvt.rna: nearest, ties away from zero): the
//             counterpart of the TPU's single-pass default;
//   2 "bf16": inputs rounded with __float2bfloat16_rn, wmma m16n16k16,
//             fp32 accumulators.
// n, k and m must be multiples of 16 (the wrapper checks).
//
// What bounds it on an H100: at 1024 the product is 2.1 GFLOP over 12 MB,
// so the fp32 mode is bound by operations (67 TFLOP/s), the tensor-core
// modes by the 3.35 TB/s of memory or by 495 (TF32) / 989 (bf16) TFLOP/s.
//
// What the design does about it: nothing yet.  It is a probe of numbers,
// not a fast product: the fp32 mode is the textbook 16 x 16 shared-memory
// tiling, one output per thread; the tensor-core modes give each warp one
// 16 x 16 output tile and stage the 16 x 16 input tiles through shared
// memory, rounding them on the way.  wgmma, TMA and deeper tiles are work
// for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kTile = 16;

__global__ void mm_ieee_kernel(const float* __restrict__ a,
                               const float* __restrict__ b,
                               float* __restrict__ c, int n, int k, int m) {
  __shared__ float as[kTile][kTile];
  __shared__ float bs[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row = blockIdx.y * kTile + ty, col = blockIdx.x * kTile + tx;
  float acc = 0.0f;
  for (int k0 = 0; k0 < k; k0 += kTile) {
    as[ty][tx] = a[(long)row * k + k0 + tx];
    bs[ty][tx] = b[(long)(k0 + ty) * m + col];
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTile; ++kk) acc = fmaf(as[ty][kk], bs[kk][tx], acc);
    __syncthreads();
  }
  c[(long)row * m + col] = acc;
}

// One warp per 16 x 16 output tile.
template <bool kBf16>
__global__ void mm_wmma_kernel(const float* __restrict__ a,
                               const float* __restrict__ b,
                               float* __restrict__ c, int n, int k, int m) {
  using In = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  // wmma loads and stores need 256-bit aligned addresses.
  __shared__ __align__(32) In as[kTile * kTile];
  __shared__ __align__(32) In bs[kTile * kTile];
  const int lane = threadIdx.x;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  wmma::fragment<wmma::accumulator, 16, 16, kBf16 ? 16 : 8, float> acc;
  wmma::fill_fragment(acc, 0.0f);
  for (int k0 = 0; k0 < k; k0 += kTile) {
    for (int idx = lane; idx < kTile * kTile; idx += 32) {
      const int r = idx / kTile, q = idx - r * kTile;
      const float x = a[(long)(row0 + r) * k + k0 + q];
      const float y = b[(long)(k0 + r) * m + col0 + q];
      if constexpr (kBf16) {
        as[idx] = __float2bfloat16_rn(x);
        bs[idx] = __float2bfloat16_rn(y);
      } else {
        as[idx] = wmma::__float_to_tf32(x);
        bs[idx] = wmma::__float_to_tf32(y);
      }
    }
    __syncwarp();
    if constexpr (kBf16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb;
      wmma::load_matrix_sync(fa, as, kTile);
      wmma::load_matrix_sync(fb, bs, kTile);
      wmma::mma_sync(acc, fa, fb, acc);
    } else {
#pragma unroll
      for (int kk = 0; kk < kTile; kk += 8) {
        wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32,
                       wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fa, as + kk, kTile);
        wmma::load_matrix_sync(fb, bs + kk * kTile, kTile);
        // The staged values are already tf32; the conversion is the
        // documented step and leaves them unchanged.
        for (int i = 0; i < fa.num_elements; ++i)
          fa.x[i] = wmma::__float_to_tf32(fa.x[i]);
        for (int i = 0; i < fb.num_elements; ++i)
          fb.x[i] = wmma::__float_to_tf32(fb.x[i]);
        wmma::mma_sync(acc, fa, fb, acc);
      }
    }
    __syncwarp();
  }
  wmma::store_matrix_sync(c + (long)row0 * m + col0, acc, m,
                          wmma::mem_row_major);
}

}  // namespace

extern "C" {

// mode: 0 ieee, 1 tf32, 2 bf16.  Returns a cudaError_t.
int efa_precision_mm(const float* a, const float* b, float* c, int n, int k,
                     int m, int mode, void* stream) {
  if (n % kTile || k % kTile || m % kTile || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(m / kTile, n / kTile);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0)
    mm_ieee_kernel<<<grid, dim3(kTile, kTile), 0, s>>>(a, b, c, n, k, m);
  else if (mode == 1)
    mm_wmma_kernel<false><<<grid, 32, 0, s>>>(a, b, c, n, k, m);
  else
    mm_wmma_kernel<true><<<grid, 32, 0, s>>>(a, b, c, n, k, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
