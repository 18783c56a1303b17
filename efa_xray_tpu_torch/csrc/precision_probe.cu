// P: the precision probe.  C = A B for f32 A [n, k] and B [k, m] in one of
// three modes, so that what a product loses in each precision can be held
// against a float64 oracle on the card.
//
// Replaces: benchmarks/precision_probe.py, _make_kernel (launched by mm),
// which probes how the TPU's matrix unit takes f32 inputs.  The modes map
// the TPU's onto Hopper:
//   0 "ieee": plain fp32 FMA (what "highest" asks for, and what a torch f32
//             product does with TF32 off);
//   1 "tf32": tensor cores, the inputs rounded with cvt.rna.tf32.f32
//             (nearest, ties away from zero), fp32 accumulators: the
//             counterpart of the TPU's single-pass default;
//   2 "bf16": inputs rounded to bf16 (nearest even), fp32 accumulators.
// n, k and m must be multiples of 16 (the wrapper checks); edge tiles are
// zero-filled on the way in and masked on the way out.
//
// What bounds it on an H100: operations.  At 1024^3 the product is 2.1
// GFLOP over 12 MB: 0.032 ms at the 67 TFLOP/s of fp32 FMA, 0.004 ms on the
// tensor cores (495 TF32 / 989 bf16 TFLOP/s), where launch and wave effects
// are then most of the time; at 4096^3 (137 GFLOP over 201 MB) 2.05 / 0.28 /
// 0.14 ms.  A kernel only gets near those if every operand byte fetched
// from shared memory feeds many FMAs and loads run ahead of the arithmetic.
//
// What the design does about it.
// ieee: a CTA owns a BM x BN tile of C (128 x 128 once those tiles fill the
//   132 SMs, else 128 x 64: measured at 1024^3 and 4096^3), walks k in steps
//   of 16 through a three-stage cp.async ring (16-byte copies, zero-filled past
//   the edges), and every thread keeps an 8 x 8 register tile: per four
//   k-steps it reads eight float4 of A (row-major in shared memory, four k
//   values of one row each) and eight float4 of B for 256 FMAs, one 16-byte
//   shared load per 16 FMAs.
// tf32 / bf16: wgmma.  A small pre-pass (round_pack_kernel) writes rounded
//   copies of A [n, k] and of B transposed to [m, k] (tf32 wgmma takes only
//   K-major operands) into zero-padded scratch from the wrapper, so the main
//   kernel needs no masks on its loads and rounds nothing.  The main kernel
//   gives each warpgroup a 64 x 128 tile of C in 64 accumulator registers
//   (m64n128k8 for tf32, m64n128k16 for bf16); a CTA is one or two
//   warpgroups (64 or 128 rows x 128 columns).  Operand tiles are 128 bytes
//   of k per row (32 tf32 or 64 bf16 values), written by 16-byte cp.async
//   into the 128-byte-swizzled K-major layout the wgmma descriptors name
//   (16-byte chunk c of row r at chunk c ^ (r & 7), 8-row groups 1024 bytes
//   apart), in a four-stage ring: the copies of tile kt + 2 are started
//   before the wgmmas of tile kt, and one wgmma group stays in flight while
//   the next tile is awaited.  The pre-pass's time is part of P's time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kSizeMultiple = 16;
constexpr int kNumSMs = 132;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; copies nothing and zero-fills when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// ---------------------------------------------------------------------------
// ieee: fp32 FMA, 8 x 8 register tiles.

constexpr int kIeeeBK = 16;
constexpr int kIeeeLda = kIeeeBK + 4;  // row stride of the A tile (floats)
constexpr int kIeeeStages = 3;

constexpr int ieee_smem_bytes(int BM, int BN) {
  return kIeeeStages * (BM * kIeeeLda + kIeeeBK * BN) * (int)sizeof(float);
}

template <int BM, int BN>
__global__ void __launch_bounds__((BM / 8) * (BN / 8))
    mm_ieee_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ c, int n, int k, int m) {
  constexpr int TX = BN / 8, TY = BM / 8, NT = TX * TY;
  constexpr int kAStage = BM * kIeeeLda, kBStage = kIeeeBK * BN;
  extern __shared__ __align__(16) float smem_f[];
  float* As = smem_f;
  float* Bs = smem_f + kIeeeStages * kAStage;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int KT = k / kIeeeBK;

  auto load_stage = [&](int kt, int s) {
    const int k0 = kt * kIeeeBK;
    for (int idx = tid; idx < BM * 4; idx += NT) {
      const int r = idx >> 2, ch = idx & 3;
      const bool ok = row0 + r < n;
      const float* src = ok ? a + (size_t)(row0 + r) * k + k0 + ch * 4 : a;
      cp_async16(smem_u32(As + s * kAStage + r * kIeeeLda + ch * 4), src, ok);
    }
    for (int idx = tid; idx < kIeeeBK * (BN / 4); idx += NT) {
      const int kk = idx / (BN / 4), ch = idx - kk * (BN / 4);
      const bool ok = col0 + ch * 4 < m;
      const float* src = ok ? b + (size_t)(k0 + kk) * m + col0 + ch * 4 : b;
      cp_async16(smem_u32(Bs + s * kBStage + kk * BN + ch * 4), src, ok);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int s = 0; s < kIeeeStages - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kIeeeStages - 2>();
    __syncthreads();
    // The stage refilled here was computed on in iteration kt - 1, which
    // every thread has left.
    if (kt + kIeeeStages - 1 < KT)
      load_stage(kt + kIeeeStages - 1, (kt + kIeeeStages - 1) % kIeeeStages);
    cp_async_commit();
    const float* At = As + (kt % kIeeeStages) * kAStage;
    const float* Bt = Bs + (kt % kIeeeStages) * kBStage;
#pragma unroll
    for (int k4 = 0; k4 < kIeeeBK / 4; ++k4) {
      float av[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            At + (ty + TY * i) * kIeeeLda + k4 * 4);
        av[i][0] = v.x, av[i][1] = v.y, av[i][2] = v.z, av[i][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* brow = Bt + (k4 * 4 + kk) * BN;
        const float4 b0 = *reinterpret_cast<const float4*>(brow + tx * 4);
        const float4 b1 =
            *reinterpret_cast<const float4*>(brow + BN / 2 + tx * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float x = av[i][kk];
          acc[i][0] = fmaf(x, b0.x, acc[i][0]);
          acc[i][1] = fmaf(x, b0.y, acc[i][1]);
          acc[i][2] = fmaf(x, b0.z, acc[i][2]);
          acc[i][3] = fmaf(x, b0.w, acc[i][3]);
          acc[i][4] = fmaf(x, b1.x, acc[i][4]);
          acc[i][5] = fmaf(x, b1.y, acc[i][5]);
          acc[i][6] = fmaf(x, b1.z, acc[i][6]);
          acc[i][7] = fmaf(x, b1.w, acc[i][7]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + ty + TY * i;
    if (row >= n) continue;
    float* crow = c + (size_t)row * m + col0;
    if (col0 + tx * 4 < m)
      *reinterpret_cast<float4*>(crow + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (col0 + BN / 2 + tx * 4 < m)
      *reinterpret_cast<float4*>(crow + BN / 2 + tx * 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

template <int BM, int BN>
cudaError_t launch_ieee(const float* a, const float* b, float* c, int n,
                        int k, int m, cudaStream_t s) {
  constexpr int smem = ieee_smem_bytes(BM, BN);
  cudaError_t e = cudaFuncSetAttribute(
      mm_ieee_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM);
  mm_ieee_kernel<BM, BN><<<grid, (BM / 8) * (BN / 8), smem, s>>>(a, b, c, n,
                                                                 k, m);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tf32 / bf16: the rounding pre-pass and the wgmma kernel.

// Padding of the scratch copies (mirrored by ops/precision_probe.py):
// rows of A and of B^T to 128, k to 64 elements.
constexpr int kRowPad = 128;
constexpr int kKPad = 64;

template <bool kBf16>
struct Rounded {
  using type = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  static __device__ __forceinline__ type from(float x) {
    if constexpr (kBf16) {
      return __float2bfloat16_rn(x);
    } else {
      uint32_t u;
      asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
      return __uint_as_float(u);
    }
  }
};

// Blocks [0, tiles_a): 32 x 32 tiles of ar [npad, kpad] = round(a), zero
// outside [n, k].  The rest: 32 x 32 tiles of bt [mpad, kpad] = round(b)^T,
// through a shared-memory transpose so both sides stay coalesced.
template <bool kBf16>
__global__ void round_pack_kernel(const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  typename Rounded<kBf16>::type* ar,
                                  typename Rounded<kBf16>::type* bt, int n,
                                  int k, int m, int kpad, int tiles_a) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;  // (32, 8)
  const int tiles_k = kpad / 32;
  int bid = blockIdx.x;
  if (bid < tiles_a) {
    const int tr = bid / tiles_k, tc = bid - tr * tiles_k;
    const int col = tc * 32 + tx;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = tr * 32 + ty + 8 * i;
      const float v = (row < n && col < k) ? a[(size_t)row * k + col] : 0.0f;
      ar[(size_t)row * kpad + col] = Rounded<kBf16>::from(v);
    }
    return;
  }
  bid -= tiles_a;
  const int tj = bid / tiles_k, tk = bid - tj * tiles_k;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = tk * 32 + ty + 8 * i, j = tj * 32 + tx;
    tile[ty + 8 * i][tx] = (kk < k && j < m) ? b[(size_t)kk * m + j] : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = tj * 32 + ty + 8 * i, kk = tk * 32 + tx;
    bt[(size_t)j * kpad + kk] = Rounded<kBf16>::from(tile[tx][ty + 8 * i]);
  }
}

constexpr int kMmaBN = 128;        // columns of C per CTA
constexpr int kMmaRowBytes = 128;  // bytes of k per operand row and stage
constexpr int kMmaStages = 4;
constexpr int kMmaAhead = kMmaStages - 2;  // tiles in flight beyond kt

constexpr int mma_smem_bytes(int wgs) {
  // + 1024: the ring is aligned to the swizzle atom by hand.
  return kMmaStages * (wgs * 64 + kMmaBN) * kMmaRowBytes + 1024;
}

// Shared-memory matrix descriptor of a K-major, 128-byte-swizzled tile:
// start address, leading offset 1 (unused under a swizzle), 1024 bytes
// between 8-row groups, layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t mma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#define EFA_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define EFA_ACC16(i) \
  EFA_ACC4(i), EFA_ACC4(i + 4), EFA_ACC4(i + 8), EFA_ACC4(i + 12)
#define EFA_ACC64 EFA_ACC16(0), EFA_ACC16(16), EFA_ACC16(32), EFA_ACC16(48)
#define EFA_D64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

// d[64] += A[64, kstep] B[128, kstep]^T, both operands from shared memory
// (scale-d is a predicate: true accumulates).
template <bool kBf16>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  if constexpr (kBf16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " EFA_D64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : EFA_ACC64
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " EFA_D64
        ", %64, %65, p, 1, 1;\n}\n"
        : EFA_ACC64
        : "l"(da), "l"(db), "r"(1));
  }
}

template <bool kBf16, int kWG>
__global__ void __launch_bounds__(kWG * 128)
    mm_wgmma_kernel(const typename Rounded<kBf16>::type* __restrict__ ar,
                    const typename Rounded<kBf16>::type* __restrict__ bt,
                    float* __restrict__ c, int n, int m, int kpad) {
  using In = typename Rounded<kBf16>::type;
  constexpr int BM = kWG * 64, NT = kWG * 128;
  constexpr int BK = kMmaRowBytes / (int)sizeof(In);  // 32 tf32 / 64 bf16
  constexpr int kABytes = BM * kMmaRowBytes, kBBytes = kMmaBN * kMmaRowBytes;
  constexpr int kStageBytes = kABytes + kBBytes;
  constexpr int kStepBytes = 32;  // one wgmma's k: 8 tf32 or 16 bf16
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * kMmaBN;
  const int KT = kpad / BK;
  const unsigned char* abase =
      reinterpret_cast<const unsigned char*>(ar + (size_t)row0 * kpad);
  const unsigned char* bbase =
      reinterpret_cast<const unsigned char*>(bt + (size_t)col0 * kpad);
  const size_t ld_bytes = (size_t)kpad * sizeof(In);

  auto load_stage = [&](int kt, int s) {
    const uint32_t sa = ring + s * kStageBytes, sb = sa + kABytes;
    const size_t koff = (size_t)kt * kMmaRowBytes;
    for (int idx = tid; idx < BM * 8; idx += NT) {
      const int r = idx >> 3, ch = idx & 7;
      cp_async16(sa + r * kMmaRowBytes + ((ch ^ (r & 7)) << 4),
                 abase + r * ld_bytes + koff + ch * 16, true);
    }
    for (int idx = tid; idx < kMmaBN * 8; idx += NT) {
      const int r = idx >> 3, ch = idx & 7;
      cp_async16(sb + r * kMmaRowBytes + ((ch ^ (r & 7)) << 4),
                 bbase + r * ld_bytes + koff + ch * 16, true);
    }
  };

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;

  for (int s = 0; s < kMmaAhead; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kMmaAhead - 1>();  // this thread's copies of tile kt
    // Make the copies visible to the tensor cores' reads, then meet: every
    // thread's share of tile kt has landed, and every warpgroup has retired
    // its wgmmas of tile kt - 2 (wait_group 1 below), whose stage is the one
    // refilled next.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (kt + kMmaAhead < KT)
      load_stage(kt + kMmaAhead, (kt + kMmaAhead) % kMmaStages);
    cp_async_commit();
    const uint32_t sa = ring + (kt % kMmaStages) * kStageBytes;
    const uint64_t da = mma_desc(sa + wg * 64 * kMmaRowBytes);
    const uint64_t db = mma_desc(sa + kABytes);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < kMmaRowBytes / kStepBytes; ++j)
      wgmma_m64n128<kBf16>(d, da + (uint64_t)(j * kStepBytes >> 4),
                           db + (uint64_t)(j * kStepBytes >> 4));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  cp_async_wait<0>();

  // Accumulator layout of m64nN: warp w of the warpgroup holds rows 16 w +
  // lane / 4 (and + 8); d[4 j .. 4 j + 3] are columns 8 j + 2 (lane % 4),
  // + 1 of those two rows.
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int row = row0 + wg * 64 + warp * 16 + (lane >> 2);
  const int colq = col0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < kMmaBN / 8; ++j) {
    const int col = colq + 8 * j;
    if (col >= m) continue;
    if (row < n)
      *reinterpret_cast<float2*>(c + (size_t)row * m + col) =
          make_float2(d[4 * j], d[4 * j + 1]);
    if (row + 8 < n)
      *reinterpret_cast<float2*>(c + (size_t)(row + 8) * m + col) =
          make_float2(d[4 * j + 2], d[4 * j + 3]);
  }
}

template <bool kBf16, int kWG>
cudaError_t launch_wgmma(const void* ar, const void* bt, float* c, int n,
                         int m, int kpad, cudaStream_t s) {
  using In = typename Rounded<kBf16>::type;
  constexpr int smem = mma_smem_bytes(kWG);
  cudaError_t e = cudaFuncSetAttribute(
      mm_wgmma_kernel<kBf16, kWG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + kWG * 64 - 1) / (kWG * 64), (m + kMmaBN - 1) / kMmaBN);
  mm_wgmma_kernel<kBf16, kWG><<<grid, kWG * 128, smem, s>>>(
      static_cast<const In*>(ar), static_cast<const In*>(bt), c, n, m, kpad);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t run_tensor(const float* a, const float* b, float* c, void* ar,
                       void* bt, int n, int k, int m, cudaStream_t s) {
  using In = typename Rounded<kBf16>::type;
  const int npad = (n + kRowPad - 1) / kRowPad * kRowPad;
  const int mpad = (m + kRowPad - 1) / kRowPad * kRowPad;
  const int kpad = (k + kKPad - 1) / kKPad * kKPad;
  const int tiles_a = (npad / 32) * (kpad / 32);
  const int tiles_b = (mpad / 32) * (kpad / 32);
  round_pack_kernel<kBf16><<<tiles_a + tiles_b, dim3(32, 8), 0, s>>>(
      a, b, static_cast<In*>(ar), static_cast<In*>(bt), n, k, m, kpad,
      tiles_a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // Two warpgroups (128 x 128 tiles) once those fill the card, else one.
  const bool two = (npad / 128) * (mpad / 128) >= kNumSMs;
  return two ? launch_wgmma<kBf16, 2>(ar, bt, c, n, m, kpad, s)
             : launch_wgmma<kBf16, 1>(ar, bt, c, n, m, kpad, s);
}

}  // namespace

extern "C" {

// mode: 0 ieee, 1 tf32, 2 bf16.  ar and bt are scratch for the tensor-core
// modes: ceil(n, 128) x ceil(k, 64) and ceil(m, 128) x ceil(k, 64) elements
// of 4 bytes (tf32) or 2 (bf16); unused in mode 0.  Returns a cudaError_t.
int efa_precision_mm(const float* a, const float* b, float* c, void* ar,
                     void* bt, int n, int k, int m, int mode,
                     void* stream) {
  if (n <= 0 || k <= 0 || m <= 0 || n % kSizeMultiple || k % kSizeMultiple ||
      m % kSizeMultiple || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 1)
    return (int)run_tensor<false>(a, b, c, ar, bt, n, k, m, s);
  if (mode == 2)
    return (int)run_tensor<true>(a, b, c, ar, bt, n, k, m, s);
  // Measured: 128 x 128 tiles win once they fill the card (4096^3); below
  // that 128 x 64 (1024^3: 128 tiles) beat them and beat 64 x 64 too.
  if (((n + 127) / 128) * ((m + 127) / 128) >= kNumSMs)
    return (int)launch_ieee<128, 128>(a, b, c, n, k, m, s);
  return (int)launch_ieee<128, 64>(a, b, c, n, k, m, s);
}

}  // extern "C"
