// NS: the LETKF's batched coupled Newton-Schulz inverse square root, with
// its exit test on the device.
//
// Replaces no Pallas kernel: the JAX package runs this loop as a
// jax.lax.while_loop (efa_xray_tpu/assimilation/letkf_core.py,
// _invsqrt_newton_schulz), whose exit test never leaves the TPU.  In eager
// torch the same loop read each iteration's error back to the host, so a
// mesh shard waited on its card once per iteration and the shards took
// turns.  This kernel keeps the test on the card.
//
// What it computes, for a batch of C matrices Y, Z [M, M] (Y = A / c, Z = I
// on entry), iteration i = 0 .. iters - 1, exactly as the plain loop:
//   run_i = run_{i-1} and err_i > tol and not (err_i < quad and
//           err_i > 0.5 err_{i-1})          (err_0 = err_{-1} = inf)
//   if run_i:  P = Z Y;  err_{i+1} = max over the batch |P - I|;
//              T = 1.5 I - 0.5 P;  Y <- Y T;  Z <- T Z
// The test reads err from device scalars: one launch per iteration, each
// returning at once once the loop has exited.  err_{i+1} is folded in by
// an atomicMax on the bits of the non-negative float (a NaN taken as +NaN,
// which orders above every float, as torch.amax propagates it), and
// run[i + 1] records that iteration i ran: the wrapper sums run for the
// iteration count, on the device.
//
// What bounds it on an H100: a batch of C = 512 systems of M = 40 is 3 x
// 64,000 FMAs a system per iteration, 98M FMAs; plain fp32 (the LETKF's
// solve is fp32 in every setting), so FMA throughput and shared-memory
// loads, a few tens of microseconds per iteration.  Launch latency of the
// iterations past the exit (a few microseconds each) is the rest.
//
// What the design does about it: one CTA of 256 threads per system.  A
// start kernel pads the matrices to Mp = round4(M) with zeros (the identity
// only on the first M), so every product runs on 4 x 4 register tiles with
// 16-byte loads of B's rows; an end kernel writes Z / sqrt(c) and counts
// the iterations.  The one C call launches all of them, so the host issues
// a chunk's solve in a handful of operations.  Up to Mp = 136 the CTA holds
// Y, Z and T in shared memory (rows Mp + 4 floats apart: two row groups in a
// warp fall in different banks).  Y <- Y T is done in place by passes of
// whole row groups (a row of Y T needs only that row of Y), Z <- T Z by
// passes of whole column groups.  Beyond, up to the 256 members B1 takes,
// Y, Z and T stay in device memory and one CTA per system would leave most
// SMs idle at a chunk of a few dozen systems: each iteration is then two
// launches over 64 x 64 output tiles of every system, staged through
// shared memory in K slices of 16 (4 x 4 outputs a thread): the first
// forms T = 1.5 I - 0.5 Z Y and the error, the second Y T and T Z into the
// other buffer of a pair (iteration i reads buffer i mod 2), so the end
// kernel reads Z from the buffer of the iteration count's parity.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 232448;
constexpr int kMaxMembers = 256;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Shared memory of the in-shared-memory variant: Y, Z, T at a row stride
// of Mp + 4 floats.
__host__ __device__ inline int smem_bytes(int Mp) {
  return 3 * Mp * (Mp + 4) * (int)sizeof(float);
}

// acc = A[4 rg .. 4 rg + 3, :] B[:, 4 cg .. 4 cg + 3] over k < Mp.
__device__ __forceinline__ void tile(const float* A, const float* B, int S,
                                     int Mp, int rg, int cg,
                                     float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const float* a = A + 4 * rg * S;
  const float* b = B + 4 * cg;
  for (int k = 0; k < Mp; ++k) {
    const float4 bv = *reinterpret_cast<const float4*>(b + k * S);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float av = a[i * S + k];
      acc[i][0] = fmaf(av, bv.x, acc[i][0]);
      acc[i][1] = fmaf(av, bv.y, acc[i][1]);
      acc[i][2] = fmaf(av, bv.z, acc[i][2]);
      acc[i][3] = fmaf(av, bv.w, acc[i][3]);
    }
  }
}

__device__ __forceinline__ void store(float* C, int S, int rg, int cg,
                                      const float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(C + (4 * rg + i) * S + 4 * cg) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// The exit test of iteration `it`, the same in every CTA: iteration it-1
// ran, and its error err[it + 1] (err[it] the one before) calls for more.
__device__ __forceinline__ bool runs(const float* err, const int* run,
                                     int it, float tol, float quad) {
  if (!run[it]) return false;
  const float e = err[it + 1], prev = err[it];
  return e > tol && !(e < quad && e > 0.5f * prev);
}

// The CTA's max error (NaN where any thread saw one), then one atomic into
// iteration `it`'s slot err[it + 2]; run[it + 1] records that `it` ran.
__device__ __forceinline__ void fold_error(float emax, bool nan, float* err,
                                           int* run, int it) {
  __shared__ float wmax[kThreads / 32];
  __shared__ int wnan[kThreads / 32];
  const int tid = threadIdx.x;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    emax = fmaxf(emax, __shfl_xor_sync(0xffffffffu, emax, o));
    nan = __any_sync(0xffffffffu, nan);
  }
  if ((tid & 31) == 0) {
    wmax[tid >> 5] = emax;
    wnan[tid >> 5] = nan;
  }
  __syncthreads();
  if (tid == 0) {
    float m = 0.f;
    int n = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      m = fmaxf(m, wmax[w]);
      n |= wnan[w];
    }
    const int bits = n ? 0x7fc00000 : __float_as_int(m);
    atomicMax(reinterpret_cast<int*>(err + it + 2), bits);
    run[it + 1] = 1;
  }
}

__global__ void __launch_bounds__(kThreads) ns_step_kernel(
    float* yw,          // [C, Mp, Mp] Y, updated in place
    float* zw,          // [C, Mp, Mp] Z, updated in place
    float* err,         // [iters + 2]: inf, inf, then 0 (atomicMax slots)
    int* run,           // [iters + 1]: 1, then 0
    int M, int Mp, int it, float tol, float quad) {
  if (!runs(err, run, it, tol, quad)) return;

  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const long off = (long)blockIdx.x * Mp * Mp;
  const int S = Mp + 4;
  float* Y = smem;
  float* Z = smem + Mp * S;
  float* T = smem + 2 * Mp * S;
  const int Q = Mp >> 2;  // row (and column) groups of 4
  for (int idx = tid; idx < Mp * Q; idx += kThreads) {
    const int r = idx / Q, c = 4 * (idx - r * Q);
    *reinterpret_cast<float4*>(Y + r * S + c) =
        *reinterpret_cast<const float4*>(yw + off + r * Mp + c);
    *reinterpret_cast<float4*>(Z + r * S + c) =
        *reinterpret_cast<const float4*>(zw + off + r * Mp + c);
  }
  __syncthreads();

  // P = Z Y, its distance from I, and T = 1.5 I - 0.5 P.
  float emax = 0.f;
  bool nan = false;
  for (int task = tid; task < Q * Q; task += kThreads) {
    const int rg = task / Q, cg = task - rg * Q;
    float acc[4][4];
    tile(Z, Y, S, Mp, rg, cg, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * rg + i, c = 4 * cg + j;
        const bool diag = r == c && r < M;
        const float d = fabsf(acc[i][j] - (diag ? 1.f : 0.f));
        nan = nan || d != d;
        emax = fmaxf(emax, d);
        acc[i][j] = (diag ? 1.5f : 0.f) - 0.5f * acc[i][j];
      }
    store(T, S, rg, cg, acc);
  }
  fold_error(emax, nan, err, run, it);

  // Y <- Y T in place, by passes of whole row groups.
  const int rpp = max(1, kThreads / Q);
  for (int rg0 = 0; rg0 < Q; rg0 += rpp) {
    const int rg = rg0 + tid / Q, cg = tid - (tid / Q) * Q;
    const bool on = tid < rpp * Q && rg < Q;
    float acc[4][4];
    if (on) tile(Y, T, S, Mp, rg, cg, acc);
    __syncthreads();
    if (on) store(Y, S, rg, cg, acc);
  }
  __syncthreads();
  // Z <- T Z in place, by passes of whole column groups.
  for (int cg0 = 0; cg0 < Q; cg0 += rpp) {
    const int cg = cg0 + tid / Q, rg = tid - (tid / Q) * Q;
    const bool on = tid < rpp * Q && cg < Q;
    float acc[4][4];
    if (on) tile(T, Z, S, Mp, rg, cg, acc);
    __syncthreads();
    if (on) store(Z, S, rg, cg, acc);
  }
  __syncthreads();
  for (int idx = tid; idx < Mp * Q; idx += kThreads) {
    const int r = idx / Q, c = 4 * (idx - r * Q);
    *reinterpret_cast<float4*>(yw + off + r * Mp + c) =
        *reinterpret_cast<const float4*>(Y + r * S + c);
    *reinterpret_cast<float4*>(zw + off + r * Mp + c) =
        *reinterpret_cast<const float4*>(Z + r * S + c);
  }
}

// The device-memory variant's tile: acc = A[r0 .., :] B[:, c0 ..] for
// rows r0 + 4 ty + i and columns c0 + 4 tx + j (ty, tx < 16), through
// shared memory in K slices of kKc (A's slice transposed); outside [Mp,
// Mp] the operands read as zeros.
constexpr int kTile = 64, kKc = 16, kLd = kTile + 4;

__device__ __forceinline__ void tile64(const float* A, const float* B,
                                       int Mp, int r0, int c0,
                                       float acc[4][4]) {
  __shared__ __align__(16) float As[kKc][kLd];
  __shared__ __align__(16) float Bs[kKc][kLd];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < Mp; k0 += kKc) {
    for (int idx = tid; idx < kTile * kKc; idx += kThreads) {
      const int r = idx / kKc, k = idx - r * kKc;
      const int gr = r0 + r, gk = k0 + k;
      As[k][r] = gr < Mp && gk < Mp ? A[(long)gr * Mp + gk] : 0.f;
    }
    for (int idx = tid; idx < kKc * kTile; idx += kThreads) {
      const int k = idx / kTile, c = idx - k * kTile;
      const int gk = k0 + k, gc = c0 + c;
      Bs[k][c] = gk < Mp && gc < Mp ? B[(long)gk * Mp + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kKc; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(av[i], b.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], b.y, acc[i][1]);
        acc[i][2] = fmaf(av[i], b.z, acc[i][2]);
        acc[i][3] = fmaf(av[i], b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void store64(float* C, int Mp, int r0, int c0,
                                        const float acc[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + 4 * ty + i, c = c0 + 4 * tx + j;
      if (r < Mp && c < Mp) C[(long)r * Mp + c] = acc[i][j];
    }
}

// Device-memory variant, iteration `it`, first launch: for the tile
// (blockIdx.x) of system blockIdx.y, P = Z Y, its distance from I folded
// into err[it + 2], and T = 1.5 I - 0.5 P.  Y, Z are buffer it % 2 of the
// pairs (y0, y1) and (z0, z1).
__global__ void __launch_bounds__(kThreads) ns_gram_kernel(
    const float* y0, const float* z0, const float* y1, const float* z1,
    float* tw, float* err, int* run, int M, int Mp, int it, float tol,
    float quad) {
  if (!runs(err, run, it, tol, quad)) return;
  const int tiles = (Mp + kTile - 1) / kTile;
  const int r0 = kTile * (blockIdx.x / tiles);
  const int c0 = kTile * (blockIdx.x - (blockIdx.x / tiles) * tiles);
  const long off = (long)blockIdx.y * Mp * Mp;
  const float* Y = ((it & 1) ? y1 : y0) + off;
  const float* Z = ((it & 1) ? z1 : z0) + off;
  float acc[4][4];
  tile64(Z, Y, Mp, r0, c0, acc);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float emax = 0.f;
  bool nan = false;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + 4 * ty + i, c = c0 + 4 * tx + j;
      const bool diag = r == c && r < M;
      const float d = fabsf(acc[i][j] - (diag ? 1.f : 0.f));
      if (r < Mp && c < Mp) {
        nan = nan || d != d;
        emax = fmaxf(emax, d);
      }
      acc[i][j] = (diag ? 1.5f : 0.f) - 0.5f * acc[i][j];
    }
  store64(tw + off, Mp, r0, c0, acc);
  fold_error(emax, nan, err, run, it);
}

// Device-memory variant, iteration `it`, second launch: for the tile
// (blockIdx.x) of system blockIdx.y, Y T (blockIdx.z 0) or T Z (1) from
// buffer it % 2 into the other.
__global__ void __launch_bounds__(kThreads) ns_apply_kernel(
    float* y0, float* z0, float* y1, float* z1, const float* tw,
    const float* err, const int* run, int Mp, int it, float tol,
    float quad) {
  if (!runs(err, run, it, tol, quad)) return;
  const int tiles = (Mp + kTile - 1) / kTile;
  const int r0 = kTile * (blockIdx.x / tiles);
  const int c0 = kTile * (blockIdx.x - (blockIdx.x / tiles) * tiles);
  const long off = (long)blockIdx.y * Mp * Mp;
  const bool odd = it & 1;
  const float* T = tw + off;
  float acc[4][4];
  if (blockIdx.z == 0) {
    tile64((odd ? y1 : y0) + off, T, Mp, r0, c0, acc);
    store64((odd ? y0 : y1) + off, Mp, r0, c0, acc);
  } else {
    tile64(T, (odd ? z1 : z0) + off, Mp, r0, c0, acc);
    store64((odd ? z0 : z1) + off, Mp, r0, c0, acc);
  }
}

// The loop's start: Y = A / c (scaled by the wrapper) and Z = I, each
// padded with zeros to [Mp, Mp]; CTA 0 also sets the exit test's scalars
// (err: inf, inf, then 0 for the atomic maxima; run: 1, then 0).
__global__ void __launch_bounds__(kThreads) ns_init_kernel(
    const float* y0, float* yw, float* zw, float* err, int* run, int M,
    int Mp, int iters) {
  const long b = blockIdx.x;
  for (int idx = threadIdx.x; idx < Mp * Mp; idx += kThreads) {
    const int r = idx / Mp, c = idx - r * Mp;
    const bool in = r < M && c < M;
    yw[b * Mp * Mp + idx] = in ? y0[b * M * M + r * M + c] : 0.f;
    zw[b * Mp * Mp + idx] = in && r == c ? 1.f : 0.f;
  }
  if (b == 0) {
    for (int i = threadIdx.x; i < iters + 2; i += kThreads)
      err[i] = i < 2 ? __int_as_float(0x7f800000) : 0.f;
    for (int i = threadIdx.x; i < iters + 1; i += kThreads)
      run[i] = i == 0;
  }
}

// The loop's end: A^{-1/2} = Z / sqrt(c), unpadded, Z read from zw or,
// in the device-memory variant after an odd count, z1; the iterations run
// into count[0] (CTA 0), and added to tally = [summed, most] when given.
__global__ void __launch_bounds__(kThreads) ns_finish_kernel(
    const float* zw, const float* z1, const float* c, float* out,
    const int* run, long long* count, long long* tally, int M, int Mp,
    int iters) {
  const long b = blockIdx.x;
  __shared__ int n;
  if (threadIdx.x == 0) {
    n = 0;
    for (int i = 1; i <= iters; ++i) n += run[i];
  }
  __syncthreads();
  const float* Z = (z1 && (n & 1)) ? z1 : zw;
  const float s = sqrtf(c[b]);
  for (int idx = threadIdx.x; idx < M * M; idx += kThreads) {
    const int r = idx / M, col = idx - r * M;
    out[b * M * M + idx] = Z[b * Mp * Mp + r * Mp + col] / s;
  }
  if (b == 0 && threadIdx.x == 0) {
    count[0] = n;
    if (tally) {
      atomicAdd(reinterpret_cast<unsigned long long*>(tally),
                static_cast<unsigned long long>(n));
      atomicMax(tally + 1, (long long)n);
    }
  }
}

}  // namespace

extern "C" {

// Whether a system of M members runs in shared memory (1) or in device
// memory with the T scratch (0); -1 for an M the kernel does not take.
int efa_ns_in_smem(int M) {
  if (M < 1 || M > kMaxMembers) return -1;
  return smem_bytes(round4(M)) <= kMaxSmemBytes ? 1 : 0;
}

// The whole solve of C systems: the start, `iters` launches (one per
// iteration; two in the device-memory variant), the end.  y0 = A / c [C,
// M, M] and c [C] from the wrapper; out = A^{-1/2} [C, M, M]; the work
// arrays yw, zw [C, Mp, Mp] (Mp = round4(M)), and tw [3, C, Mp, Mp] (T,
// then the second Y and Z buffers) or nullptr where efa_ns_in_smem(M) is
// 1; err [iters + 2], run [iters + 1]; count [1] the iterations run, tally
// [2] (summed, most) added to when not nullptr.  Returns a cudaError_t.
int efa_newton_schulz(const float* y0, const float* c, float* out, float* yw,
                      float* zw, float* tw, float* err, int* run,
                      long long* count, long long* tally, int C, int M,
                      int iters, float tol, float quad, void* stream) {
  const int in_smem = efa_ns_in_smem(M);
  if (in_smem < 0 || C <= 0 || iters < 0 || (!in_smem && !tw))
    return (int)cudaErrorInvalidValue;
  const int Mp = round4(M);
  const long per = (long)C * Mp * Mp;
  float* y1 = in_smem ? nullptr : tw + per;
  float* z1 = in_smem ? nullptr : tw + 2 * per;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_smem) {
    cudaError_t e = cudaFuncSetAttribute(
        ns_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes(Mp));
    if (e != cudaSuccess) return (int)e;
  }
  ns_init_kernel<<<C, kThreads, 0, s>>>(y0, yw, zw, err, run, M, Mp, iters);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int tiles = (Mp + kTile - 1) / kTile;
  for (int it = 0; it < iters; ++it) {
    if (in_smem) {
      ns_step_kernel<<<C, kThreads, smem_bytes(Mp), s>>>(yw, zw, err, run, M,
                                                         Mp, it, tol, quad);
    } else {
      ns_gram_kernel<<<dim3(tiles * tiles, C), kThreads, 0, s>>>(
          yw, zw, y1, z1, tw, err, run, M, Mp, it, tol, quad);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      ns_apply_kernel<<<dim3(tiles * tiles, C, 2), kThreads, 0, s>>>(
          yw, zw, y1, z1, tw, err, run, Mp, it, tol, quad);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  ns_finish_kernel<<<C, kThreads, 0, s>>>(zw, z1, c, out, run, count, tally,
                                          M, Mp, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
