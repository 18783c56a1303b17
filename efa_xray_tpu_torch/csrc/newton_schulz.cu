// NS: the LETKF's batched coupled Newton-Schulz inverse square root, with
// its exit test on the device, in one persistent launch a solve.
//
// Replaces no Pallas kernel: the JAX package runs this loop as a
// jax.lax.while_loop (efa_xray_tpu/assimilation/letkf_core.py,
// _invsqrt_newton_schulz), whose exit test never leaves the TPU, and the
// products after it (inv = S S, wbar = inv b, W = sqrt(M - 1) S) as plain
// XLA in solve_patch_weights / _analyze_body_chunked.  This end forms wbar
// as S (S b), not as (S S) b: the same value in another order of rounding
// (the f32 gate holds it against inv b), and two products with a vector
// instead of one M^3 product.
//
// What it computes, for a batch of C SPD matrices A [M, M] (and, when b is
// given, right-hand sides b [C, M]), exactly as the plain loop:
//   c = max_r sum_j |A_rj| (at least 1e-30);  Y = A / c;  Z = I
//   i = 0, err = prev = inf
//   while i < iters and err > tol and not (err < quad and err > 0.5 prev):
//     P = Z Y;  e = max over the batch |P - I|;  T = 1.5 I - 0.5 P
//     Y <- Y T;  Z <- T Z;  i += 1;  prev, err = err, e
//   S = Z / sqrt(c) (A^{-1/2});  out = scale S;  wbar = S (S b)
// and the iteration count i, added to a tally [summed, most] when given.
//
// What bounds it on an H100: plain fp32 (the LETKF's solve is fp32 in
// every setting).  Config 7's chunk, [512, 80, 80] at 11 iterations, is
// 3 x 2 x 80^3 flops a system an iteration, 17.3 GFLOP in all: 0.26 ms at
// 67 TFLOP/s.  The previous design (one launch an iteration up to the cap,
// Y and Z through device memory between launches, 4 x 4 output tiles with
// four scalar shared loads per 16 FMAs and an idle second round at M = 80)
// took 1.88 ms.
//
// What the design does about it:
// * One cooperative launch a solve.  Each CTA owns systems blockIdx.x,
//   blockIdx.x + gridDim.x, ...; the batch-wide error of an iteration is
//   folded by one atomicMax a CTA into a device slot, then a grid-wide
//   barrier, after which every CTA reads the same slot and takes the same
//   exit decision: no iteration past the exit is launched, nothing is read
//   by the host.  The grid is the CTAs that fit on the card at once.
// * Shared-memory variant (round4(M) <= 136): a CTA holds one system's Y, Z
//   and T in shared memory.  Where a CTA owns several systems (config 7:
//   512 systems, 264 CTAs of 80 members fit), the others wait in device
//   memory (L2-resident: 26 MB at config 7); their order alternates every
//   iteration, so the system the CTA ends an iteration with starts the next
//   one in place: one load and one store a swap.
// * RT x 4 output tiles a thread (RT = 5 where M is a multiple of 20 and
//   the CTA stays within 640 threads, else 4, or 8 up to 136), the CTA
//   sized to the tiles: M = 80 is 16 x 20 tiles on 320 threads, M = 40 8 x
//   10 on 96, with no idle round.  The k loop steps by 4: RT float4 loads
//   of A's rows and 4 of B's rows per 16 RT FMAs.  Each output is still one
//   FMA chain in ascending k (the chain of the plain loop's products).
//   Tiles 8 columns wide (half of B's loads per FMA, half the warps) were
//   measured slower at M = 80 and 136.
// * Device-memory variant (136 < round4(M), any ensemble): Y and Z in
//   pairs of buffers, T in a third (5 C M^2 floats: 2.7 GB at 512 systems
//   of 512 members), every system's 64 x 64 output tiles dealt over the
//   grid of the CTAs that fit the card at once (4 an SM: no shared memory
//   grows with M); two grid barriers an iteration (T and the error, then
//   Y T and T Z into the other buffer of each pair).
// * The end writes what the LETKF's solve uses: scale S (W = sqrt(M - 1)
//   A^{-1/2}, or A^{-1/2} itself) and wbar = S (S b) = A^{-1} b, so the
//   host issues a chunk's solve in one C call.
//
// Every barrier waits at most kSpinNs on the device clock and then traps,
// so a fault can never hang the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

constexpr int kMaxSmemBytes = 232448;
constexpr int kWideThreads = 256;
constexpr long long kSpinNs = 5000000000LL;

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// The shared-memory variant's plan for M members: the rows of a thread's
// tile, the padded width, the CTA's threads and shared memory.
struct Plan {
  int rt, mq, threads, smem;
};

__host__ __device__ inline Plan make_plan(int M) {
  const int m4 = round_up(M, 4);
  Plan p;
  if (round_up(M, 20) == m4 && (m4 / 5) * (m4 / 4) <= 640) {
    p.rt = 5;
    p.mq = m4;
  } else if ((m4 / 4) * (m4 / 4) <= 1024) {
    p.rt = 4;
    p.mq = m4;
  } else {
    p.rt = 8;
    p.mq = round_up(M, 8);
  }
  p.threads = round_up((p.mq / p.rt) * (p.mq / 4), 32);
  p.smem = 3 * p.mq * (p.mq + 4) * (int)sizeof(float);
  return p;
}

// Static shared memory beside the plan's (block_max's tables), with room.
constexpr int kStaticReserve = 1024;

__host__ __device__ inline bool in_smem(int M) {
  return make_plan(M).smem + kStaticReserve <= kMaxSmemBytes;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Grid-wide barrier of a cooperative launch: bar[0] counts arrivals,
// bar[1] is the generation (both 0 before the launch).
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      const unsigned long long t0 = now_ns();
      while (*gen == g) {
        __nanosleep(64);
        if (now_ns() - t0 > (unsigned long long)kSpinNs) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// The CTA's max of v (NaN where any thread saw one: `nan`), in every
// thread.
__device__ __forceinline__ float block_max(float v, bool nan) {
  __shared__ float wmax[32];
  __shared__ int wnan[32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    nan = __any_sync(0xffffffffu, nan);
  }
  __syncthreads();
  if (lane == 0) {
    wmax[w] = v;
    wnan[w] = nan;
  }
  __syncthreads();
  float m = 0.f;
  int n = 0;
  for (int i = 0; i < (int)((blockDim.x + 31) >> 5); ++i) {
    m = fmaxf(m, wmax[i]);
    n |= wnan[i];
  }
  return n ? __int_as_float(0x7fc00000) : m;
}

// c clamped to 1e-30 as torch.clamp does it: a NaN stays NaN.
__device__ __forceinline__ float clamp_scale(float c) {
  return c != c ? c : fmaxf(c, 1e-30f);
}

// The iteration's error slot: the bits of a non-negative float (NaN as
// +NaN, above every float) folded by atomicMax, read after the barrier.
__device__ __forceinline__ void fold(float* slot, float e) {
  atomicMax(reinterpret_cast<int*>(slot), __float_as_int(e));
}

__device__ __forceinline__ float read_slot(const float* slot) {
  return *reinterpret_cast<const volatile float*>(slot);
}

// Whether iteration `it` runs, from the previous two errors.
__device__ __forceinline__ bool runs(int it, int iters, float err,
                                     float prev, float tol, float quad) {
  return it < iters && err > tol && !(err < quad && err > 0.5f * prev);
}

// ---------------------------------------------------------------------------
// Shared-memory variant
// ---------------------------------------------------------------------------

// acc = A[RT rg .. RT rg + RT - 1, :] B[:, 4 cg .. 4 cg + 3] over k < Mq,
// row stride S; each output one FMA chain in ascending k.
template <int RT>
__device__ __forceinline__ void mm(const float* A, const float* B, int S,
                                   int Mq, int rg, int cg,
                                   float acc[RT][4]) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const float* a = A + RT * rg * S;
  const float* b = B + 4 * cg;
  for (int k = 0; k < Mq; k += 4) {
    float4 bv[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      bv[kk] = *reinterpret_cast<const float4*>(b + (k + kk) * S);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float4 av = *reinterpret_cast<const float4*>(a + i * S + k);
      const float as[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc[i][0] = fmaf(as[kk], bv[kk].x, acc[i][0]);
        acc[i][1] = fmaf(as[kk], bv[kk].y, acc[i][1]);
        acc[i][2] = fmaf(as[kk], bv[kk].z, acc[i][2]);
        acc[i][3] = fmaf(as[kk], bv[kk].w, acc[i][3]);
      }
    }
  }
}

template <int RT>
__device__ __forceinline__ void put(float* C, int S, int rg, int cg,
                                    const float acc[RT][4]) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
    *reinterpret_cast<float4*>(C + (RT * rg + i) * S + 4 * cg) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// Y, Z of system s between shared memory (stride S) and the work buffers
// (dense [Mq, Mq]).
__device__ __forceinline__ void stash(const float* Y, const float* Z,
                                      float* wy, float* wz, int S, int Mq) {
  const int Q = Mq >> 2;
  for (int idx = threadIdx.x; idx < Mq * Q; idx += blockDim.x) {
    const int r = idx / Q, c = 4 * (idx - r * Q);
    *reinterpret_cast<float4*>(wy + r * Mq + c) =
        *reinterpret_cast<const float4*>(Y + r * S + c);
    *reinterpret_cast<float4*>(wz + r * Mq + c) =
        *reinterpret_cast<const float4*>(Z + r * S + c);
  }
}

__device__ __forceinline__ void unstash(float* Y, float* Z, const float* wy,
                                        const float* wz, int S, int Mq) {
  const int Q = Mq >> 2;
  for (int idx = threadIdx.x; idx < Mq * Q; idx += blockDim.x) {
    const int r = idx / Q, c = 4 * (idx - r * Q);
    *reinterpret_cast<float4*>(Y + r * S + c) =
        *reinterpret_cast<const float4*>(wy + r * Mq + c);
    *reinterpret_cast<float4*>(Z + r * S + c) =
        *reinterpret_cast<const float4*>(wz + r * Mq + c);
  }
}

// The start of system s in shared memory: A padded with zeros into Y, c
// (into cbuf[s]), Y = A / c, Z = I on the first M rows.
__device__ __forceinline__ void start(const float* A, float* Y, float* Z,
                                      float* cbuf, int s, int M, int Mq,
                                      int S) {
  const float* a = A + (long)s * M * M;
  for (int idx = threadIdx.x; idx < Mq * Mq; idx += blockDim.x) {
    const int r = idx / Mq, c = idx - r * Mq;
    Y[r * S + c] = r < M && c < M ? a[r * M + c] : 0.f;
    Z[r * S + c] = r == c && r < M ? 1.f : 0.f;
  }
  __syncthreads();
  float rs = 0.f;
  bool nan = false;
  for (int r = threadIdx.x; r < M; r += blockDim.x) {
    float t = 0.f;
    for (int c = 0; c < M; ++c) t += fabsf(Y[r * S + c]);
    rs = fmaxf(rs, t);
    nan = nan || t != t;
  }
  const float c = clamp_scale(block_max(rs, nan));
  for (int idx = threadIdx.x; idx < Mq * Mq; idx += blockDim.x) {
    const int r = idx / Mq, col = idx - r * Mq;
    Y[r * S + col] = __fdiv_rn(Y[r * S + col], c);
  }
  if (threadIdx.x == 0) cbuf[s] = c;
  __syncthreads();
}

// One iteration on the system in shared memory; returns the thread's max
// |P - I| (and whether it saw a NaN, in `nan`).
template <int RT>
__device__ __forceinline__ float step(float* Y, float* Z, float* T, int M,
                                      int Mq, int S, bool& nan) {
  const int Q = Mq >> 2;
  const int task = threadIdx.x;
  const bool on = task < (Mq / RT) * Q;
  const int rg = task / Q, cg = task - (task / Q) * Q;
  float acc[RT][4];
  float emax = 0.f;
  if (on) {
    mm<RT>(Z, Y, S, Mq, rg, cg, acc);
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = RT * rg + i, c = 4 * cg + j;
        const bool diag = r == c && r < M;
        const float d = fabsf(acc[i][j] - (diag ? 1.f : 0.f));
        nan = nan || d != d;
        emax = fmaxf(emax, d);
        acc[i][j] = (diag ? 1.5f : 0.f) - 0.5f * acc[i][j];
      }
    put<RT>(T, S, rg, cg, acc);
  }
  __syncthreads();
  if (on) mm<RT>(Y, T, S, Mq, rg, cg, acc);
  __syncthreads();
  if (on) put<RT>(Y, S, rg, cg, acc);
  if (on) mm<RT>(T, Z, S, Mq, rg, cg, acc);
  __syncthreads();
  if (on) put<RT>(Z, S, rg, cg, acc);
  __syncthreads();
  return emax;
}

// The end for the system in shared memory (Z its result): S = Z / sqrt(c)
// in Z, out = scale S, and wbar = S (S b) where asked for (u = S b in T).
__device__ __forceinline__ void finish(float* Z, float* T, float c,
                                       const float* b, float* s_out,
                                       float* wbar_out, float scale, int s,
                                       int M, int Mq, int S) {
  const float sc = __fsqrt_rn(c);
  for (int idx = threadIdx.x; idx < Mq * Mq; idx += blockDim.x) {
    const int r = idx / Mq, col = idx - r * Mq;
    const float v = __fdiv_rn(Z[r * S + col], sc);
    Z[r * S + col] = v;
    if (r < M && col < M)
      s_out[(long)s * M * M + r * M + col] = scale == 1.f ? v : scale * v;
  }
  if (!wbar_out) return;
  __syncthreads();
  const float* bs = b + (long)s * M;
  for (int r = threadIdx.x; r < M; r += blockDim.x) {
    float w = 0.f;
    for (int k = 0; k < M; ++k) w = fmaf(Z[r * S + k], bs[k], w);
    T[r] = w;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < M; r += blockDim.x) {
    float w = 0.f;
    for (int k = 0; k < M; ++k) w = fmaf(Z[r * S + k], T[k], w);
    wbar_out[(long)s * M + r] = w;
  }
  __syncthreads();
}

template <int RT>
__global__ void __launch_bounds__(RT == 4 ? 1024 : 640) ns_smem_kernel(
    const float* a, const float* b, float* s_out, float* wbar_out,
    float* work, float* cbuf, unsigned* bar, float* err,
    long long* count, long long* tally, int C, int M, int Mq, int iters,
    float tol, float quad, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int S = Mq + 4;
  float* Y = smem;
  float* Z = smem + Mq * S;
  float* T = smem + 2 * Mq * S;
  const long per = (long)Mq * Mq;
  float* wy = work;
  float* wz = work + (long)C * per;
  const int first = blockIdx.x, stride = gridDim.x;
  const int own = first < C ? (C - 1 - first) / stride + 1 : 0;
  // The j-th system of this CTA, and the one whose Y, Z are in shared
  // memory (-1: none yet).
  auto sys = [&](int j) { return first + j * stride; };
  int here = -1;
  auto visit = [&](int s) {
    if (s == here) return;
    if (here >= 0) stash(Y, Z, wy + here * per, wz + here * per, S, Mq);
    __syncthreads();
    unstash(Y, Z, wy + s * per, wz + s * per, S, Mq);
    __syncthreads();
    here = s;
  };
  for (int j = 0; j < own; ++j) {
    if (here >= 0) {
      stash(Y, Z, wy + here * per, wz + here * per, S, Mq);
      __syncthreads();
    }
    start(a, Y, Z, cbuf, sys(j), M, Mq, S);
    here = sys(j);
  }
  float e = __int_as_float(0x7f800000), prev = e;
  int it = 0;
  while (runs(it, iters, e, prev, tol, quad)) {
    // Backward on even iterations: the system in shared memory first.
    float emax = 0.f;
    bool nan = false;
    for (int jj = 0; jj < own; ++jj) {
      const int j = (it & 1) ? jj : own - 1 - jj;
      visit(sys(j));
      emax = fmaxf(emax, step<RT>(Y, Z, T, M, Mq, S, nan));
    }
    const float m = block_max(emax, nan);
    if (threadIdx.x == 0 && own > 0) fold(err + it, m);
    grid_sync(bar);
    prev = e;
    e = read_slot(err + it);
    ++it;
  }
  for (int jj = 0; jj < own; ++jj) {
    const int j = (it & 1) ? jj : own - 1 - jj;
    const int s = sys(j);
    visit(s);
    finish(Z, T, cbuf[s], b, s_out, wbar_out, scale, s, M, Mq, S);
    here = -1;  // Z now holds S: never stash it back.
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    count[0] = it;
    if (tally) {
      atomicAdd(reinterpret_cast<unsigned long long*>(tally),
                static_cast<unsigned long long>(it));
      atomicMax(tally + 1, (long long)it);
    }
  }
}

// ---------------------------------------------------------------------------
// Device-memory variant
// ---------------------------------------------------------------------------

// acc = A[r0 .., :] B[:, c0 ..] for rows r0 + 4 ty + i and columns c0 + 4
// tx + j (ty, tx < 16), through shared memory in K slices of kKc (A's slice
// transposed), two slices in flight: the next slice's loads from device
// memory are issued into registers before the current one is multiplied;
// outside [Mp, Mp] the operands read as zeros.
constexpr int kTile = 64, kKc = 16, kLd = kTile + 4;
constexpr int kPerThread = kTile * kKc / kWideThreads;

__device__ __forceinline__ void tile64(const float* A, const float* B,
                                       int Mp, int r0, int c0,
                                       float acc[4][4]) {
  __shared__ __align__(16) float As[2][kKc][kLd];
  __shared__ __align__(16) float Bs[2][kKc][kLd];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float ra[kPerThread], rb[kPerThread];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int idx = tid + q * kWideThreads;
      const int r = idx / kKc, k = idx - (idx / kKc) * kKc;
      const int gr = r0 + r, gk = k0 + k;
      ra[q] = gr < Mp && gk < Mp ? A[(long)gr * Mp + gk] : 0.f;
      const int kb = idx / kTile, c = idx - (idx / kTile) * kTile;
      const int gkb = k0 + kb, gc = c0 + c;
      rb[q] = gkb < Mp && gc < Mp ? B[(long)gkb * Mp + gc] : 0.f;
    }
  };
  auto keep = [&](int buf) {
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int idx = tid + q * kWideThreads;
      As[buf][idx - (idx / kKc) * kKc][idx / kKc] = ra[q];
      Bs[buf][idx / kTile][idx - (idx / kTile) * kTile] = rb[q];
    }
  };
  fetch(0);
  keep(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < Mp; k0 += kKc) {
    const bool more = k0 + kKc < Mp;
    if (more) fetch(k0 + kKc);
#pragma unroll
    for (int k = 0; k < kKc; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[buf][k][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[buf][k][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(av[i], b.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], b.y, acc[i][1]);
        acc[i][2] = fmaf(av[i], b.z, acc[i][2]);
        acc[i][3] = fmaf(av[i], b.w, acc[i][3]);
      }
    }
    if (more) keep(buf ^ 1);
    __syncthreads();
    buf ^= 1;
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

// The work buffers: Y and Z in pairs (iteration i reads pair member i % 2),
// then T: 5 [C, Mp, Mp].
__global__ void __launch_bounds__(kWideThreads, 4) ns_wide_kernel(
    const float* a, const float* b, float* s_out, float* wbar_out,
    float* work, float* cbuf, unsigned* bar, float* err,
    long long* count, long long* tally, int C, int M, int Mp, int iters,
    float tol, float quad, float scale) {
  const long per = (long)Mp * Mp;
  float* Yb[2] = {work, work + 2 * C * per};
  float* Zb[2] = {work + C * per, work + 3 * C * per};
  float* T = work + 4 * C * per;
  const int tiles = (Mp + kTile - 1) / kTile, nt = tiles * tiles;
  // The start: c, Y = A / c and Z = I per system, one system a CTA.
  for (int s = blockIdx.x; s < C; s += gridDim.x) {
    const float* as = a + (long)s * M * M;
    float rs = 0.f;
    bool nan = false;
    for (int r = threadIdx.x; r < M; r += blockDim.x) {
      float t = 0.f;
      for (int col = 0; col < M; ++col) t += fabsf(as[r * M + col]);
      rs = fmaxf(rs, t);
      nan = nan || t != t;
    }
    const float c = clamp_scale(block_max(rs, nan));
    if (threadIdx.x == 0) cbuf[s] = c;
    for (long idx = threadIdx.x; idx < per; idx += blockDim.x) {
      const int r = idx / Mp, col = idx - r * Mp;
      const bool in = r < M && col < M;
      Yb[0][s * per + idx] = in ? __fdiv_rn(as[r * M + col], c) : 0.f;
      Zb[0][s * per + idx] = in && r == col ? 1.f : 0.f;
    }
  }
  grid_sync(bar);
  float e = __int_as_float(0x7f800000), prev = e;
  int it = 0;
  while (runs(it, iters, e, prev, tol, quad)) {
    const int p = it & 1;
    float emax = 0.f;
    bool nan = false;
    for (long task = blockIdx.x; task < (long)nt * C; task += gridDim.x) {
      const int s = task / nt, t = task - (long)s * nt;
      const int r0 = kTile * (t / tiles), c0 = kTile * (t - (t / tiles) * tiles);
      float acc[4][4];
      tile64(Zb[p] + s * per, Yb[p] + s * per, Mp, r0, c0, acc);
      const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
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
      store64(T + s * per, Mp, r0, c0, acc);
    }
    const float m = block_max(emax, nan);
    if (threadIdx.x == 0) fold(err + it, m);
    grid_sync(bar);
    for (long task = blockIdx.x; task < 2L * nt * C; task += gridDim.x) {
      const int z = task >= (long)nt * C;
      const long rest = task - (long)z * nt * C;
      const int s = rest / nt, t = rest - (long)s * nt;
      const int r0 = kTile * (t / tiles), c0 = kTile * (t - (t / tiles) * tiles);
      float acc[4][4];
      if (!z) {
        tile64(Yb[p] + s * per, T + s * per, Mp, r0, c0, acc);
        store64(Yb[p ^ 1] + s * per, Mp, r0, c0, acc);
      } else {
        tile64(T + s * per, Zb[p] + s * per, Mp, r0, c0, acc);
        store64(Zb[p ^ 1] + s * per, Mp, r0, c0, acc);
      }
    }
    grid_sync(bar);
    prev = e;
    e = read_slot(err + it);
    ++it;
  }
  // The end: S = Z / sqrt(c) into T (out = scale S), then wbar = S (S b)
  // with u = S b in the free Y buffer.
  const float* Z = Zb[it & 1];
  float* u = Yb[(it & 1) ^ 1];
  for (long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < (long)C * per; idx += (long)gridDim.x * blockDim.x) {
    const int s = idx / per;
    const int r = (idx - s * per) / Mp, col = idx - s * per - (long)r * Mp;
    const float v = __fdiv_rn(Z[idx], __fsqrt_rn(cbuf[s]));
    T[idx] = v;
    if (r < M && col < M)
      s_out[(long)s * M * M + r * M + col] = scale == 1.f ? v : scale * v;
  }
  if (wbar_out) {
    grid_sync(bar);
    for (long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
         idx < (long)C * M; idx += (long)gridDim.x * blockDim.x) {
      const int s = idx / M, r = idx - (long)s * M;
      const float* row = T + s * per + (long)r * Mp;
      const float* bs = b + (long)s * M;
      float w = 0.f;
      for (int k = 0; k < M; ++k) w = fmaf(row[k], bs[k], w);
      u[s * per + r] = w;
    }
    grid_sync(bar);
    for (long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
         idx < (long)C * M; idx += (long)gridDim.x * blockDim.x) {
      const int s = idx / M, r = idx - (long)s * M;
      const float* row = T + s * per + (long)r * Mp;
      const float* us = u + s * per;
      float w = 0.f;
      for (int k = 0; k < M; ++k) w = fmaf(row[k], us[k], w);
      wbar_out[idx] = w;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    count[0] = it;
    if (tally) {
      atomicAdd(reinterpret_cast<unsigned long long*>(tally),
                static_cast<unsigned long long>(it));
      atomicMax(tally + 1, (long long)it);
    }
  }
}

// The CTAs of `kernel` at `threads` and `smem` that fit on device `dev`
// at once, asked once per (device, kernel, shape) and kept.  The kernel's
// dynamic shared memory limit is set on every launch: another width may
// have set it lower since.
struct Fit {
  int dev;
  const void* kernel;
  int threads, smem, ctas;
};
std::mutex fit_lock;
std::vector<Fit> fits;

template <typename K>
cudaError_t cooperative(K kernel, int threads, int smem, long tasks,
                        void** args, cudaStream_t s) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return e;
  int ctas = 0;
  {
    std::lock_guard<std::mutex> hold(fit_lock);
    for (const Fit& f : fits)
      if (f.dev == dev && f.kernel == (const void*)kernel &&
          f.threads == threads && f.smem == smem)
        ctas = f.ctas;
  }
  if (!ctas) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    ctas = per_sm * sms;
    std::lock_guard<std::mutex> hold(fit_lock);
    fits.push_back(Fit{dev, (const void*)kernel, threads, smem, ctas});
  }
  const int grid = (int)(tasks < ctas ? tasks : ctas);
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                  dim3(threads), args, (size_t)smem, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Whether a system of M members runs in shared memory (1) or in device
// memory (0); -1 for an M the kernel does not take (below 1).
int efa_ns_in_smem(int M) {
  if (M < 1) return -1;
  return in_smem(M) ? 1 : 0;
}

// Floats of the work buffer a solve of C systems of M members takes: Y and
// Z of every system padded (shared-memory variant), or the two pairs and T
// (device-memory variant); -1 for an M the kernel does not take.
long long efa_ns_work_floats(int C, int M) {
  if (M < 1 || C < 0) return -1;
  if (in_smem(M)) {
    const long long mq = make_plan(M).mq;
    return 2LL * C * mq * mq;
  }
  const long long mp = round_up(M, 4);
  return 5LL * C * mp * mp;
}

// The whole solve of C systems in one cooperative launch.  a [C, M, M]
// (SPD); b [C, M] or nullptr; s_out [C, M, M] = scale A^{-1/2}; wbar_out
// [C, M] = A^{-1} b (b given) or nullptr; work of efa_ns_work_floats(C, M) floats; cbuf [C]; scratch
// [2 + iters] 32-bit words (the barrier, then the iterations' error
// slots; set to 0 here); count [1] the iterations run, tally [2] (summed,
// most) added to when not nullptr.  Returns a cudaError_t.
int efa_newton_schulz(const float* a, const float* b, float* s_out,
                      float* wbar_out, float* work,
                      float* cbuf, int* scratch, long long* count,
                      long long* tally, int C, int M, int iters, float tol,
                      float quad, float scale, void* stream) {
  const int smem_ok = efa_ns_in_smem(M);
  if (smem_ok < 0 || C <= 0 || iters < 0 || !s_out || !work || !cbuf ||
      !scratch || !count || (wbar_out && !b))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e =
      cudaMemsetAsync(scratch, 0, (size_t)(2 + iters) * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  unsigned* bar = reinterpret_cast<unsigned*>(scratch);
  float* err = reinterpret_cast<float*>(scratch + 2);
  if (smem_ok) {
    const Plan p = make_plan(M);
    int mq = p.mq;
    void* args[] = {(void*)&a,     (void*)&b,     (void*)&s_out,
                    (void*)&wbar_out, (void*)&work,
                    (void*)&cbuf,  (void*)&bar,   (void*)&err,
                    (void*)&count, (void*)&tally, (void*)&C,
                    (void*)&M,     (void*)&mq,    (void*)&iters,
                    (void*)&tol,   (void*)&quad,  (void*)&scale};
    if (p.rt == 5)
      e = cooperative(ns_smem_kernel<5>, p.threads, p.smem, C, args, s);
    else if (p.rt == 4)
      e = cooperative(ns_smem_kernel<4>, p.threads, p.smem, C, args, s);
    else
      e = cooperative(ns_smem_kernel<8>, p.threads, p.smem, C, args, s);
    return (int)e;
  }
  int mp = round_up(M, 4);
  const int tiles = (mp + kTile - 1) / kTile;
  void* args[] = {(void*)&a,     (void*)&b,       (void*)&s_out,
                  (void*)&wbar_out, (void*)&work,
                  (void*)&cbuf,  (void*)&bar,     (void*)&err,
                  (void*)&count, (void*)&tally,   (void*)&C,
                  (void*)&M,     (void*)&mp,      (void*)&iters,
                  (void*)&tol,   (void*)&quad,    (void*)&scale};
  e = cooperative(ns_wide_kernel, kWideThreads, 0, 2L * tiles * tiles * C,
                  args, s);
  return (int)e;
}

}  // extern "C"
