// B3 and B4: the EnSRF body with localization weights streamed in per grid
// point.  The state's rows are VT groups (variables x times) over one grid of
// G points, row (v, g) at v * G + g.  Horizontal weights are per grid point,
// shared by every group; a per-(group, ob) scalar table carries vertical
// localization and the cross-variable factor.
//
// Replaces:
//   B3: efa_xray_tpu/ops/ensrf_pallas_fused.py, _make_fused_grid_kernel
//       (launched by _fused_grid_impl): every obs block in one launch while
//       a grid tile of one group stays on chip.  Entry point efa_grid_launch.
//   B4: efa_xray_tpu/ops/ensrf_pallas.py, _make_block_kernel (launched by
//       apply_obs_block_pallas, scanned by ensrf_blocked_body_pallas): one
//       obs block per launch.  Entry point efa_grid_launch (nb 1).
// Both run the same kernel: B3 over all blocks, B4 over one.
//   B4e: the stochastic EnKF's instantiation of B4 (template flag kZ, fp32;
//       no TPU kernel: the JAX package runs the EnKF's body in plain XLA,
//       efa_xray_tpu/assimilation/ensrf_core.py apply_obs_block with
//       apply_rows).  Entry point efa_grid_launch with z_b.
//
// What it computes, for a tile of rows X [T, M] (perturbations) and xm [T]
// (mean) of group v, for each block of B pre-solved obs with rows Y [B, M]:
//   D0 = X Y^T                                   (d0[j, r] = Y_j . X_r)
//   u_j = w[j, g_r] table[v, j] o (d0_j - sum_{i<j} ggt[j, i] u_i)
//   xm += U^T gain;  X -= (sqrt_coef o U)^T Y
// with ggt[j, i] = (y_i . y_j) sqrt_coef_i, w the block's weights [B, G]
// (absent: unlocalized) and the table absent meaning 1.  B4's exact
// haversine weights may instead be computed here, per (ob, point), from the
// geometry of the points and of the obs (gc_haversine), bit for bit the
// weights that the wrapper's torch ops build: no [B, G] operand then.  B4e
// takes the departure rows Z [B, M] as well: D0 still reads Y, ggt[j, i] =
// (z_i . y_j) sqrt_coef_i, and X -= (sqrt_coef o U)^T Z; Z is copied into
// the Y buffer once D0 has read Y, under the first panel's solve.
//
// What bounds it on an H100: with plain fp32 FMA, arithmetic.  Per (tile,
// block) the two products take 2 T B M FMAs and the substitution T B^2 / 2:
// at 30 members and blocks of 128 the substitution is half of the work, and
// no panel is ever dead (there is no cull).  The weights are read once per
// (group, tile, block), B T floats; Y, ggt and the per-ob rows are re-read by
// every CTA from the 50 MB L2.  An SM does 128 FMAs and loads 32 words of
// shared memory a clock, so the products need register tiles, and the panel
// loop (16 panels of 8 obs, each a short dependent chain between CTA-wide
// barriers) needs other CTAs on the SM to fill its waits.
//
// What the design does about it (the layout of B2, csrc/ensrf_fused.cu,
// without its trigonometry and cull, and with the weights as an operand to
// stream).  A CTA of 256 threads owns T points of one group and loops over
// the blocks it is given.
// 1. Register tiles on 16-byte loads.  D0: a thread owns 4 rows x 4 obs and
//    reads X and Y as float4 along the members (8 loads per 64 FMAs).
//    Apply: 4 rows x 4 consecutive members per thread, U and Y as float4 (2
//    loads per 16 FMAs); where that leaves threads free (30 members) the obs
//    are split over slices of them, which subtract in turn.  X and Y rows
//    are padded to 4 x odd words and each Y panel is shifted by 4 more
//    words, so that D0's loads spread over the banks.
// 2. The substitution looks right, not left: once the 8 obs of a panel are
//    solved, every ob below loses its products with them, U[j, :] -= G[j,
//    panel] U[panel, :], a rank-8 update with 4 obs x 4 rows per thread (24
//    16-byte loads and stores per 128 FMAs).  It needs no partial sums and
//    no pass to add them up, and its parallelism is widest at the first
//    panels.  (Holding the update of the obs below a super-panel of 4
//    panels back until it is solved, so that U is read and written once
//    per 32 obs, was measured: equal at 30 members, 5% slower at 80.)  Only
//    the 8 x 8 triangle inside the panel runs one thread per row: operands
//    to registers first, then a chain of FMAs; the mean increment rides
//    along in a register of that thread.  Two CTA-wide barriers per panel.
// 3. Nothing resident that can stream.  A panel's ggt columns (its own rows
//    and those below) and its 8 weight rows arrive through a ring of slots
//    (cp.async), fetched kAhead panels ahead and across block boundaries by
//    the warps that the in-panel chain leaves idle: the weights come from
//    device memory, so their latency is this kernel's own to hide.  Where
//    the kernel computes the weights, the same threads write them into the
//    same slot, reading the geometry through the read-only cache: the
//    trigonometry runs beside the chain, in no shared memory of its own.
//    Y, the per-ob rows and the table row of the next block are fetched
//    once this block's apply has read them.  Copies are 16 bytes wide where
//    sizes and addresses allow (the vec flags), 4 bytes otherwise, so any
//    G, B and M is exact without padding by the caller.
// 4. Several CTAs per SM: with no [B, B] table a CTA of 64 points takes 75
//    KB at 30 members (three fit an SM) and 112 KB at 80 (two fit); the
//    register limit follows the CTA count (the kCtas template parameter).
//    The wrapper picks the tile.
// 5. CTAs are numbered tile-major: the VT groups of one grid tile are
//    adjacent in launch order, so all but the first read of a weight slab
//    come from the L2 (measured no faster than group-major order at 80
//    groups x 254 tiles, where the CTAs in flight share slabs either way).
// Points past the end of the grid (a ragged last tile) are zero, their
// weights are never read and their rows never written.
//
// The two large products, D0 and the apply, run in one of three modes, the
// template parameter kMode (ops/precision.py product_mode): fp32 FMA (the
// register tiles above), or TF32 or bf16 tensor cores (mma_modes.cuh),
// each operand rounded once where grid_apply_plain rounds it: Y by the
// wrapper (y_b arrives rounded), X in D0's registers (D0 runs transposed,
// a warp per 8 points over every panel), sqrt_coef o U in place in U after
// the substitution.  The substitution, the weights, the table and the mean
// are fp32 in every mode.  The mode layout (make_mode_layout) is the fp32
// one with U's rows T + 4 words apart and the X and Y rows at least the
// staged K wide: at 30 members and 64 points it still fits three CTAs on
// an SM, at 80 members two.
//
// Any ensemble and any block, by the two levers of B2 (csrc/ensrf_fused.cu;
// ops/ensrf_grid.py plan picks, the same at every shape whose layout fits
// as before): sub-blocks, which the wrapper cuts from the caller's blocks
// (Y, the ggt tables' diagonal blocks, the weights, the table and the
// per-ob rows) and this launch sweeps in order, exact as a smaller block
// is; and member slices (Ms < M), where X stays in bp_out and D0 and the
// apply stage Ms members of X and of the block's rows at a time, D0 summed
// over the slices in order.  The weight ring and the per-(group, ob) table
// have no member term.
//
// Shared memory (floats; make_layout below, mirrored by ops/ensrf_grid.py
// smem_bytes, with M the slice Ms): X [T, Ys], Y [Bp Ys + Bp / 2], U [Bp,
// T], ring [kSlots] of ggt columns [Bp, 8] and of weight rows [8, T],
// per-ob rows [kCoef B], mean [T]; Ys = 4 (ceil(M / 4) | 1), Bp = B rounded
// up to 8.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_modes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPanel = 8;
// Per-ob rows in shared memory: gain, sqrt_coef, table factor.
constexpr int kCoef = 3;
// Panels fetched ahead of the one being solved, and the slots of the ring
// of ggt and weight panels.  (Two ahead measured no faster at equal CTAs
// per SM; the third slot costs 6 KB at 64 points, and with it the third CTA
// at 30 members and the second at 80.)
constexpr int kAhead = 1;
constexpr int kSlots = 1 + kAhead;
// Parts of the kernel that a build with -DEFA_GRID_SKIP=<bits> leaves out,
// to time what each costs (no profiler sees inside a kernel here): the
// results of such a build are wrong.  0 in every build that is used.
#ifndef EFA_GRID_SKIP
#define EFA_GRID_SKIP 0
#endif
constexpr int kSkipChain = 1, kSkipUpdate = 2, kSkipD0 = 4, kSkipApply = 8,
              kSkipPanels = 16, kSkipRound = 32;
__host__ __device__ constexpr bool skips(int part) { return (EFA_GRID_SKIP & part) != 0; }
// Shared memory of an SM, and what the system keeps of it for each CTA.
constexpr int kSmSmemBytes = 233472;
constexpr int kCtaReservedBytes = 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous copies of 16 bytes (both addresses 16-byte aligned) or of 4.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies n floats; by 16 bytes when vec (n a multiple of 4, both aligned).
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int n, bool vec, int tid) {
  if (vec) {
    for (int i = tid; i < (n >> 2); i += kThreads)
      cp_async16(dst + 4 * i, src + 4 * i);
  } else {
    for (int i = tid; i < n; i += kThreads) cp_async4(dst + i, src + i);
  }
}

// Copies `rows` rows of n floats, one warp per row: row i from src + i *
// sstride to dst + doff(i).
template <typename DstOffset>
__device__ __forceinline__ void copy_rows_async(float* dst, DstOffset doff,
                                                const float* src, long sstride,
                                                int rows, int n, bool vec,
                                                int tid) {
  const int lane = tid & 31;
  for (int i = tid >> 5; i < rows; i += kWarps) {
    float* d = dst + doff(i);
    const float* s = src + i * sstride;
    if (vec) {
      for (int c = lane; c < (n >> 2); c += 32)
        cp_async16(d + 4 * c, s + 4 * c);
    } else {
      for (int c = lane; c < n; c += 32) cp_async4(d + c, s + c);
    }
  }
}

// The Gaspari-Cohn weight of an ob (latitude in radians, longitude in
// degrees, cos(latitude), halfwidth in km) at a point (the same three) at
// exact haversine distance: observation/localization.py haversine (ob
// first) and gaspari_cohn op for op, each op rounded once as torch's
// kernels on the card round it (no contraction into FMAs; a division by a
// Python float is a product with its float reciprocal there, a Python float
// over a tensor the tensor's reciprocal times it), so that the weights are
// the wrapper's torch weights bit for bit.  An infinite halfwidth gives 1.
__device__ __forceinline__ float gc_haversine(float olat, float olon,
                                              float ocos, float hw,
                                              float plat, float plon,
                                              float pcos) {
  constexpr float kDegToRad = static_cast<float>(
      0.017453292519943295769236907684886127134428718885417);
  constexpr float kEarthKm = 6371.0f;
  constexpr float kFiveThirds = static_cast<float>(5.0 / 3.0);
  const float dlat = __fsub_rn(plat, olat);
  // Weight 0 without the trigonometry where latitude alone puts the pair
  // past two halfwidths: with the cosines' product >= 0, a >= sin(dlat/2)^2
  // and so d >= R |dlat| for |dlat| <= 3, every rounding below within 1e-5
  // of it; R |dlat| >= 2.002 |hw| then gives r >= 2, as torch computes it.
  if (__fmul_rn(ocos, pcos) >= 0.0f && fabsf(dlat) <= 3.0f &&
      __fmul_rn(fabsf(dlat), kEarthKm) >= __fmul_rn(fabsf(hw), 2.002f))
    return 0.0f;
  const float dlon = __fmul_rn(__fsub_rn(plon, olon), kDegToRad);
  const float sl = sinf(__fmul_rn(dlat, 0.5f));
  const float sn = sinf(__fmul_rn(dlon, 0.5f));
  const float a = __fadd_rn(
      __fmul_rn(sl, sl), __fmul_rn(__fmul_rn(ocos, pcos), __fmul_rn(sn, sn)));
  const float c = __fmul_rn(atan2f(sqrtf(a), sqrtf(__fsub_rn(1.0f, a))), 2.0f);
  const float r = __fdiv_rn(__fmul_rn(c, kEarthKm), fabsf(hw));
  if (r <= 1.0f) {
    float p = __fadd_rn(__fmul_rn(r, -0.25f), 0.5f);
    p = __fadd_rn(__fmul_rn(p, r), 0.625f);
    p = __fsub_rn(__fmul_rn(p, r), kFiveThirds);
    return __fadd_rn(__fmul_rn(p, __fmul_rn(r, r)), 1.0f);
  }
  if (!(r < 2.0f)) return 0.0f;  // NaN too, as torch.where gives
  float p = __fsub_rn(__fmul_rn(r, 1.0f / 12.0f), 0.5f);
  p = __fadd_rn(__fmul_rn(p, r), 0.625f);
  p = __fadd_rn(__fmul_rn(p, r), kFiveThirds);
  p = __fsub_rn(__fmul_rn(p, r), 5.0f);
  p = __fadd_rn(__fmul_rn(p, r), 4.0f);
  return __fsub_rn(p, __fmul_rn(__fdiv_rn(1.0f, __fmul_rn(r, 3.0f)), 2.0f));
}

// Which operands may be copied 16 bytes at a time: Y rows (M), ggt rows
// (B), the gain/sqrt_coef rows (2 B), the table row (B), the weight rows
// (G), the state's rows in and out (M).
constexpr int kVecY = 1, kVecG = 2, kVecC = 4, kVecT = 8, kVecW = 16,
              kVecX = 32;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Offsets (floats) of the arrays in dynamic shared memory.
struct Layout {
  int Ys, Bp;
  int x, y, u, g, w, cf, xm, total;
};

__host__ __device__ inline Layout make_layout(int T, int B, int M) {
  Layout L;
  L.Ys = 4 * (((M + 3) >> 2) | 1);
  L.Bp = (B + kPanel - 1) / kPanel * kPanel;
  int o = 0;
  L.x = o, o += T * L.Ys;
  L.y = o, o += L.Bp * L.Ys + 4 * (L.Bp / kPanel);
  L.u = o, o += L.Bp * T;
  L.g = o, o += kSlots * L.Bp * kPanel;
  L.w = o, o += kSlots * kPanel * T;
  L.cf = o, o += round4(kCoef * B);
  L.xm = o, o += T;
  L.total = o;
  return L;
}

// The layout of the tensor-core modes (mma_modes.cuh): the fp32 one with
// U's rows T + 4 words apart and the X and Y rows at least the staged K.
__host__ __device__ inline Layout make_mode_layout(int T, int B, int M,
                                                   int mode) {
  Layout L;
  L.Ys = efa_mma::mode_row_stride(mode, M);
  L.Bp = (B + kPanel - 1) / kPanel * kPanel;
  int o = 0;
  L.x = o, o += T * L.Ys;
  L.y = o, o += L.Bp * L.Ys + 4 * (L.Bp / kPanel);
  L.u = o, o += L.Bp * efa_mma::u_stride(mode, T);
  L.g = o, o += kSlots * L.Bp * kPanel;
  L.w = o, o += kSlots * kPanel * T;
  L.cf = o, o += round4(kCoef * B);
  L.xm = o, o += T;
  L.total = o;
  return L;
}

__host__ __device__ inline Layout layout_of(int T, int B, int M, int mode) {
  return mode == efa_mma::kIeee ? make_layout(T, B, M)
                                : make_mode_layout(T, B, M, mode);
}

// CTAs per SM the launch plans for (mirrored by ops/ensrf_grid.py
// ctas_per_sm): what fits by shared memory, at most 3.
__host__ inline int ctas_per_sm(int smem) {
  const int fit = kSmSmemBytes / (smem + kCtaReservedBytes);
  return fit > 3 ? 3 : fit;
}

// Row j of the Y buffer: rows are Ys apart and every panel of 8 starts 4
// words later than the rows alone would put it, so that the rows of
// different panels that a warp reads at once in D0 fall into different
// banks.
__device__ __forceinline__ int yrow(int j, int Ys) {
  return j * Ys + 4 * (j >> 3);
}

// X -= U^T Y over all Bp obs: a thread owns 4 rows x 4 consecutive members
// and reads U and Y 16 bytes at a time (2 loads per 16 FMAs).  Where those
// (T / 4) x (Mp / 4) tiles are at most half of the threads, the obs are
// split over up to 4 slices of threads, which subtract in turn.  Ends on a
// barrier.
__device__ __forceinline__ void apply_tiles(float* Xs, const float* Ysm,
                                            const float* U, int Bp, int T,
                                            int Ys, int Mp, int tid) {
  const int MQ = Mp >> 2;
  const int ntasks = (T >> 2) * MQ;
  const int npanels = Bp / kPanel;
  const int nslices = 2 * ntasks <= kThreads ? min(kThreads / ntasks, 4) : 1;
  const int slice = nslices > 1 ? tid / ntasks : 0;
  const int q0 = slice * npanels / nslices;
  const int q1 = (slice + 1) * npanels / nslices;
  for (int t0 = 0; t0 < ntasks; t0 += kThreads) {  // one pass when sliced
    const int task = nslices > 1 ? tid - slice * ntasks : t0 + tid;
    const bool on = slice < nslices && task < ntasks;
    const int rg = on ? task / MQ : 0;
    const int mq = on ? task - rg * MQ : 0;
    float4 acc[4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) acc[rr] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (on) {
      for (int q = q0; q < q1; ++q) {
        const int jb = kPanel * q;
        const float* yp = Ysm + yrow(jb, Ys) + 4 * mq;
        const float* up = U + jb * T + 4 * rg;
#pragma unroll
        for (int t = 0; t < kPanel; ++t) {
          const float4 u = *reinterpret_cast<const float4*>(up + t * T);
          const float4 y = *reinterpret_cast<const float4*>(yp + t * Ys);
          const float ur[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            acc[rr].x = fmaf(ur[rr], y.x, acc[rr].x);
            acc[rr].y = fmaf(ur[rr], y.y, acc[rr].y);
            acc[rr].z = fmaf(ur[rr], y.z, acc[rr].z);
            acc[rr].w = fmaf(ur[rr], y.w, acc[rr].w);
          }
        }
      }
    }
    for (int s = 0; s < nslices; ++s) {
      if (on && slice == s) {
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          float4* xp =
              reinterpret_cast<float4*>(Xs + (4 * rg + rr) * Ys + 4 * mq);
          float4 x = *xp;
          x.x -= acc[rr].x, x.y -= acc[rr].y, x.z -= acc[rr].z,
              x.w -= acc[rr].w;
          *xp = x;
        }
      }
      __syncthreads();
    }
  }
}

// bm_out/bp_out may alias bm_in/bp_in (in-place update): a CTA reads its
// own rows before the block loop and writes only those rows after it.
// kCtas: the CTAs per SM the register count is held to; kMode: the two
// large products' mode (efa_mma::kIeee, kTf32, kBf16).
// kZ: B4e (fp32), the apply reads z_b instead of y_b.  Ms: the members
// staged at a time (M: all, X resident for the launch).
template <int kCtas, int kMode, bool kZ>
__global__ void __launch_bounds__(kThreads, kCtas) grid_body_kernel(
    const float* bm_in,  // [VT * G]
    const float* bp_in,  // [VT * G, M]
    const float* __restrict__ w,      // [nb, B, G] or nullptr (unlocalized)
    const float* __restrict__ table,  // [VT, nb, B] or nullptr (ones)
    const float* __restrict__ y_b,    // [nb, B, M]
    const float* __restrict__ z_b,    // [nb, B, M] B4e, else nullptr
    const float* __restrict__ ggt_b,  // [nb, B, B]
    const float* __restrict__ coef_b, // [nb, 2, B]: gain, sqrt_coef
    // Where w is nullptr and these are not, the weights are computed here:
    const float* __restrict__ pgeo,   // [3, G] lat (rad), lon (deg), cos lat
    const float* __restrict__ ogeo,   // [nb, 4, B] the same, halfwidth (km)
    int VT, int G, int M, int Ms, int B, int nb, int T, int vec,
    float* bm_out, float* bp_out) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = kMode == efa_mma::kIeee ? make_layout(T, B, Ms)
                                           : make_mode_layout(T, B, Ms, kMode);
  const int Ys = L.Ys, Bp = L.Bp;
  // Member slices: X lives in bp_out, a slice at a time in Xs.
  const bool sliced = Ms < M;
  const int nslice = (M + Ms - 1) / Ms;
  float* Xs = smem + L.x;     // [T, Ys]
  float* Ysm = smem + L.y;    // [Bp rows, skewed]
  float* U = smem + L.u;      // [Bp, T]  d0 columns, then u columns
  float* Gr = smem + L.g;     // [kSlots][Bp, kPanel] ggt columns of a panel
  float* Wr = smem + L.w;     // [kSlots][kPanel, T] weight rows of a panel
  float* cf = smem + L.cf;    // [kCoef, B]
  float* xm = smem + L.xm;    // [T]
  // U's row stride: T, or T + 4 in the tensor-core modes (mma_modes.cuh),
  // whose warps keep kModeTiles x kModeSplit mma chains in flight and hold
  // kModeSteps k-steps of X at a time, as the registers that the CTAs per
  // SM leave allow (measured: at two CTAs eight tiles of one chain beat
  // four of two; at three, four of two beat four of one).
  const int Us = efa_mma::u_stride(kMode, T);
  constexpr int kModeTiles = kCtas >= 3 ? 4 : 8;
  constexpr int kModeSplit = kCtas >= 3 ? 2 : 1;
  constexpr int kModeSteps = kCtas >= 3 ? 8 : 12;

  const int tid = threadIdx.x;
  const int tile = blockIdx.x / VT;
  const int v = blockIdx.x - tile * VT;
  const long g0 = (long)tile * T;
  const int npts = (int)min((long)T, (long)G - g0);
  const long row0 = (long)v * G + g0;
  const int npanels = Bp / kPanel;
  const int total_panels = nb * npanels;
  const int tsh = T == 64 ? 6 : 5;  // T is 32 or 64 (the launcher checks)
  const bool localize = w != nullptr || pgeo != nullptr;

  // Zero everything once: the pad columns of X and Y, the Y rows past B, the
  // rows and weights of the ragged last tile are never written again.
  for (int idx = tid; idx < (L.total >> 2); idx += kThreads)
    reinterpret_cast<float4*>(smem)[idx] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  if (!table)
    for (int j = tid; j < B; j += kThreads) cf[2 * B + j] = 1.0f;
  if (!sliced) {
    copy_rows_async(Xs, [Ys](int r) { return r * Ys; }, bp_in + row0 * M, M,
                    npts, M, vec & kVecX, tid);
  } else if (bp_out != bp_in) {
    for (long idx = tid; idx < (long)npts * M; idx += kThreads)
      bp_out[row0 * M + idx] = bp_in[row0 * M + idx];
  }
  for (int r = tid; r < npts; r += kThreads) xm[r] = bm_in[row0 + r];

  // Y (unless sliced: stage does), the per-ob rows and the table row of
  // block b, asynchronously.
  auto fetch_block = [&](int b) {
    if (!sliced) {
      if constexpr (kMode == efa_mma::kBf16) {
        // Rows of round16(M) bf16 values from the wrapper: whole 16 bytes.
        const int kw = efa_mma::staged_words(kMode, M);
        copy_rows_async(Ysm, [Ys](int j) { return yrow(j, Ys); },
                        y_b + (long)b * B * kw, kw, B, kw, true, tid);
      } else {
        copy_rows_async(Ysm, [Ys](int j) { return yrow(j, Ys); },
                        y_b + (long)b * B * M, M, B, M, vec & kVecY, tid);
      }
    }
    copy_async(cf, coef_b + (long)b * 2 * B, 2 * B, vec & kVecC, tid);
    if (table)
      copy_async(cf + 2 * B, table + ((long)v * nb + b) * B, B, vec & kVecT,
                 tid);
  };
  // Member slice s: X's points from bp_out and block b's rows of `src`
  // (y_b, or B4e's z_b), synchronously, zero past the slice's end up to the
  // columns the products read.  Returns the slice's members.
  auto stage = [&](int s, const float* src, int b) {
    const int m0 = s * Ms, msz = min(Ms, M - m0);
    const int kc = kMode == efa_mma::kIeee
                       ? round4(msz)
                       : efa_mma::staged_values(kMode, msz);
    for (int idx = tid; idx < T * kc; idx += kThreads) {
      const int r = idx / kc, c = idx - r * kc;
      Xs[r * Ys + c] =
          r < npts && c < msz ? bp_out[(row0 + r) * M + m0 + c] : 0.f;
    }
    if constexpr (kMode == efa_mma::kBf16) {
      // The wrapper's rows are zero from M to round16(M); m0 is even.
      const int kw = efa_mma::staged_words(kMode, M);
      const int sw = efa_mma::staged_words(kMode, msz);
      const float* yw = src + (long)b * B * kw + m0 / 2;
      for (int idx = tid; idx < B * sw; idx += kThreads) {
        const int j = idx / sw, c = idx - j * sw;
        Ysm[yrow(j, Ys) + c] = yw[(long)j * kw + c];
      }
    } else {
      const float* yb = src + (long)b * B * M + m0;
      for (int idx = tid; idx < B * kc; idx += kThreads) {
        const int j = idx / kc, c = idx - j * kc;
        Ysm[yrow(j, Ys) + c] = c < msz ? yb[(long)j * M + c] : 0.f;
      }
    }
    return msz;
  };
  // Member slice s of X back to bp_out.
  auto store = [&](int s, int msz) {
    const int m0 = s * Ms;
    for (int idx = tid; idx < npts * msz; idx += kThreads) {
      const int r = idx / msz, c = idx - r * msz;
      bp_out[(row0 + r) * M + m0 + c] = Xs[r * Ys + c];
    }
  };
  // Panel q of block b into ring slot `slot`, asynchronously, by threads
  // ft = 0 .. nft - 1: the panel's ggt columns from its own rows down (row j
  // of the slot is ggt[j, base : base + 8]) and the weight rows of this
  // tile's points, copied from w or computed from the geometry (a plain
  // store, seen by the readers after the barrier that follows the copies'
  // wait).
  auto fetch_panel = [&](int b, int q, int slot, int ft, int nft) {
    const int base = q * kPanel;
    const int width = min(kPanel, B - base), rows = B - base;
    const float* gb = ggt_b + ((long)b * B + base) * B + base;
    float* gd = Gr + (slot * Bp + base) * kPanel;
    if (vec & kVecG) {  // B, and so the width, is a multiple of 4
      const int psh = width >> 3;  // 16-byte pieces of a row: 1 << psh
      for (int idx = ft; idx < (rows << psh); idx += nft) {
        const int jr = idx >> psh, c = 4 * (idx & psh);
        cp_async16(gd + jr * kPanel + c, gb + (long)jr * B + c);
      }
    } else {
      for (int idx = ft; idx < rows * kPanel; idx += nft) {
        const int jr = idx >> 3, c = idx & 7;
        if (c < width) cp_async4(gd + jr * kPanel + c, gb + (long)jr * B + c);
      }
    }
    float* wd = Wr + slot * kPanel * T;
    if (pgeo) {  // consecutive threads take consecutive points of one ob
      const float* og = ogeo + (long)b * 4 * B + base;
      for (int idx = ft; idx < (width << tsh); idx += nft) {
        const int t = idx >> tsh, r = idx & (T - 1);
        if (r < npts)
          wd[t * T + r] = gc_haversine(
              __ldg(og + t), __ldg(og + B + t), __ldg(og + 2 * B + t),
              __ldg(og + 3 * B + t), __ldg(pgeo + g0 + r),
              __ldg(pgeo + G + g0 + r), __ldg(pgeo + 2L * G + g0 + r));
      }
    } else if (localize) {
      const float* wb = w + ((long)b * B + base) * G + g0;
      if (vec & kVecW) {  // G, and so npts, is a multiple of 4
        for (int idx = ft; idx < (width << (tsh - 2)); idx += nft) {
          const int t = idx >> (tsh - 2), c = 4 * (idx & ((T >> 2) - 1));
          if (c < npts) cp_async16(wd + t * T + c, wb + (long)t * G + c);
        }
      } else {
        for (int idx = ft; idx < (width << tsh); idx += nft) {
          const int t = idx >> tsh, r = idx & (T - 1);
          if (r < npts) cp_async4(wd + t * T + r, wb + (long)t * G + r);
        }
      }
    }
  };
  // The panels are fetched in the order the CTA solves them, across block
  // boundaries; every thread keeps the position, threads ft >= 0 copy.
  int fb = 0, fq = 0, fslot = 0;
  auto fetch_next = [&](int ft, int nft) {
    if (fb < nb && ft >= 0) fetch_panel(fb, fq, fslot, ft, nft);
    if (++fq == npanels) fq = 0, ++fb;
    if (++fslot == kSlots) fslot = 0;
  };

  const int RG = T >> 2, rgsh = tsh - 2;  // D0: groups of 4 rows
  const int RT = T >> 4;                  // tensor-core tiles of 16 points
  const int lane = tid & 31, warp = tid >> 5;
  const auto ypanel = [Ys](int p, int i) { return yrow(kPanel * p + i, Ys); };
  // U[j, :] -= G[j, panel] U[panel, :] for jlo <= j < jhi (multiples of
  // 4), the panel's ggt columns at Gp and its obs from `base` on: 4 obs x 4
  // rows per thread, 8 deep.
  auto update = [&](int jlo, int jhi, const float* Gp, int base) {
    const int ntask = ((jhi - jlo) >> 2) << rgsh;
    for (int task = tid; task < ntask; task += kThreads) {
      const int rq = task & (RG - 1);
      const int j0 = jlo + 4 * (task >> rgsh);
      float* dp = U + j0 * Us + 4 * rq;
      const float* gp = Gp + j0 * kPanel;
      const float* up = U + base * Us + 4 * rq;
      float4 acc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        acc[a] = *reinterpret_cast<const float4*>(dp + a * Us);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4 g4[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          g4[a] = *reinterpret_cast<const float4*>(gp + a * kPanel + 4 * h);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const float4 u =
              *reinterpret_cast<const float4*>(up + (4 * h + ii) * Us);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float g = ii == 0   ? g4[a].x
                            : ii == 1 ? g4[a].y
                            : ii == 2 ? g4[a].z
                                      : g4[a].w;
            acc[a].x = fmaf(-g, u.x, acc[a].x);
            acc[a].y = fmaf(-g, u.y, acc[a].y);
            acc[a].z = fmaf(-g, u.z, acc[a].z);
            acc[a].w = fmaf(-g, u.w, acc[a].w);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
        *reinterpret_cast<float4*>(dp + a * Us) = acc[a];
    }
  };

  fetch_block(0);
  cp_async_commit();
  for (int p = 0; p < kAhead; ++p) {
    fetch_next(tid, kThreads);
    cp_async_commit();
  }
  int cslot = 0;      // ring slot of the panel being solved
  float macc = 0.0f;  // thread r < T: the block's mean increment of row r
  for (int b = 0; b < nb; ++b) {
    cp_async_wait<0>();
    // X (first block), this block's Y and per-ob rows and its first panels
    // have landed, and every thread has left the block before.
    __syncthreads();

    // D0 = X Y^T: 4 rows x 4 obs per thread, or on the tensor cores a warp
    // per 8 points over every panel; slice by slice of the members where
    // sliced, each adding to the last.
    for (int sl = 0; sl < nslice; ++sl) {
      const int msz = sliced ? stage(sl, y_b, b) : M;
      if (sliced) __syncthreads();
      const int Mp = round4(msz);
      if constexpr (kMode != efa_mma::kIeee) {
        if (warp < (T >> 3) && !skips(kSkipD0))
          efa_mma::d0t_warp<kMode, kModeSteps, kModeTiles, kModeSplit>(
              Xs, Ys, Ysm, ypanel, [](int p) { return kPanel * p; }, npanels,
              efa_mma::staged_words(kMode, msz) * 4 / efa_mma::kStepBytes, U,
              Us, 8 * warp, lane, sl > 0);
      }
      for (int task = tid; kMode == efa_mma::kIeee &&
                           task < RG * 2 * npanels && !skips(kSkipD0);
           task += kThreads) {
        const int rgi = task & (RG - 1), j0 = 4 * (task >> rgsh);
        const float* xp = Xs + rgi * Ys;
        const float* yp = Ysm + yrow(j0, Ys);
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.0f;
        for (int m = 0; m < Mp; m += 4) {
          float4 xv[4], yv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            xv[i] = *reinterpret_cast<const float4*>(xp + i * RG * Ys + m);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            yv[jj] = *reinterpret_cast<const float4*>(yp + jj * Ys + m);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              float s = acc[i][jj];
              s = fmaf(xv[i].x, yv[jj].x, s);
              s = fmaf(xv[i].y, yv[jj].y, s);
              s = fmaf(xv[i].z, yv[jj].z, s);
              s = fmaf(xv[i].w, yv[jj].w, s);
              acc[i][jj] = s;
            }
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float* up = U + (j0 + jj) * T + rgi + i * RG;
            *up = sl > 0 ? *up + acc[i][jj] : acc[i][jj];
          }
      }
      if (sliced) __syncthreads();  // read before the next slice lands
    }
    __syncthreads();
    if constexpr (kZ) {
      // D0 has read Y: the apply's rows Z take its place, landing by the
      // first panel's wait; sliced, the apply stages them.
      if (!sliced) {
        copy_rows_async(Ysm, [Ys](int j) { return yrow(j, Ys); },
                        z_b + (long)b * B * M, M, B, M, vec & kVecY, tid);
        cp_async_commit();
      }
    }

    // The forward substitution, panel by panel.  U holds, for the obs not
    // yet solved, d0 less the products with every panel solved so far.
    for (int q = 0; q < npanels && !skips(kSkipPanels); ++q) {
      const int base = q * kPanel;
      const int width = min(kPanel, B - base);
      const float* Gp = Gr + cslot * Bp * kPanel;
      const float* Wp = Wr + cslot * kPanel * T;
      if (tid < T && !skips(kSkipChain)) {
        // The chain inside the panel, one thread per row: operands to
        // registers first (a store to U would hold back the loads behind
        // it), then the 8 x 8 triangle; the mean increment rides along.
        const int r = tid;
        float d[kPanel], wt[kPanel], gn[kPanel];
        float4 glo[kPanel], ghi[kPanel];
#pragma unroll
        for (int t = 0; t < kPanel; ++t) {
          d[t] = gn[t] = 0.0f;
          wt[t] = 1.0f;
          glo[t] = ghi[t] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (t < width) {
            const int j = base + t;
            d[t] = U[j * Us + r];
            gn[t] = cf[j];
            if (localize) wt[t] = Wp[t * T + r] * cf[2 * B + j];
            if (t > 0)
              glo[t] = *reinterpret_cast<const float4*>(Gp + j * kPanel);
            if (t > 4)
              ghi[t] = *reinterpret_cast<const float4*>(Gp + j * kPanel + 4);
          }
        }
        float ur[kPanel];
        float mloc = 0.f;
#pragma unroll
        for (int t = 0; t < kPanel; ++t) {
          const float g[kPanel] = {glo[t].x, glo[t].y, glo[t].z, glo[t].w,
                                   ghi[t].x, ghi[t].y, ghi[t].z, ghi[t].w};
          float corr = 0.f;
#pragma unroll
          for (int i = 0; i < t; ++i) corr = fmaf(g[i], ur[i], corr);
          ur[t] = (d[t] - corr) * wt[t];
          mloc = fmaf(gn[t], ur[t], mloc);
        }
#pragma unroll
        for (int t = 0; t < kPanel; ++t)
          if (t < width) U[(base + t) * Us + r] = ur[t];
        macc += mloc;
      }
      // Meanwhile the other warps fetch the panel kAhead ahead into the
      // slot that the panel before this one has left.
      fetch_next(tid - T, kThreads - T);
      cp_async_commit();
      __syncthreads();

      // The obs below the panel lose its products.
      if (!skips(kSkipUpdate)) update(base + kPanel, Bp, Gp, base);
      // The next panel's columns and weights have landed (the one fetched
      // after it may still fly).
      cp_async_wait<kAhead - 1>();
      __syncthreads();
      if (++cslot == kSlots) cslot = 0;
    }

    if constexpr (kMode != efa_mma::kIeee) {
      // The apply on the tensor cores: sqrt_coef o U rounded in place, then
      // X -= U^T Y, a warp per 16 points x every (8 / RT)-th tile of 8
      // members.
      if (!skips(kSkipRound))
        efa_mma::round_left<kMode>(
            U, Us, T, Bp, B, [](int i) { return i; },
            [cf, B](int j) { return cf[B + j]; }, tid, kThreads);
      if (tid < T) {
        xm[tid] += macc;
        macc = 0.0f;
      }
      __syncthreads();
      for (int sl = 0; sl < nslice; ++sl) {
        const int msz = sliced ? stage(sl, y_b, b) : M;
        if (sliced) __syncthreads();
        if (!skips(kSkipApply))
          efa_mma::apply_warp<kMode, kModeTiles, kModeSplit>(
              Xs, Ys, U, [Us](int a, int i) { return (kPanel * a + i) * Us; },
              Us, Ysm, ypanel, npanels, msz, 16 * (warp % RT), warp / RT,
              kWarps / RT, (msz + 7) >> 3, lane);
        __syncthreads();
        if (sliced) {
          store(sl, msz);
          __syncthreads();
        }
      }
    } else {
      // U <- sqrt_coef o U, so that the apply is X -= U^T Y.
      for (int idx = tid; idx < Bp * RG; idx += kThreads) {
        const int c = idx & (RG - 1), j = idx >> rgsh;
        if (j < B) {
          const float g = cf[B + j];
          float4* up = reinterpret_cast<float4*>(U + j * T + 4 * c);
          float4 u = *up;
          u.x *= g, u.y *= g, u.z *= g, u.w *= g;
          *up = u;
        }
      }
      if (tid < T) {
        xm[tid] += macc;
        macc = 0.0f;
      }
      __syncthreads();
      for (int sl = 0; sl < nslice; ++sl) {
        const int msz = sliced ? stage(sl, kZ ? z_b : y_b, b) : M;
        if (sliced) __syncthreads();
        if (skips(kSkipApply))
          __syncthreads();
        else
          apply_tiles(Xs, Ysm, U, Bp, T, Ys, round4(msz), tid);
        if (sliced) {
          store(sl, msz);
          __syncthreads();
        }
      }
    }
    // The apply ended on a barrier: Y and the per-ob rows are free.
    if (b + 1 < nb) fetch_block(b + 1);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int r = warp; !sliced && r < npts; r += kWarps) {
    const float* xs = Xs + r * Ys;
    float* out = bp_out + (row0 + r) * M;
    if (vec & kVecX) {
      for (int c = lane; c < (M >> 2); c += 32)
        reinterpret_cast<float4*>(out)[c] =
            reinterpret_cast<const float4*>(xs)[c];
    } else {
      for (int c = lane; c < M; c += 32) out[c] = xs[c];
    }
  }
  for (int r = tid; r < npts; r += kThreads) bm_out[row0 + r] = xm[r];
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int kCtas, int kMode, bool kZ = false>
int launch_as(const float* bm_in, const float* bp_in, const float* w,
              const float* table, const float* y_b, const float* z_b,
              const float* ggt_b, const float* coef_b, const float* pgeo,
              const float* ogeo, int VT, int G, int M, int Ms, int B, int nb,
              int T, int smem, unsigned ctas, float* bm_out, float* bp_out,
              cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      grid_body_kernel<kCtas, kMode, kZ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(grid_body_kernel<kCtas, kMode, kZ>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const int vec =
      (M % 4 == 0 && aligned16(y_b) && (!kZ || aligned16(z_b)) ? kVecY
                                                               : 0) |
      (B % 4 == 0 && aligned16(ggt_b) ? kVecG : 0) |
      (B % 2 == 0 && aligned16(coef_b) ? kVecC : 0) |
      (B % 4 == 0 && aligned16(table) ? kVecT : 0) |
      (G % 4 == 0 && aligned16(w) ? kVecW : 0) |
      (M % 4 == 0 && aligned16(bp_in) && aligned16(bp_out) ? kVecX : 0);
  grid_body_kernel<kCtas, kMode, kZ><<<ctas, kThreads, smem, stream>>>(
      bm_in, bp_in, w, table, y_b, z_b, ggt_b, coef_b, pgeo, ogeo, VT, G, M,
      Ms, B, nb, T, vec, bm_out, bp_out);
  return (int)cudaGetLastError();
}

// The instantiation for `mode`, or nullptr for an unknown mode.
template <int kCtas>
decltype(&launch_as<kCtas, efa_mma::kIeee>) launcher(int mode) {
  switch (mode) {
    case efa_mma::kIeee: return &launch_as<kCtas, efa_mma::kIeee>;
    case efa_mma::kTf32: return &launch_as<kCtas, efa_mma::kTf32>;
    case efa_mma::kBf16: return &launch_as<kCtas, efa_mma::kBf16>;
    default: return nullptr;
  }
}

// The kernel of `mode` for kCtas CTAs per SM (a valid mode).
template <int kCtas>
const void* kernel_of(int mode) {
  if (mode == efa_mma::kTf32)
    return (const void*)grid_body_kernel<kCtas, efa_mma::kTf32, false>;
  if (mode == efa_mma::kBf16)
    return (const void*)grid_body_kernel<kCtas, efa_mma::kBf16, false>;
  return (const void*)grid_body_kernel<kCtas, efa_mma::kIeee, false>;
}

// Ms: members a slice (M, or a multiple of 32 below it).  The weights come
// from w or from the geometry (pgeo and ogeo), never both.
int launch(const float* bm_in, const float* bp_in, const float* w,
           const float* table, const float* y_b, const float* z_b,
           const float* ggt_b, const float* coef_b, const float* pgeo,
           const float* ogeo, int VT, int G, int M, int Ms, int B, int nb,
           int T, int mode, float* bm_out, float* bp_out, void* stream) {
  if ((T != 32 && T != 64) || VT <= 0 || G <= 0 || M <= 0 || B <= 0 ||
      nb <= 0 || nb > 0x7fffffff / ((B + kPanel - 1) / kPanel) || Ms <= 0 ||
      Ms > M || (Ms < M && Ms % 32 != 0) || (!pgeo != !ogeo) ||
      (w && pgeo))
    return (int)cudaErrorInvalidValue;
  // bf16: Y arrives as rows of round16(M) bf16 values, copied 16 bytes at a
  // time.
  if (mode == efa_mma::kBf16 && !aligned16(y_b))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(float) * layout_of(T, B, Ms, mode).total;
  const long ctas = (long)VT * ((G + T - 1) / T);
  if (ctas > 0x7fffffffL) return (int)cudaErrorInvalidConfiguration;
  if (z_b) {  // B4e: fp32 only
    if (mode != efa_mma::kIeee) return (int)cudaErrorInvalidValue;
    const auto run = ctas_per_sm(smem) >= 3
                         ? &launch_as<3, efa_mma::kIeee, true>
                         : &launch_as<2, efa_mma::kIeee, true>;
    return run(bm_in, bp_in, w, table, y_b, z_b, ggt_b, coef_b, pgeo, ogeo,
               VT, G, M, Ms, B, nb, T, smem, (unsigned)ctas, bm_out, bp_out,
               (cudaStream_t)stream);
  }
  const auto run =
      ctas_per_sm(smem) >= 3 ? launcher<3>(mode) : launcher<2>(mode);
  if (!run) return (int)cudaErrorInvalidValue;
  return run(bm_in, bp_in, w, table, y_b, nullptr, ggt_b, coef_b, pgeo, ogeo,
             VT, G, M, Ms, B, nb, T, smem, (unsigned)ctas, bm_out, bp_out,
             (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// Every entry behind one: nb blocks in one launch (B3; B4 over the
// sub-blocks of its block), B4e with z_b; Ms members a slice (M:
// unsliced).  T: grid points per CTA (32 or 64).  mode: 0 fp32 FMA, 1
// TF32, 2 bf16 tensor cores for D0 and the apply (B4e: 0).  pgeo [3, G]
// and ogeo [nb, 4, B] in place of w: B4's exact haversine weights
// computed in the kernel.
int efa_grid_launch(const float* bm_in, const float* bp_in, const float* w,
                    const float* table, const float* y_b, const float* z_b,
                    const float* ggt_b, const float* coef_b,
                    const float* pgeo, const float* ogeo, int VT, int G,
                    int M, int Ms, int B, int nb, int T, int mode,
                    float* bm_out, float* bp_out, void* stream) {
  return launch(bm_in, bp_in, w, table, y_b, z_b, ggt_b, coef_b, pgeo, ogeo,
                VT, G, M, Ms, B, nb, T, mode, bm_out, bp_out, stream);
}

// The version of the entries' C signatures, so that a build of another
// commit's source can be bound right: 3 is efa_grid_launch with the
// geometry pointers after coef_b; 2 was it without them; 1 had
// efa_grid_body (B3) and efa_block_apply (B4, one block), the product
// mode before the outputs.  A source without this entry predates the
// modes.
int efa_grid_abi() { return 3; }

// CTAs of the kernel in product mode `mode` that the card holds on one SM
// at this shape (by the occupancy calculator, registers and shared memory
// included), or minus a cudaError_t.
int efa_grid_ctas_per_sm(int M, int B, int T, int mode) {
  if ((T != 32 && T != 64) || M <= 0 || B <= 0 || mode < efa_mma::kIeee ||
      mode > efa_mma::kBf16)
    return -(int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(float) * layout_of(T, B, M, mode).total;
  const bool three = ctas_per_sm(smem) >= 3;
  const void* fn = three ? kernel_of<3>(mode) : kernel_of<2>(mode);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads, smem);
  return e == cudaSuccess ? n : -(int)e;
}

}  // extern "C"
