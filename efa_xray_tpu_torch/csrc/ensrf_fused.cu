// B2: the fused EnSRF body.  Every observation block is applied to a tile
// of state rows while the tile stays on chip, so the state crosses device
// memory once per update.  B2h is its hybrid instantiation (template flag
// kHybrid): the static background column rides the same recurrence.
//
// Replaces: efa_xray_tpu/ops/ensrf_pallas_fused.py, _make_fused_kernel
// (launched by _fused_impl), with its helpers _asin2_poly_u, _arccos_poly
// and _gc_poly; B2h its hybrid branch (hybrid=True).
//
// What it computes, for a tile of rows X [T, M] (perturbations) and xm [T]
// (mean), for each block of B pre-solved obs with rows Y [B, M]:
//   D0 = X Y^T                                   (d0[j, r] = Y_j . X_r)
//   w[j, r] = GC(dist(ob j, row r) / radius_j) (x vertical GC)  or 1
//   u_j = w_j o (d0_j - sum_{i<j} ggt[j, i] u_i),  ggt[j, i] = (y_i . y_j) g_i
//   xm += U^T gain;  X -= (g o U)^T Y
// where the angle is the series form sqrt(s) p(s) (radii <= 5000 km) or the
// half-angle arccos form, exactly as the Pallas kernel chooses (B2e: the
// chordal form of observation/localization.py chordal_gc_weights, the
// polynomial arccos of the dot itself, which the JAX package's EnKF body
// evaluates).  Cull bits,
// one int32 per (row tile, block) with bit q for the q-th 8-ob panel, skip
// pairs whose weights are provably zero; skipping them is exact.
//
// B2h adds, per ob j and row r, the static column s_j = sigma_r GC(dist /
// static_length) at the same chordal angle (computed even when
// unlocalized), and then
//   v_j = g_j u_j + ss_j s_j,  corrections against V with the RAW Gram,
//   xm += sum_j (gain_j u_j + sg_j s_j)  (accumulated as the columns solve),
//   X -= V^T Y.
// Its wrapper culls at max(radius, static_length), so a skipped panel has
// zero static columns too.  A padded ob (gain = g = sg = ss = 0) stays an
// exact no-op: its v column is 0 and it adds 0 to the mean.
//
// B2e, the stochastic EnKF's instantiation (template flag kZ, fp32 only),
// has no TPU kernel (the JAX package runs the EnKF's body in plain XLA,
// efa_xray_tpu/assimilation/ensrf_core.py apply_obs_block with
// apply_rows).  It takes a second row operand, the departure rows Z [B, M]
// (z_j = ye_j - eps_j): D0 still reads Y, the wrapper's ggt is (z_i . y_j)
// g_i, and the apply is X -= (g o U)^T Z.  Z is copied into the Y buffer
// once D0 has read Y, under the panels' solve, so B2e needs no more shared
// memory than B2 and keeps its tile and cull bits.
//
// What bounds it on an H100: with plain fp32 FMA, arithmetic.  Per alive
// 8-ob panel of an alive (tile, block) the two products take 2 x 8 T M FMAs
// and the substitution 8 T x (obs of the alive panels before it); the weight
// chain is ~40 operations per (ob, row) pair.  The state itself is read once
// and written once; Y, the ggt tables and the per-ob table (a few MB in all)
// are re-read by every CTA from the 50 MB L2.  A kernel only gets near the
// FMA rate if each shared-memory load feeds many FMAs (the SM loads 32 words
// a clock and does 128 FMAs), if dead panels cost nothing, and if the
// reloads run under the arithmetic.
//
// What the design does about it.  A CTA of 256 threads owns T rows and loops
// over the alive blocks itself: 32 rows where two such CTAs fit an SM (80
// members: ~101 KB each), so that one CTA's arithmetic covers the other's
// waits and the cull bound, taken at the tile, is finer; else 64 rows, or
// 32 where 64 overflow (256 members).  The wrapper picks.
// 1. Register tiles.  D0: a thread owns 4 rows x 4 obs and reads X and Y as
//    float4 along the members (8 16-byte loads per 64 FMAs).  Apply: a
//    thread owns 4 rows x NC members (NC = 2, 4, 5, 8 or 16 by the ensemble
//    size; member c + 16 i), reads one float4 of the U column and NC words
//    of Y per ob (6 loads per 20 FMAs at 80 members).  X and Y rows are
//    padded to 4 x odd words, and each Y panel is shifted by 4 more words,
//    so that those loads spread over the banks.
// 2. The cross-panel correction of panel q, G[panel q, :base] U[:base, T],
//    is a product too: the alive panels before q are dealt over the warps
//    (a split of the reduction), a thread owns 8 obs x 2 rows (12 loads per
//    64 FMAs), the partial sums meet in shared memory and the pass that
//    computes the panel's weights adds them up.  Only the 8 x 8 triangle
//    inside the panel runs one thread per row, from registers (dealing it
//    over 8 lanes a row by shuffle was measured and lost 7-17%: the kernel
//    is bound by instruction throughput, not by that chain's latency).
//    The mean increment is accumulated in that chain (both instantiations).
// 3. Dead panels cost nothing: from the block's bits word the CTA lists its
//    alive panels once; D0, the corrections, the solve and the apply run
//    over that list only.  That is exact: a dead panel's u (and v) column is
//    exactly 0, so it adds nothing to later corrections, to the mean or to
//    X.  Obs past the end of the last block's last panel have zero Y rows
//    and are never solved, so they too add exactly 0.
// 4. Reloads run under arithmetic.  ggt is never resident: the 8 rows of
//    the next alive panel stream into a two-slot ring (cp.async) while this
//    panel solves.  Y and the table of the next alive block are fetched with
//    cp.async too, into the one buffer, once this block's apply has read it;
//    with two CTAs on the SM the other one computes meanwhile.  Measured at
//    80 members, the two CTAs of 32 rows beat one CTA of 64 rows by ~10%.
//    (A second Y/table buffer for the 64-row CTA, prefetched in one commit
//    group with the first ggt panel, was measured at under 1% and is not
//    kept.)
// kHybrid is a template parameter, so the pure instantiation carries none of
// the static column.  Rows past the end of the state (the ragged last tile)
// are zero and never written.
//
// The two large products, D0 and the apply, run in one of three modes, the
// template parameter kMode (ops/precision.py product_mode): fp32 FMA (the
// register tiles above), or TF32 or bf16 tensor cores (mma_modes.cuh),
// each operand rounded once where fused_apply_plain rounds it: Y by the
// wrapper (y_b arrives rounded), X in D0's registers (D0 runs transposed,
// a warp per 8 rows over the alive panels), g o U (B2h: V) in place in U
// after the substitution.  The corrections, the weights, the 8 x 8
// triangle and the mean are fp32 in every mode.  The mode layout
// (make_mode_layout) is the fp32 one with U's rows T + 4 words apart and
// the X and Y rows at least the staged K wide.
//
// Any ensemble and any block (the two levers; ops/ensrf_fused.py plan
// picks, the same at every shape whose layout fits as before).  The
// layout holds X [T, M] and the block's rows [B, M], so it grows with both.
// 1. Sub-blocks: a block over what fits is handed over as several blocks
//    of fewer obs (the wrapper cuts y_b, the ggt tables' diagonal blocks,
//    the table and the cull bits), swept in order by this launch.  That is
//    exact: a sub-block's D0 reads the X the sub-blocks before it left,
//    which is what the corrections against their obs would subtract.
// 2. Member slices (Ms < M): X stays in bp_out and each pass over the
//    members (D0, then the apply) stages one slice of Ms members of X and
//    of the block's rows at a time, D0 summing over the slices in order
//    (on the tensor cores a slice is a K range of D0 and an N range of the
//    apply).  The substitution reads only D0, ggt and the table, so it is
//    the same.  The state crosses device memory three times a block
//    instead of twice an update, and the staging copies are synchronous.
//
// Shared memory (floats; make_layout below, mirrored by ops/ensrf_fused.py
// smem_bytes, with M the slice Ms): X [T, Ys], Y [Bp Ys + Bp / 2], U [Bp,
// T], partial sums [16 x 256], ggt ring [2][8, Bp], weights [8, T] (B2h: +
// static columns [8, T]), table [kTab B], geometry [kGeo, T], mean [T],
// mean increment [T], alive-panel lists [2][Bp / 8]; Ys = 4 (ceil(M / 4) |
// 1), Bp = B rounded up to 8.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_modes.cuh"

namespace {

// Parts of the tensor-core modes that a build with -DEFA_FUSED_SKIP=<bits>
// leaves out, to time what each costs (no profiler sees inside a kernel
// here): the results of such a build are wrong.  0 in every build that is
// used; the fp32 mode has no such switch.
#ifndef EFA_FUSED_SKIP
#define EFA_FUSED_SKIP 0
#endif
constexpr int kSkipD0 = 1, kSkipApply = 2, kSkipRound = 4;
__host__ __device__ constexpr bool skips(int part) {
  return (EFA_FUSED_SKIP & part) != 0;
}

constexpr int kThreads = 256;
constexpr int kPanel = 8;
constexpr float kEarthRadiusKm = 6371.0f;
// Rows of the per-ob table: gain, sqrt_coef, ob unit vector x/y/z,
// 1/radius (0 = unlocalized), ob vertical coordinate, 1/vertical radius;
// B2h appends the static gain and sqrt scalars and 1/static_length.
constexpr int kTabPure = 8;
constexpr int kTabHybrid = 11;

__device__ __forceinline__ float gc_exact(float r) {
  const float inner =
      ((((-0.25f * r + 0.5f) * r + 0.625f) * r - 5.0f / 3.0f) * (r * r)) +
      1.0f;
  const float rs = fmaxf(r, 1e-12f);
  const float outer =
      ((((r / 12.0f - 0.5f) * r + 0.625f) * r + 5.0f / 3.0f) * r - 5.0f) * r +
      4.0f - 2.0f / (3.0f * rs);
  return r <= 1.0f ? inner : (r < 2.0f ? outer : 0.0f);
}

// Outer branch as the degree-7 fit centred at r = 1.5 (series angle form).
__device__ __forceinline__ float gc_poly(float r) {
  const float inner =
      ((((-0.25f * r + 0.5f) * r + 0.625f) * r - 5.0f / 3.0f) * (r * r)) +
      1.0f;
  const float t = r - 1.5f;
  float outer = 0.0332721029f;
  outer = outer * t + -0.0484752690f;
  outer = outer * t + 0.1405191778f;
  outer = outer * t + 0.0386425652f;
  outer = outer * t + -0.3682243569f;
  outer = outer * t + 0.3440689601f;
  outer = outer * t + -0.1255802356f;
  outer = outer * t + 0.0164935268f;
  return r <= 1.0f ? inner : (r < 2.0f ? outer : 0.0f);
}

// 2 asin(s) / s as a polynomial in u = s^2 (radii <= 5000 km).
__device__ __forceinline__ float asin2_poly(float u) {
  float p = 0.1920979908f;
  p = p * u + -0.0963332506f;
  p = p * u + 0.1146914397f;
  p = p * u + 0.0793335722f;
  p = p * u + 0.1508451291f;
  p = p * u + 0.3333070474f;
  p = p * u + 2.0000001309f;
  return p;
}

// Abramowitz & Stegun 4.4.46 arccos for x in [0, 1].
__device__ __forceinline__ float arccos_poly(float x) {
  float p = -0.0012624911f;
  p = p * x + 0.0066700901f;
  p = p * x + -0.0170881256f;
  p = p * x + 0.0308918810f;
  p = p * x + -0.0501743046f;
  p = p * x + 0.0889789874f;
  p = p * x + -0.2145988016f;
  p = p * x + 1.5707963050f;
  return sqrtf(fmaxf(1.0f - x, 0.0f)) * p;
}

// The angle forms (`series`): the half-angle arccos, the series (radii <=
// 5000 km), and the chordal form (B2e).
constexpr int kArccosForm = 0, kSeriesForm = 1, kChordalForm = 2;

// Great-circle distance (km) from ob j to row r, by the chordal angle.
__device__ __forceinline__ float chord_dist(const float* tab, int B, int j,
                                            const float* geo, int T, int r,
                                            int series) {
  const float ox = tab[2 * B + j], oy = tab[3 * B + j], oz = tab[4 * B + j];
  float dot = ox * geo[r] + oy * geo[T + r] + oz * geo[2 * T + r];
  dot = fminf(fmaxf(dot, -1.0f), 1.0f);
  float ang;
  if (series == kChordalForm) {
    const float a = arccos_poly(fabsf(dot));
    ang = dot >= 0.0f ? a : 3.14159265358979f - a;
  } else if (series == kSeriesForm) {
    const float su = (1.0f - dot) * 0.5f;
    ang = sqrtf(su) * asin2_poly(su);
  } else {
    const float c = fminf(fmaxf((1.0f + dot) * 0.5f, 0.0f), 1.0f);
    ang = 2.0f * arccos_poly(sqrtf(c));
  }
  return kEarthRadiusKm * ang;
}

__device__ __forceinline__ float loc_weight(const float* tab, int B, int j,
                                            const float* geo, int T, int r,
                                            float dist, int vertical,
                                            int series) {
  const float invrad = tab[5 * B + j];
  const float rr = dist * invrad;
  float w = invrad > 0.0f
                ? (series == kSeriesForm ? gc_poly(rr) : gc_exact(rr))
                : 1.0f;
  if (vertical) {
    const float ivr = tab[7 * B + j];
    const float rv = fabsf(geo[3 * T + r] - tab[6 * B + j]) * ivr;
    w *= ivr > 0.0f ? gc_exact(rv) : 1.0f;
  }
  return w;
}


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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copies n floats; by 16 bytes when vec (n a multiple of 4, both aligned).
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int n, bool vec, int tid,
                                           int nth) {
  if (vec) {
    for (int i = tid; i < (n >> 2); i += nth)
      cp_async16(dst + 4 * i, src + 4 * i);
  } else {
    for (int i = tid; i < n; i += nth) cp_async4(dst + i, src + i);
  }
}

// Which operands may be copied 16 bytes at a time.
constexpr int kVecY = 1, kVecTab = 2, kVecG = 4;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Offsets (floats) of the arrays in dynamic shared memory.
struct Layout {
  int Ys, Bp, ysz, tabsz;
  int x, y, u, scr, g, wb, sb, tab, geo, xm, macc, plist, total;
};

__host__ __device__ inline Layout make_layout(int T, int B, int M,
                                              bool hybrid) {
  Layout L;
  L.Ys = 4 * (((M + 3) >> 2) | 1);
  L.Bp = (B + kPanel - 1) / kPanel * kPanel;
  L.ysz = L.Bp * L.Ys + 4 * (L.Bp / kPanel);
  L.tabsz = round4((hybrid ? kTabHybrid : kTabPure) * B);
  int o = 0;
  L.x = o, o += T * L.Ys;
  L.y = o, o += L.ysz;
  L.u = o, o += L.Bp * T;
  L.scr = o, o += 16 * kThreads;
  L.g = o, o += 2 * kPanel * L.Bp;
  L.wb = o, o += kPanel * T;
  L.sb = o, o += hybrid ? kPanel * T : 0;
  L.tab = o, o += L.tabsz;
  L.geo = o, o += (hybrid ? 5 : 4) * T;
  L.xm = o, o += T;
  L.macc = o, o += T;
  L.plist = o, o += round4(2 * (L.Bp / kPanel));
  L.total = o;
  return L;
}

// The layout of the tensor-core modes (mma_modes.cuh): the fp32 one with
// U's rows T + 4 words apart and the X and Y rows at least the staged K.
__host__ __device__ inline Layout make_mode_layout(int T, int B, int M,
                                                   bool hybrid, int mode) {
  Layout L;
  L.Ys = efa_mma::mode_row_stride(mode, M);
  L.Bp = (B + kPanel - 1) / kPanel * kPanel;
  L.ysz = L.Bp * L.Ys + 4 * (L.Bp / kPanel);
  L.tabsz = round4((hybrid ? kTabHybrid : kTabPure) * B);
  int o = 0;
  L.x = o, o += T * L.Ys;
  L.y = o, o += L.ysz;
  L.u = o, o += L.Bp * efa_mma::u_stride(mode, T);
  L.scr = o, o += 16 * kThreads;
  L.g = o, o += 2 * kPanel * L.Bp;
  L.wb = o, o += kPanel * T;
  L.sb = o, o += hybrid ? kPanel * T : 0;
  L.tab = o, o += L.tabsz;
  L.geo = o, o += (hybrid ? 5 : 4) * T;
  L.xm = o, o += T;
  L.macc = o, o += T;
  L.plist = o, o += round4(2 * (L.Bp / kPanel));
  L.total = o;
  return L;
}

// Row j of the Y buffer: rows are Ys apart and every panel of 8 starts 4
// words later than the rows alone would put it, so that the rows of
// different panels that a warp reads at once in D0 fall into different
// banks.
__device__ __forceinline__ int yrow(int j, int Ys) {
  return j * Ys + 4 * (j >> 3);
}

// X[4 rows, NC members per thread] -= sum over the alive obs of u_j y_j.
template <int NC>
__device__ __forceinline__ void apply_tiles(float* Xs, const float* Ysm,
                                            const float* U, const int* pl,
                                            int na, int T, int Ys, int Mp,
                                            int tid, int nth) {
  for (int task = tid; task < (T >> 2) * 16; task += nth) {
    const int cg = task & 15, rg = task >> 4;
    for (int c0 = 0; c0 < Mp; c0 += 16 * NC) {
      float acc[4][NC];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[rr][i] = 0.0f;
      for (int a = 0; a < na; ++a) {
        const int jb = kPanel * pl[a];
        const float* yp = Ysm + yrow(jb, Ys) + c0 + cg;
        const float* up = U + jb * T + 4 * rg;
#pragma unroll
        for (int t = 0; t < kPanel; ++t) {
          const float4 u = *reinterpret_cast<const float4*>(up + t * T);
          float yv[NC];
#pragma unroll
          for (int i = 0; i < NC; ++i) yv[i] = yp[t * Ys + 16 * i];
#pragma unroll
          for (int i = 0; i < NC; ++i) {
            acc[0][i] = fmaf(u.x, yv[i], acc[0][i]);
            acc[1][i] = fmaf(u.y, yv[i], acc[1][i]);
            acc[2][i] = fmaf(u.z, yv[i], acc[2][i]);
            acc[3][i] = fmaf(u.w, yv[i], acc[3][i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = c0 + cg + 16 * i;
        if (c < Mp) {
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
            Xs[(4 * rg + rr) * Ys + c] -= acc[rr][i];
        }
      }
    }
  }
}

// bm_out/bp_out may alias bm_in/bp_in (in-place update): a CTA reads its
// own rows before the block loop and writes only those rows after it.
// kMode: the two large products' mode (efa_mma::kIeee, kTf32, kBf16).
// kZ: B2e (fp32, pure ensemble), the apply reads z_b instead of y_b.
// Ms: the members staged at a time (M: all, X resident for the launch).
template <bool kHybrid, int kMode, bool kZ>
__global__ void __launch_bounds__(kThreads) fused_body_kernel(
    const float* bm_in,  // [N]
    const float* bp_in,  // [N, M]
    const float* __restrict__ geom,   // [kGeo, N]: unit x, y, z, vertical
                                      // (, sigma for B2h)
    const float* __restrict__ y_b,    // [nb, B, M]
    const float* __restrict__ z_b,    // [nb, B, M] B2e, else nullptr
    const float* __restrict__ ggt_b,  // [nb, B, B]; B2h: the raw Gram
    const float* __restrict__ tab_b,  // [nb, kTab, B]
    const int* __restrict__ bits,     // [gtiles, nb] or nullptr (no cull)
    int N, int M, int Ms, int B, int nb, int T, int vec, int localize,
    int vertical, int series, float* bm_out, float* bp_out) {
  constexpr int kTab = kHybrid ? kTabHybrid : kTabPure;
  constexpr int kGeo = kHybrid ? 5 : 4;
  extern __shared__ __align__(16) float smem[];
  const Layout L = kMode == efa_mma::kIeee
                       ? make_layout(T, B, Ms, kHybrid)
                       : make_mode_layout(T, B, Ms, kHybrid, kMode);
  const int Ys = L.Ys, Bp = L.Bp;
  // Member slices: X lives in bp_out, a slice at a time in Xs.
  const bool sliced = Ms < M;
  const int nslice = (M + Ms - 1) / Ms;
  float* Xs = smem + L.x;      // [T, Ys]
  float* Ysm = smem + L.y;     // [Bp rows, skewed]
  float* U = smem + L.u;       // [Bp, T]  d0 columns, then u (B2h: v)
  float* scr = smem + L.scr;   // [slices, kPanel, T] partial corrections
  float* Gr = smem + L.g;      // [2][kPanel, Bp] ggt rows of a panel
  float* Wb = smem + L.wb;     // [kPanel, T]
  float* Sb = smem + L.sb;     // B2h: [kPanel, T] static columns
  float* tab = smem + L.tab;   // [kTab, B]
  float* geo = smem + L.geo;   // [kGeo, T]
  float* xm = smem + L.xm;     // [T]
  float* macc = smem + L.macc; // [T] mean increment of the block
  int* plist = reinterpret_cast<int*>(smem + L.plist);  // [2][npanels]
  // U's row stride: T, or T + 4 in the tensor-core modes (mma_modes.cuh).
  const int Us = efa_mma::u_stride(kMode, T);

  const int tid = threadIdx.x;
  const int nth = kThreads;
  const int tile = blockIdx.x;
  const long r0 = (long)tile * T;
  const int nrows = (int)min((long)T, (long)N - r0);
  const int npanels = Bp / kPanel;
  const int tsh = T == 64 ? 6 : 5;  // T is 32 or 64 (the launcher checks)

  // Zero everything once: the pad columns of X and Y, the Y rows past B and
  // the rows of the ragged last tile are never written again.
  for (int idx = tid; idx < (L.total >> 2); idx += nth)
    reinterpret_cast<float4*>(smem)[idx] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  if (!sliced) {
    for (int idx = tid; idx < nrows * M; idx += nth) {
      const int r = idx / M, m = idx - r * M;
      Xs[r * Ys + m] = bp_in[(r0 + r) * M + m];
    }
  } else if (bp_out != bp_in) {
    for (long idx = tid; idx < (long)nrows * M; idx += nth)
      bp_out[r0 * M + idx] = bp_in[r0 * M + idx];
  }
  for (int r = tid; r < nrows; r += nth) {
    xm[r] = bm_in[r0 + r];
    for (int c = 0; c < kGeo; ++c) geo[c * T + r] = geom[(long)c * N + r0 + r];
  }
  const int lane = tid & 31, warp = tid >> 5, nwarps = nth >> 5;

  // The block's alive-panel word (all ones without a cull).
  const unsigned pmask = npanels >= 32 ? 0xFFFFFFFFu : (1u << npanels) - 1u;
  auto block_bits = [&](int b) -> unsigned {
    return bits ? (unsigned)bits[(long)tile * nb + b] & pmask : 0xFFFFFFFFu;
  };
  auto next_alive = [&](int b) {
    while (b < nb && block_bits(b) == 0u) ++b;
    return b;
  };
  // Rows [B, M] of block b of `src` (y_b, or B2e's z_b) into the Y buffer,
  // asynchronously.
  auto fetch_rows = [&](const float* src, int b) {
    const float* yb = src + (long)b * B * M;
    if (vec & kVecY) {
      const int c4 = M >> 2;
      for (int idx = tid; idx < B * c4; idx += nth) {
        const int j = idx / c4, c = idx - j * c4;
        cp_async16(Ysm + yrow(j, Ys) + 4 * c, yb + (long)j * M + 4 * c);
      }
    } else {
      for (int idx = tid; idx < B * M; idx += nth) {
        const int j = idx / M, c = idx - j * M;
        cp_async4(Ysm + yrow(j, Ys) + c, yb + (long)j * M + c);
      }
    }
  };
  // Y (unless sliced: stage does) and the table of block b,
  // asynchronously.
  auto fetch = [&](int b) {
    if (!sliced) {
      if constexpr (kMode == efa_mma::kBf16) {
        // Rows of round16(M) bf16 values from the wrapper: whole 16 bytes.
        const int kw = efa_mma::staged_words(kMode, M), c4 = kw >> 2;
        const float* yw = y_b + (long)b * B * kw;
        for (int idx = tid; idx < B * c4; idx += nth) {
          const int j = idx / c4, c = idx - j * c4;
          cp_async16(Ysm + yrow(j, Ys) + 4 * c, yw + (long)j * kw + 4 * c);
        }
      } else {
        fetch_rows(y_b, b);
      }
    }
    copy_async(tab, tab_b + (long)b * kTab * B, kTab * B,
               vec & kVecTab, tid, nth);
  };
  // Member slice s: X's rows from bp_out and block b's rows of `src` (y_b,
  // or B2e's z_b), synchronously, zero past the slice's end up to the
  // columns the products read.  Returns the slice's members.
  auto stage = [&](int s, const float* src, int b) {
    const int m0 = s * Ms, msz = min(Ms, M - m0);
    const int kc = kMode == efa_mma::kIeee
                       ? round4(msz)
                       : efa_mma::staged_values(kMode, msz);
    for (int idx = tid; idx < T * kc; idx += nth) {
      const int r = idx / kc, c = idx - r * kc;
      Xs[r * Ys + c] =
          r < nrows && c < msz ? bp_out[(r0 + r) * M + m0 + c] : 0.f;
    }
    if constexpr (kMode == efa_mma::kBf16) {
      // The wrapper's rows are zero from M to round16(M); m0 is even.
      const int kw = efa_mma::staged_words(kMode, M);
      const int sw = efa_mma::staged_words(kMode, msz);
      const float* yw = src + (long)b * B * kw + m0 / 2;
      for (int idx = tid; idx < B * sw; idx += nth) {
        const int j = idx / sw, c = idx - j * sw;
        Ysm[yrow(j, Ys) + c] = yw[(long)j * kw + c];
      }
    } else {
      const float* yb = src + (long)b * B * M + m0;
      for (int idx = tid; idx < B * kc; idx += nth) {
        const int j = idx / kc, c = idx - j * kc;
        Ysm[yrow(j, Ys) + c] = c < msz ? yb[(long)j * M + c] : 0.f;
      }
    }
    return msz;
  };
  // Member slice s of X back to bp_out.
  auto store = [&](int s, int msz) {
    const int m0 = s * Ms;
    for (int idx = tid; idx < nrows * msz; idx += nth) {
      const int r = idx / msz, c = idx - r * msz;
      bp_out[(r0 + r) * M + m0 + c] = Xs[r * Ys + c];
    }
  };
  // Rows of panel q of block b's ggt, columns up to the panel's end, into
  // ring slot `slot`, asynchronously.
  auto fetch_g = [&](int b, int q, int slot) {
    const int base = q * kPanel;
    const int width = min(kPanel, B - base), ncol = base + width;
    const float* gb = ggt_b + (long)b * B * B + (long)base * B;
    float* gd = Gr + slot * kPanel * Bp;
    if (vec & kVecG) {
      const int c4 = ncol >> 2;
      for (int idx = tid; idx < width * c4; idx += nth) {
        const int t = idx / c4, c = idx - t * c4;
        cp_async16(gd + t * Bp + 4 * c, gb + (long)t * B + 4 * c);
      }
    } else {
      for (int idx = tid; idx < width * ncol; idx += nth) {
        const int t = idx / ncol, c = idx - t * ncol;
        cp_async4(gd + t * Bp + c, gb + (long)t * B + c);
      }
    }
  };

  const int RG = T >> 2, rgsh = tsh - 2;  // D0: groups of 4 rows
  const int RT = T >> 4;                  // tensor-core tiles of 16 rows
  const int half = T >> 1;                // corrections: pairs of rows
  const int KS = nth / half;              // slices of the reduction
  const int ks = tid / half, rp = tid - ks * half;

  int b = next_alive(0);
  int par = 0;
  if (b < nb) fetch(b);
  cp_async_commit();
  while (b < nb) {
    const unsigned bw = block_bits(b);
    const int nxt = next_alive(b + 1);
    int* pl = plist + par * npanels;
    // The alive panels of this block, in order.
    const int na = bits ? __popc(bw) : npanels;
    for (int q = tid; q < npanels; q += nth) {
      if (!bits)
        pl[q] = q;
      else if ((bw >> q) & 1u)
        pl[__popc(bw & ((1u << q) - 1u))] = q;
    }
    cp_async_wait_all();
    // This block's Y and table have landed, every thread has left the
    // block before, and the list is written.
    __syncthreads();
    fetch_g(b, pl[0], 0);
    cp_async_commit();
    if (tid < T) macc[tid] = 0.0f;

    // D0 = X Y^T over the alive panels: 4 rows x 4 obs per thread, or on
    // the tensor cores a warp per 8 rows over every alive panel; slice by
    // slice of the members where sliced, each adding to the last.
    for (int sl = 0; sl < nslice; ++sl) {
      const int msz = sliced ? stage(sl, y_b, b) : M;
      if (sliced) __syncthreads();
      const int Mp = round4(msz);
      if constexpr (kMode != efa_mma::kIeee) {
        if (warp < (T >> 3) && !skips(kSkipD0))
          efa_mma::d0t_warp<kMode, 12, 4, 2>(
              Xs, Ys, Ysm,
              [pl, Ys](int p, int i) { return yrow(kPanel * pl[p] + i, Ys); },
              [pl](int p) { return kPanel * pl[p]; }, na,
              efa_mma::staged_words(kMode, msz) * 4 / efa_mma::kStepBytes, U,
              Us, 8 * warp, lane, sl > 0);
      }
      for (int task = tid; kMode == efa_mma::kIeee && task < RG * 2 * na;
           task += nth) {
        const int rgi = task & (RG - 1), h = task >> rgsh;
        const int j0 = kPanel * pl[h >> 1] + 4 * (h & 1);
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
    cp_async_wait_all();
    __syncthreads();  // D0 is in U; the first panel's ggt rows have landed
    if constexpr (kZ) {
      // D0 has read Y: the apply's rows Z take its place, landing under the
      // first panel's solve (whose wait covers this group too); sliced,
      // the apply stages them.
      if (!sliced) {
        fetch_rows(z_b, b);
        cp_async_commit();
      }
    }

    for (int a = 0; a < na; ++a) {
      const int q = pl[a];
      const int base = q * kPanel;
      const int width = min(kPanel, B - base);
      const float* Gp = Gr + (a & 1) * kPanel * Bp;
      // The correction against the alive panels before this one, G[panel,
      // :base] U[:base, T]: slice ks sums every KS-th of them, 8 obs x 2
      // rows per thread.
      if (ks < a) {
        float acc[kPanel][2];
#pragma unroll
        for (int t = 0; t < kPanel; ++t) acc[t][0] = acc[t][1] = 0.0f;
        for (int e = ks; e < a; e += KS) {
          const int ib = kPanel * pl[e];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i0 = ib + 4 * hh;
            float2 uv[4];
#pragma unroll
            for (int ii = 0; ii < 4; ++ii)
              uv[ii] = *reinterpret_cast<const float2*>(U + (i0 + ii) * Us +
                                                        2 * rp);
#pragma unroll
            for (int t = 0; t < kPanel; ++t) {
              const float4 g =
                  *reinterpret_cast<const float4*>(Gp + t * Bp + i0);
              float s0 = acc[t][0], s1 = acc[t][1];
              s0 = fmaf(g.x, uv[0].x, s0), s1 = fmaf(g.x, uv[0].y, s1);
              s0 = fmaf(g.y, uv[1].x, s0), s1 = fmaf(g.y, uv[1].y, s1);
              s0 = fmaf(g.z, uv[2].x, s0), s1 = fmaf(g.z, uv[2].y, s1);
              s0 = fmaf(g.w, uv[3].x, s0), s1 = fmaf(g.w, uv[3].y, s1);
              acc[t][0] = s0, acc[t][1] = s1;
            }
          }
        }
#pragma unroll
        for (int t = 0; t < kPanel; ++t)
          *reinterpret_cast<float2*>(scr + (ks * kPanel + t) * T + 2 * rp) =
              make_float2(acc[t][0], acc[t][1]);
      }
      __syncthreads();
      // The ring slot of the panel before this one is free: the next alive
      // panel's rows stream in while this panel solves.
      if (a + 1 < na) fetch_g(b, pl[a + 1], (a + 1) & 1);
      cp_async_commit();
      // The partial sums meet; the panel's weights and (B2h) its static
      // columns, in parallel over (ob, row) pairs.
      const int ns = min(a, KS);
      for (int idx = tid; idx < width * T; idx += nth) {
        const int t = idx >> tsh, r = idx & (T - 1);
        const int j = base + t;
        if (ns) {
          float corr = 0.f;
          for (int s = 0; s < ns; ++s) corr += scr[(s * kPanel + t) * T + r];
          U[j * Us + r] -= corr;
        }
        if (localize || kHybrid) {
          const float dist = chord_dist(tab, B, j, geo, T, r, series);
          if (localize)
            Wb[t * T + r] =
                loc_weight(tab, B, j, geo, T, r, dist, vertical, series);
          if (kHybrid)
            Sb[t * T + r] = geo[4 * T + r] * gc_exact(dist * tab[10 * B + j]);
        }
      }
      __syncthreads();
      // The chain inside the panel, one thread per row, the solved columns
      // in registers; the mean increment rides along.
      if (tid < T) {
        const int r = tid;
        float ur[kPanel];
        float mloc = 0.f;
#pragma unroll
        for (int t = 0; t < kPanel; ++t) {
          ur[t] = 0.f;
          if (t < width) {
            const int j = base + t;
            float corr = 0.f;
#pragma unroll
            for (int i = 0; i < t; ++i)
              corr = fmaf(Gp[t * Bp + base + i], ur[i], corr);
            float d = U[j * Us + r] - corr;
            if (localize) d *= Wb[t * T + r];
            if (kHybrid) {
              const float s = Sb[t * T + r];
              mloc += tab[j] * d + tab[8 * B + j] * s;
              d = tab[B + j] * d + tab[9 * B + j] * s;
            } else {
              mloc += tab[j] * d;
            }
            ur[t] = d;
            U[j * Us + r] = d;
          }
        }
        macc[r] += mloc;
      }
      cp_async_wait_all();
      __syncthreads();
    }

    if constexpr (kMode != efa_mma::kIeee) {
      // The apply on the tensor cores: g o U (B2h: V) rounded in place, then
      // X -= U^T Y over the alive panels, a warp per 16 rows x every
      // (8 / RT)-th tile of 8 members.
      const auto ob = [pl](int i) { return kPanel * pl[i >> 3] + (i & 7); };
      if (!skips(kSkipRound))
        efa_mma::round_left<kMode>(
            U, Us, T, kPanel * na, B, ob,
            [tab, B](int j) { return kHybrid ? 1.0f : tab[B + j]; }, tid,
            nth);
      __syncthreads();
      for (int sl = 0; sl < nslice; ++sl) {
        const int msz = sliced ? stage(sl, y_b, b) : M;
        if (sliced) __syncthreads();
        if (!skips(kSkipApply))
          efa_mma::apply_warp<kMode, 4, 2>(
              Xs, Ys, U, [pl, Us](int a, int i) {
                return (kPanel * pl[a] + i) * Us;
              }, Us, Ysm,
              [pl, Ys](int a, int i) { return yrow(kPanel * pl[a] + i, Ys); },
              na, msz, 16 * (warp % RT), warp / RT, nwarps / RT,
              (msz + 7) >> 3, lane);
        if (sliced) {
          __syncthreads();
          store(sl, msz);
          __syncthreads();
        }
      }
    } else {
      if (!kHybrid) {
        // U <- g o U on the alive panels, so that the apply is X -= U^T Y in
        // both instantiations.
        for (int idx = tid; idx < na * kPanel * RG; idx += nth) {
          const int c = idx & (RG - 1), jt = idx >> rgsh;
          const int j = kPanel * pl[jt >> 3] + (jt & 7);
          if (j < B) {
            const float g = tab[B + j];
            float4* p = reinterpret_cast<float4*>(U + j * T + 4 * c);
            float4 v = *p;
            v.x *= g, v.y *= g, v.z *= g, v.w *= g;
            *p = v;
          }
        }
        __syncthreads();
      }
      for (int sl = 0; sl < nslice; ++sl) {
        const int msz = sliced ? stage(sl, kZ ? z_b : y_b, b) : M;
        if (sliced) __syncthreads();
        const int Mp = round4(msz);
        if (Mp <= 32)
          apply_tiles<2>(Xs, Ysm, U, pl, na, T, Ys, Mp, tid, nth);
        else if (Mp <= 64)
          apply_tiles<4>(Xs, Ysm, U, pl, na, T, Ys, Mp, tid, nth);
        else if (Mp <= 80)
          apply_tiles<5>(Xs, Ysm, U, pl, na, T, Ys, Mp, tid, nth);
        else if (Mp <= 128)
          apply_tiles<8>(Xs, Ysm, U, pl, na, T, Ys, Mp, tid, nth);
        else
          apply_tiles<16>(Xs, Ysm, U, pl, na, T, Ys, Mp, tid, nth);
        if (sliced) {
          __syncthreads();
          store(sl, msz);
          __syncthreads();
        }
      }
    }
    if (tid < T) xm[tid] += macc[tid];

    if (nxt < nb) {
      __syncthreads();  // the Y buffer is free only now
      fetch(nxt);
    }
    cp_async_commit();
    par ^= 1;
    b = nxt;
  }
  cp_async_wait_all();
  __syncthreads();

  for (int idx = tid; !sliced && idx < nrows * M; idx += nth) {
    const int r = idx / M, m = idx - r * M;
    bp_out[(r0 + r) * M + m] = Xs[r * Ys + m];
  }
  for (int r = tid; r < nrows; r += nth) bm_out[r0 + r] = xm[r];
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Ms: members a slice (M, or a multiple of 32 below it).
template <bool kHybrid, int kMode, bool kZ = false>
int launch(const float* bm_in, const float* bp_in, const float* geom,
           const float* y_b, const float* z_b, const float* ggt_b,
           const float* tab_b, const int* bits, int N, int M, int Ms, int B,
           int nb, int T, int localize, int vertical, int series,
           float* bm_out, float* bp_out, cudaStream_t stream) {
  const int npanels = (B + kPanel - 1) / kPanel;
  if ((T != 32 && T != 64) || N <= 0 || M <= 0 || B <= 0 || nb <= 0 ||
      (bits && npanels > 32) || Ms <= 0 || Ms > M ||
      (Ms < M && Ms % 32 != 0))
    return (int)cudaErrorInvalidValue;
  // bf16: Y arrives as rows of round16(M) bf16 values, copied 16 bytes at a
  // time.
  if (kMode == efa_mma::kBf16 && !aligned16(y_b))
    return (int)cudaErrorInvalidValue;
  const int smem =
      (int)sizeof(float) * (kMode == efa_mma::kIeee
                                ? make_layout(T, B, Ms, kHybrid)
                                : make_mode_layout(T, B, Ms, kHybrid, kMode))
                               .total;
  cudaError_t e = cudaFuncSetAttribute(fused_body_kernel<kHybrid, kMode, kZ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = (M % 4 == 0 && aligned16(y_b) &&
                           (!kZ || aligned16(z_b)) ? kVecY : 0) |
                  (B % 4 == 0 && aligned16(tab_b) ? kVecTab : 0) |
                  (B % 4 == 0 && aligned16(ggt_b) ? kVecG : 0);
  const int tiles = (N + T - 1) / T;
  fused_body_kernel<kHybrid, kMode, kZ><<<tiles, kThreads, smem, stream>>>(
      bm_in, bp_in, geom, y_b, z_b, ggt_b, tab_b, bits, N, M, Ms, B, nb, T,
      vec, localize, vertical, series, bm_out, bp_out);
  return (int)cudaGetLastError();
}

// The instantiation of `mode`, or nullptr for an unknown mode.
template <bool kHybrid>
decltype(&launch<kHybrid, efa_mma::kIeee>) launcher(int mode) {
  switch (mode) {
    case efa_mma::kIeee: return &launch<kHybrid, efa_mma::kIeee>;
    case efa_mma::kTf32: return &launch<kHybrid, efa_mma::kTf32>;
    case efa_mma::kBf16: return &launch<kHybrid, efa_mma::kBf16>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Every instantiation behind one entry: B2 (hybrid 0), B2h (hybrid 1) or,
// with z_b, B2e (fp32, pure); Ms members a slice (M: unsliced).  T: rows
// per CTA (32 or 64).  mode: 0 fp32 FMA, 1 TF32, 2 bf16 tensor cores for
// D0 and the apply.
int efa_fused_launch(const float* bm_in, const float* bp_in,
                     const float* geom, const float* y_b, const float* z_b,
                     const float* ggt_b, const float* tab_b, const int* bits,
                     int N, int M, int Ms, int B, int nb, int T, int localize,
                     int vertical, int series, int hybrid, int mode,
                     float* bm_out, float* bp_out, void* stream) {
  if (z_b) {
    if (hybrid || mode != efa_mma::kIeee) return (int)cudaErrorInvalidValue;
    return launch<false, efa_mma::kIeee, true>(
        bm_in, bp_in, geom, y_b, z_b, ggt_b, tab_b, bits, N, M, Ms, B, nb, T,
        localize, vertical, series, bm_out, bp_out, (cudaStream_t)stream);
  }
  const auto run = hybrid ? launcher<true>(mode) : launcher<false>(mode);
  if (!run) return (int)cudaErrorInvalidValue;
  return run(bm_in, bp_in, geom, y_b, nullptr, ggt_b, tab_b, bits, N, M, Ms,
             B, nb, T, localize, vertical, series, bm_out, bp_out,
             (cudaStream_t)stream);
}

}  // extern "C"
