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
// half-angle arccos form, exactly as the Pallas kernel chooses.  Cull bits,
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
// What bounds it on an H100: with plain fp32 FMA, arithmetic.  Per alive
// (tile, block) the two products take 2 T B M FMAs and the substitution
// T B^2 / 2; the weight chain is ~40 operations per (ob, row) pair.  The
// state itself is read once and written once, and Y, the ggt tables and the
// per-ob table (a few MB in all) are re-read by every CTA from the 50 MB L2.
//
// What the design does about it: a CTA owns T rows (64, or 32 for wide
// ensembles) and loops over all blocks itself.  X, the block's Y and ggt,
// the d0/U columns, the per-panel weights and the per-ob tables all live in
// shared memory (~167 KB at T 64, B 128, M 80; B2h adds the sigma row, a
// panel of static columns, the mean accumulator and three table rows,
// 2T + 8T + 3B floats, ~171 KB: still one CTA per SM).  kHybrid is a
// template parameter, so the pure instantiation carries none of it.  Each
// product thread keeps a 4-wide register tile, so one shared load of X (or
// of the U column) feeds four FMAs.  The forward substitution follows the Pallas kernel's panels
// of 8 obs: the correction against earlier panels and the panel's weights
// are computed in parallel over (ob, row) pairs, and only the short
// within-panel chain runs one thread per row.  The X tile's row stride is
// odd, so a warp reading 32 rows at one column hits 32 banks.  Rows past
// the end of the state (the ragged last tile) are zero and never written.
// No tensor cores and no TF32: a later change measures those.

#include <cuda_runtime.h>
#include <math.h>

namespace {

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

// Great-circle distance (km) from ob j to row r, by the chordal angle.
__device__ __forceinline__ float chord_dist(const float* tab, int B, int j,
                                            const float* geo, int T, int r,
                                            int series) {
  const float ox = tab[2 * B + j], oy = tab[3 * B + j], oz = tab[4 * B + j];
  float dot = ox * geo[r] + oy * geo[T + r] + oz * geo[2 * T + r];
  dot = fminf(fmaxf(dot, -1.0f), 1.0f);
  float ang;
  if (series) {
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
  float w = invrad > 0.0f ? (series ? gc_poly(rr) : gc_exact(rr)) : 1.0f;
  if (vertical) {
    const float ivr = tab[7 * B + j];
    const float rv = fabsf(geo[3 * T + r] - tab[6 * B + j]) * ivr;
    w *= ivr > 0.0f ? gc_exact(rv) : 1.0f;
  }
  return w;
}

// bm_out/bp_out may alias bm_in/bp_in (in-place update): a CTA reads its
// own rows before the block loop and writes only those rows after it.
template <bool kHybrid>
__global__ void fused_body_kernel(
    const float* bm_in,  // [N]
    const float* bp_in,  // [N, M]
    const float* __restrict__ geom,   // [kGeo, N]: unit x, y, z, vertical
                                      // (, sigma for B2h)
    const float* __restrict__ y_b,    // [nb, B, M]
    const float* __restrict__ ggt_b,  // [nb, B, B]; B2h: the raw Gram
    const float* __restrict__ tab_b,  // [nb, kTab, B]
    const int* __restrict__ bits,     // [gtiles, nb] or nullptr (no cull)
    int N, int M, int B, int nb, int T, int localize, int vertical,
    int series, float* bm_out, float* bp_out) {
  constexpr int kTab = kHybrid ? kTabHybrid : kTabPure;
  constexpr int kGeo = kHybrid ? 5 : 4;
  extern __shared__ float smem[];
  const int Ms = M | 1;
  float* Xs = smem;              // [T, Ms]
  float* Ys = Xs + T * Ms;       // [B, M]
  float* G = Ys + B * M;         // [B, B]
  float* U = G + B * B;          // [B, T]  d0 columns, then u (B2h: v)
  float* Wb = U + B * T;         // [kPanel, T]
  float* tab = Wb + kPanel * T;  // [kTab, B]
  float* geo = tab + kTab * B;   // [kGeo, T]
  float* xm = geo + kGeo * T;    // [T]
  float* Sb = xm + T;            // B2h: [kPanel, T] static columns
  float* macc = Sb + kPanel * T; // B2h: [T] mean accumulator

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int tile = blockIdx.x;
  const long r0 = (long)tile * T;
  const int nrows = (int)min((long)T, (long)N - r0);

  for (int idx = tid; idx < T * M; idx += nth) {
    const int r = idx / M, m = idx - r * M;
    Xs[r * Ms + m] = r < nrows ? bp_in[(r0 + r) * M + m] : 0.0f;
  }
  for (int r = tid; r < T; r += nth) {
    const bool in = r < nrows;
    xm[r] = in ? bm_in[r0 + r] : 0.0f;
    for (int c = 0; c < kGeo; ++c) geo[c * T + r] = in ? geom[(long)c * N + r0 + r] : 0.0f;
  }
  __syncthreads();

  const int J4 = (B + 3) / 4;
  const int M4 = (M + 3) / 4;
  const int npanels = (B + kPanel - 1) / kPanel;

  for (int b = 0; b < nb; ++b) {
    const int bw = bits ? bits[(long)tile * nb + b] : -1;
    if (bw == 0) continue;  // every pair of this (tile, block) is dead

    const float* yb = y_b + (long)b * B * M;
    const float* gb = ggt_b + (long)b * B * B;
    const float* tb = tab_b + (long)b * kTab * B;
    for (int idx = tid; idx < B * M; idx += nth) Ys[idx] = yb[idx];
    for (int idx = tid; idx < B * B; idx += nth) G[idx] = gb[idx];
    for (int idx = tid; idx < kTab * B; idx += nth) tab[idx] = tb[idx];
    if (kHybrid)
      for (int r = tid; r < T; r += nth) macc[r] = 0.0f;
    __syncthreads();

    // D0 = X Y^T: each thread one row r and four obs j0..j0+3.
    for (int idx = tid; idx < T * J4; idx += nth) {
      const int r = idx % T, j0 = (idx / T) * 4;
      const float* y0 = Ys + min(j0, B - 1) * M;
      const float* y1 = Ys + min(j0 + 1, B - 1) * M;
      const float* y2 = Ys + min(j0 + 2, B - 1) * M;
      const float* y3 = Ys + min(j0 + 3, B - 1) * M;
      const float* xr = Xs + r * Ms;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int m = 0; m < M; ++m) {
        const float x = xr[m];
        a0 += y0[m] * x;
        a1 += y1[m] * x;
        a2 += y2[m] * x;
        a3 += y3[m] * x;
      }
      U[j0 * T + r] = a0;
      if (j0 + 1 < B) U[(j0 + 1) * T + r] = a1;
      if (j0 + 2 < B) U[(j0 + 2) * T + r] = a2;
      if (j0 + 3 < B) U[(j0 + 3) * T + r] = a3;
    }
    __syncthreads();

    for (int q = 0; q < npanels; ++q) {
      const int base = q * kPanel;
      const int width = min(kPanel, B - base);
      const bool alive = !bits || ((bw >> q) & 1);
      if (!alive) {
        for (int idx = tid; idx < width * T; idx += nth) U[base * T + idx] = 0.0f;
        __syncthreads();
        continue;
      }
      // Correction against the solved panels, the panel's weights and
      // (B2h) its static columns, in parallel over (ob, row) pairs.
      for (int idx = tid; idx < width * T; idx += nth) {
        const int t = idx / T, r = idx - t * T;
        const int j = base + t;
        float corr = 0.f;
        for (int i = 0; i < base; ++i) corr += G[j * B + i] * U[i * T + r];
        U[j * T + r] -= corr;
        if (localize || kHybrid) {
          const float dist = chord_dist(tab, B, j, geo, T, r, series);
          if (localize)
            Wb[t * T + r] = loc_weight(tab, B, j, geo, T, r, dist, vertical, series);
          if (kHybrid)
            Sb[t * T + r] = geo[4 * T + r] * gc_exact(dist * tab[10 * B + j]);
        }
      }
      __syncthreads();
      // The within-panel chain, one thread per row.
      for (int r = tid; r < T; r += nth) {
        for (int t = 0; t < width; ++t) {
          const int j = base + t;
          float corr = 0.f;
          for (int i = base; i < j; ++i) corr += G[j * B + i] * U[i * T + r];
          float d = U[j * T + r] - corr;
          if (localize) d *= Wb[t * T + r];
          if (kHybrid) {
            const float s = Sb[t * T + r];
            macc[r] += tab[j] * d + tab[8 * B + j] * s;
            d = tab[B + j] * d + tab[9 * B + j] * s;
          }
          U[j * T + r] = d;
        }
      }
      __syncthreads();
    }

    // Pure: xm += U^T gain;  X -= (g o U)^T Y.
    // B2h:  xm += macc;      X -= V^T Y.
    for (int r = tid; r < T; r += nth) {
      if (kHybrid) {
        xm[r] += macc[r];
      } else {
        float s = 0.f;
        for (int j = 0; j < B; ++j) s += tab[j] * U[j * T + r];
        xm[r] += s;
      }
    }
    for (int idx = tid; idx < T * M4; idx += nth) {
      const int r = idx / M4, mq = idx - r * M4;
      const int m0 = mq, m1 = min(mq + M4, M - 1), m2 = min(mq + 2 * M4, M - 1),
                m3 = min(mq + 3 * M4, M - 1);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int j = 0; j < B; ++j) {
        const float gu = kHybrid ? U[j * T + r] : tab[B + j] * U[j * T + r];
        const float* yj = Ys + j * M;
        a0 += gu * yj[m0];
        a1 += gu * yj[m1];
        a2 += gu * yj[m2];
        a3 += gu * yj[m3];
      }
      float* xr = Xs + r * Ms;
      xr[m0] -= a0;
      if (mq + M4 < M) xr[mq + M4] -= a1;
      if (mq + 2 * M4 < M) xr[mq + 2 * M4] -= a2;
      if (mq + 3 * M4 < M) xr[mq + 3 * M4] -= a3;
    }
    __syncthreads();
  }

  for (int idx = tid; idx < nrows * M; idx += nth) {
    const int r = idx / M, m = idx - r * M;
    bp_out[(r0 + r) * M + m] = Xs[r * Ms + m];
  }
  for (int r = tid; r < nrows; r += nth) bm_out[r0 + r] = xm[r];
}

// Dynamic shared memory for a tile of T rows, blocks of B obs, M members
// (mirrored by efa_xray_tpu_torch.ops.ensrf_fused.smem_bytes).
int smem_bytes(int T, int B, int M, bool hybrid) {
  const int Ms = M | 1;
  const int pure = T * Ms + B * M + B * B + B * T + kPanel * T +
                   kTabPure * B + 4 * T + T;
  const int extra = hybrid ? T + kPanel * T + T + (kTabHybrid - kTabPure) * B
                           : 0;
  return (int)sizeof(float) * (pure + extra);
}

template <bool kHybrid>
int launch(const float* bm_in, const float* bp_in, const float* geom,
           const float* y_b, const float* ggt_b, const float* tab_b,
           const int* bits, int N, int M, int B, int nb, int T, int localize,
           int vertical, int series, float* bm_out, float* bp_out,
           cudaStream_t stream) {
  const int smem = smem_bytes(T, B, M, kHybrid);
  cudaError_t e = cudaFuncSetAttribute(fused_body_kernel<kHybrid>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (N + T - 1) / T;
  fused_body_kernel<kHybrid><<<tiles, kThreads, smem, stream>>>(
      bm_in, bp_in, geom, y_b, ggt_b, tab_b, bits, N, M, B, nb, T, localize,
      vertical, series, bm_out, bp_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int efa_fused_body(const float* bm_in, const float* bp_in, const float* geom,
                   const float* y_b, const float* ggt_b, const float* tab_b,
                   const int* bits, int N, int M, int B, int nb, int T,
                   int localize, int vertical, int series, int hybrid,
                   float* bm_out, float* bp_out, void* stream) {
  const auto run = hybrid ? &launch<true> : &launch<false>;
  return run(bm_in, bp_in, geom, y_b, ggt_b, tab_b, bits, N, M, B, nb, T,
             localize, vertical, series, bm_out, bp_out,
             (cudaStream_t)stream);
}

}  // extern "C"
