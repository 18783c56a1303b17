// B3 and B4: the EnSRF body with localization weights streamed in per grid
// point.  The state's rows are VT groups (variables x times) over one grid of
// G points, row (v, g) at v * G + g.  Horizontal weights are per grid point,
// shared by every group; a per-(group, ob) scalar table carries vertical
// localization and the cross-variable factor.
//
// Replaces:
//   B3: efa_xray_tpu/ops/ensrf_pallas_fused.py, _make_fused_grid_kernel
//       (launched by _fused_grid_impl): every obs block in one launch while
//       a grid tile of one group stays on chip.  Entry point efa_grid_body.
//   B4: efa_xray_tpu/ops/ensrf_pallas.py, _make_block_kernel (launched by
//       apply_obs_block_pallas, scanned by ensrf_blocked_body_pallas): one
//       obs block per launch.  Entry point efa_block_apply.
// Both run the same kernel: B3 over all blocks, B4 over one.
//
// What it computes, for a tile of rows X [T, M] (perturbations) and xm [T]
// (mean) of group v, for each block of B pre-solved obs with rows Y [B, M]:
//   D0 = X Y^T                                   (d0[j, r] = Y_j . X_r)
//   u_j = w[j, g_r] table[v, j] o (d0_j - sum_{i<j} ggt[j, i] u_i)
//   xm += U^T gain;  X -= (sqrt_coef o U)^T Y
// with ggt[j, i] = (y_i . y_j) sqrt_coef_i, w the block's weights [B, G]
// (absent: unlocalized) and the table absent meaning 1.
//
// What bounds it on an H100: with plain fp32 FMA, arithmetic.  Per (tile,
// block) the two products take 2 T B M FMAs and the substitution T B^2 / 2.
// The weights are read once per (group, tile, block): B T floats, coalesced
// along the grid.  Y, ggt and the per-ob rows are re-read by every CTA from
// the 50 MB L2.
//
// What the design does about it: the layout of B2 (csrc/ensrf_fused.cu),
// minus its in-kernel trigonometry and cull bits.  A CTA owns T points of one
// group and loops over the blocks it is given; X, the block's Y and ggt, the
// d0/U columns, the panel's weights and the per-ob rows live in shared memory
// (~160 KB at T 64, B 128, M 80).  Product threads keep 4-wide register
// tiles.  The forward substitution follows the Pallas kernel's panels of 8
// obs: the correction against solved panels and the panel's weights run in
// parallel over (ob, row) pairs, and only the in-panel chain runs one thread
// per row.  The X tile's row stride is odd (no bank conflicts down a
// column).  Points past the end of the grid (a ragged last tile) are zero,
// their weights are never read and their rows never written, so any G is
// exact without padding.  No tensor cores and no TF32: a later change
// measures those.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPanel = 8;
// Per-ob rows in shared memory: gain, sqrt_coef, table factor.
constexpr int kCoef = 3;

// bm_out/bp_out may alias bm_in/bp_in (in-place update): a CTA reads its
// own rows before the block loop and writes only those rows after it.
__global__ void grid_body_kernel(
    const float* bm_in,  // [VT * G]
    const float* bp_in,  // [VT * G, M]
    const float* __restrict__ w,      // [nb, B, G] or nullptr (unlocalized)
    const float* __restrict__ table,  // [VT, nb, B] or nullptr (ones)
    const float* __restrict__ y_b,    // [nb, B, M]
    const float* __restrict__ ggt_b,  // [nb, B, B]
    const float* __restrict__ coef_b, // [nb, 2, B]: gain, sqrt_coef
    int G, int M, int B, int nb, int T, float* bm_out, float* bp_out) {
  extern __shared__ float smem[];
  const int Ms = M | 1;
  float* Xs = smem;              // [T, Ms]
  float* Ys = Xs + T * Ms;       // [B, M]
  float* Gs = Ys + B * M;        // [B, B]
  float* U = Gs + B * B;         // [B, T]  d0 columns, then u columns
  float* Wb = U + B * T;         // [kPanel, T]
  float* cf = Wb + kPanel * T;   // [kCoef, B]
  float* xm = cf + kCoef * B;    // [T]

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int gtiles = (G + T - 1) / T;
  const int v = blockIdx.x / gtiles;
  const int tile = blockIdx.x - v * gtiles;
  const long g0 = (long)tile * T;
  const int npts = (int)min((long)T, (long)G - g0);
  const long row0 = (long)v * G + g0;

  for (int idx = tid; idx < T * M; idx += nth) {
    const int r = idx / M, m = idx - r * M;
    Xs[r * Ms + m] = r < npts ? bp_in[(row0 + r) * M + m] : 0.0f;
  }
  for (int r = tid; r < T; r += nth) xm[r] = r < npts ? bm_in[row0 + r] : 0.0f;
  __syncthreads();

  const int J4 = (B + 3) / 4;
  const int M4 = (M + 3) / 4;
  const int npanels = (B + kPanel - 1) / kPanel;

  for (int b = 0; b < nb; ++b) {
    const float* yb = y_b + (long)b * B * M;
    const float* gb = ggt_b + (long)b * B * B;
    const float* cb = coef_b + (long)b * 2 * B;
    const float* wb = w ? w + (long)b * B * G + g0 : nullptr;
    for (int idx = tid; idx < B * M; idx += nth) Ys[idx] = yb[idx];
    for (int idx = tid; idx < B * B; idx += nth) Gs[idx] = gb[idx];
    for (int j = tid; j < B; j += nth) {
      cf[j] = cb[j];
      cf[B + j] = cb[B + j];
      cf[2 * B + j] = table ? table[((long)v * nb + b) * B + j] : 1.0f;
    }
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
      // Correction against the solved panels and the panel's weights
      // (grid weight times the group's table factor), in parallel over
      // (ob, row) pairs.
      for (int idx = tid; idx < width * T; idx += nth) {
        const int t = idx / T, r = idx - t * T;
        const int j = base + t;
        float corr = 0.f;
        for (int i = 0; i < base; ++i) corr += Gs[j * B + i] * U[i * T + r];
        U[j * T + r] -= corr;
        if (wb) Wb[t * T + r] = r < npts ? wb[(long)j * G + r] * cf[2 * B + j] : 0.0f;
      }
      __syncthreads();
      // The within-panel chain, one thread per row.
      for (int r = tid; r < T; r += nth) {
        for (int t = 0; t < width; ++t) {
          const int j = base + t;
          float corr = 0.f;
          for (int i = base; i < j; ++i) corr += Gs[j * B + i] * U[i * T + r];
          float d = U[j * T + r] - corr;
          if (wb) d *= Wb[t * T + r];
          U[j * T + r] = d;
        }
      }
      __syncthreads();
    }

    // xm += U^T gain;  X -= (sqrt_coef o U)^T Y.
    for (int r = tid; r < T; r += nth) {
      float s = 0.f;
      for (int j = 0; j < B; ++j) s += cf[j] * U[j * T + r];
      xm[r] += s;
    }
    for (int idx = tid; idx < T * M4; idx += nth) {
      const int r = idx / M4, mq = idx - r * M4;
      const int m0 = mq, m1 = min(mq + M4, M - 1), m2 = min(mq + 2 * M4, M - 1),
                m3 = min(mq + 3 * M4, M - 1);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int j = 0; j < B; ++j) {
        const float gu = cf[B + j] * U[j * T + r];
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

  for (int idx = tid; idx < npts * M; idx += nth) {
    const int r = idx / M, m = idx - r * M;
    bp_out[(row0 + r) * M + m] = Xs[r * Ms + m];
  }
  for (int r = tid; r < npts; r += nth) bm_out[row0 + r] = xm[r];
}

// Dynamic shared memory for a tile of T points, blocks of B obs, M members
// (mirrored by efa_xray_tpu_torch.ops.ensrf_grid.smem_bytes).
int smem_bytes(int T, int B, int M) {
  const int Ms = M | 1;
  return (int)sizeof(float) *
         (T * Ms + B * M + B * B + B * T + kPanel * T + kCoef * B + T);
}

int launch(const float* bm_in, const float* bp_in, const float* w,
           const float* table, const float* y_b, const float* ggt_b,
           const float* coef_b, int VT, int G, int M, int B, int nb, int T,
           float* bm_out, float* bp_out, void* stream) {
  const int smem = smem_bytes(T, B, M);
  cudaError_t e = cudaFuncSetAttribute(
      grid_body_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long ctas = (long)VT * ((G + T - 1) / T);
  if (ctas > 0x7fffffffL) return (int)cudaErrorInvalidConfiguration;
  grid_body_kernel<<<(unsigned)ctas, kThreads, smem, (cudaStream_t)stream>>>(
      bm_in, bp_in, w, table, y_b, ggt_b, coef_b, G, M, B, nb, T, bm_out,
      bp_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B3: all nb blocks in one launch.
int efa_grid_body(const float* bm_in, const float* bp_in, const float* w,
                  const float* table, const float* y_b, const float* ggt_b,
                  const float* coef_b, int VT, int G, int M, int B, int nb,
                  int T, float* bm_out, float* bp_out, void* stream) {
  return launch(bm_in, bp_in, w, table, y_b, ggt_b, coef_b, VT, G, M, B, nb,
                T, bm_out, bp_out, stream);
}

// B4: one block per launch.
int efa_block_apply(const float* bm_in, const float* bp_in, const float* w,
                    const float* table, const float* y, const float* ggt,
                    const float* coef, int VT, int G, int M, int B, int T,
                    float* bm_out, float* bp_out, void* stream) {
  return launch(bm_in, bp_in, w, table, y, ggt, coef, VT, G, M, B, 1, T,
                bm_out, bp_out, stream);
}

}  // extern "C"
