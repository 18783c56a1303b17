// The body kernels' two large products on the tensor cores: the TF32 and
// bf16 modes of B2/B2h (ensrf_fused.cu) and B3/B4 (ensrf_grid.cu).  Their
// fp32 mode is each kernel's own FMA code; ops/precision.py maps a
// FilterConfig (matmul_precision, mxu_bf16) to a mode.
//
// Replaces: the explicit bf16 casts of efa_xray_tpu/ops/ensrf_pallas_fused.py
// (mxu_bf16: D0 :191-205, the apply :392-412, grid :821-828, :868-874) and
// what jax.default_matmul_precision makes of every Pallas dot on the TPU
// (efa_xray_tpu/assimilation/assimilation.py:420-450).
//
// Both products keep the kernels' shared-memory layouts, fp32 and padded:
//   D0:    d0[j, r] = X[r, :] . Y[j, :]   (U[j * T + r]), K = the members;
//   apply: X[r, c] -= sum_j U[j, r] Y[j, c], K = the obs of alive panels.
// A warp computes a 16 x 8 tile with mma.sync m16n8k8 (.tf32, or .bf16 with
// f32 accumulation): for D0 16 rows x one 8-ob panel, for the apply 16 rows x
// 8 members over the alive panels, one panel per k-step, so that the dead-
// panel skip stays exact.  Each operand is read from shared memory as fp32
// and rounded in registers, at the point where the plain versions round it:
// TF32 with cvt.rna.tf32.f32 (to nearest, ties away from zero), bf16 with
// __floats2bfloat162_rn (to nearest even).  Without the explicit rounding
// the tensor core would truncate the fp32 bits, and the kernel would not
// compute its plain version's function.  Members past round4(M) (a k-step
// or an n-tile that runs past the padded row) read as zeros and are never
// written; rounding a zero is exact.
//
// What bounds them: a simple first version.  Operands are re-read from
// shared memory and re-rounded by every warp that uses them; wgmma is not
// used (B2's tile of 32 rows is under a warpgroup's 64).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace efa_mma {

// The product modes (ops/precision.py MODES, in order).
constexpr int kIeee = 0, kTf32 = 1, kBf16 = 2;

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// Two values as one bf16x2 register, `lo` in the low half (the element of
// the lower k or column index).
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a b: a 16 x 8 (row), b 8 x 8 (col), d 16 x 8 fp32.  Fragments
// (g = lane / 4, t = lane % 4):
//   tf32: a = {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]},
//         b = {B[t][g], B[t+4][g]};
//   bf16: a = {A[g][2t, 2t+1], A[g+8][2t, 2t+1]}, b = {B[2t, 2t+1][g]};
//   d = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[2],
                                         uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// D0 of one warp: rows r0 .. r0 + 15 of X (row r at xs + r * Ys) against the
// 8 obs of the panel starting at ob jb (row j of Y at Ysm + yrow(j)), summed
// over the Mp = round4(M) padded members; written to U[j * T + r].
template <int kMode, typename YRow>
__device__ __forceinline__ void d0_tile(const float* Xs, int Ys,
                                        const float* Ysm, YRow yrow, float* U,
                                        int T, int r0, int jb, int Mp,
                                        int lane) {
  static_assert(kMode == kTf32 || kMode == kBf16, "a tensor-core mode");
  const int g = lane >> 2, t = lane & 3;
  const float* x0 = Xs + (r0 + g) * Ys;
  const float* x1 = x0 + 8 * Ys;
  const float* yg = Ysm + yrow(jb + g);
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < Mp; k0 += 8) {
    if constexpr (kMode == kTf32) {
      // k0 < Mp and Mp % 4 == 0: columns k0 .. k0 + 3 exist.
      const int ka = k0 + t, kb = ka + 4;
      const bool hb = kb < Mp;
      const uint32_t a[4] = {tf32(x0[ka]), tf32(x1[ka]),
                             hb ? tf32(x0[kb]) : 0u, hb ? tf32(x1[kb]) : 0u};
      const uint32_t b[2] = {tf32(yg[ka]), hb ? tf32(yg[kb]) : 0u};
      mma_tf32(d, a, b);
    } else {
      const int ka = k0 + 2 * t;
      const bool h = ka < Mp;
      uint32_t a[2] = {0u, 0u}, b = 0u;
      if (h) {
        const float2 xa = *reinterpret_cast<const float2*>(x0 + ka);
        const float2 xb = *reinterpret_cast<const float2*>(x1 + ka);
        const float2 yv = *reinterpret_cast<const float2*>(yg + ka);
        a[0] = bf16x2(xa.x, xa.y);
        a[1] = bf16x2(xb.x, xb.y);
        b = bf16x2(yv.x, yv.y);
      }
      mma_bf16(d, a, b);
    }
  }
  const int j = jb + 2 * t, r = r0 + g;
  U[j * T + r] = d[0];
  U[(j + 1) * T + r] = d[1];
  U[j * T + r + 8] = d[2];
  U[(j + 1) * T + r + 8] = d[3];
}

// The apply of one warp: X[r0 .. r0 + 15, c0 .. c0 + 7] -= sum over the
// alive panels (ob jb = 8 pl[a], a < na) of U[j, r] Y[j, c], the U columns
// already holding what the apply multiplies (g o U, or B2h's V).  Members at
// or past Mp are neither read nor written.
template <int kMode, typename YRow>
__device__ __forceinline__ void apply_tile(float* Xs, int Ys,
                                           const float* Ysm, YRow yrow,
                                           const float* U, int T, int r0,
                                           int c0, const int* pl, int na,
                                           int Mp, int lane) {
  static_assert(kMode == kTf32 || kMode == kBf16, "a tensor-core mode");
  const int g = lane >> 2, t = lane & 3;
  const int r = r0 + g, cn = c0 + g;
  const bool cok = cn < Mp;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  for (int a = 0; a < na; ++a) {
    const int jb = 8 * (pl ? pl[a] : a);
    if constexpr (kMode == kTf32) {
      const float* ua = U + (jb + t) * T + r;
      const float* ub = U + (jb + t + 4) * T + r;
      const uint32_t af[4] = {tf32(ua[0]), tf32(ua[8]), tf32(ub[0]),
                              tf32(ub[8])};
      const uint32_t bf[2] = {
          cok ? tf32(Ysm[yrow(jb + t) + cn]) : 0u,
          cok ? tf32(Ysm[yrow(jb + t + 4) + cn]) : 0u};
      mma_tf32(d, af, bf);
    } else {
      const float* ua = U + (jb + 2 * t) * T + r;
      const float* ub = ua + T;
      const uint32_t af[2] = {bf16x2(ua[0], ub[0]), bf16x2(ua[8], ub[8])};
      const uint32_t bf =
          cok ? bf16x2(Ysm[yrow(jb + 2 * t) + cn],
                       Ysm[yrow(jb + 2 * t + 1) + cn])
              : 0u;
      mma_bf16(d, af, bf);
    }
  }
  const int c = c0 + 2 * t;
  float* x0 = Xs + r * Ys + c;
  float* x1 = x0 + 8 * Ys;
  if (c < Mp) x0[0] -= d[0], x1[0] -= d[2];
  if (c + 1 < Mp) x0[1] -= d[1], x1[1] -= d[3];
}

}  // namespace efa_mma
