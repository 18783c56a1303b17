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
// The two products of one obs block, on a tile of T state rows:
//   D0:    d0[j, r] = X[r, :] . Y[j, :]   (U[j * Us + r]), K = the members;
//   apply: X[r, c] -= sum_j L[j, r] Y[j, c], K = the obs of alive panels,
// L = g o U (B2h: V; B3/B4: sqrt_coef o U).  Each operand is rounded once,
// at the point where the plain versions round it (ops/precision.py
// round_inputs): TF32 with cvt.rna.tf32.f32 (to nearest, ties away from
// zero), bf16 to nearest even.  Nothing else is rounded: the substitution,
// the weights, the table and the mean stay fp32.
//
// What bounds them: the first version (mma.sync tiles rounding in
// registers at every use) and a second one that staged rounded copies of X,
// Y and L in shared memory per block were both slower than the fp32 FMA
// products: the passes over the operands cost as much as the products
// saved, and the staging took the grid kernel's third CTA per SM (30
// members) or its 64-point tile (80 members).  So the design adds no pass
// and no shared memory but four words of U's row stride:
// 1. Y, the same for every CTA, is rounded once per launch by the wrapper
//    (ops/precision.py staged_y): TF32 values as float32, or bf16 pairs
//    packed in rows of round16(M) values; the kernel copies it as it
//    copies fp32 Y.
// 2. X is rounded in registers by D0, run transposed (d0^T = Y X^T): a warp
//    owns 8 state rows, rounds their B fragments once per block and holds
//    them (kSteps k-steps at a time) while it walks every m-tile of 16 obs
//    (two alive panels), A fragments by ldmatrix.x4.
// 3. L is rounded in place in U after the substitution (the pass the fp32
//    mode makes anyway to form g o U; B2h's only extra pass): TF32 in the
//    same words, bf16 pairs of obs packed into the even row.  U's stride is
//    T + 4 words in the modes, so the apply's scalar A loads (obs 2t, 2t + 1
//    of the panel for k index t, t + 4) fall on 32 banks.
// 4. The apply: a warp owns 16 rows and every (8 / (T / 16))-th tile of 8
//    members; B fragments from Y by scalar loads (TF32, the
//    same k pairing) or ldmatrix.trans (bf16, two panels a k-step).  Rows
//    of Y and X are 4 x odd words (at least the staged K), so every
//    ldmatrix row of a matrix and every scalar fragment load lands on its
//    own bank.
// 5. Exact dead-panel skips: D0, the rounding and the apply run over the
//    alive-panel list only; a k-step or m-tile with one panel left zeroes
//    (or does not store) the other half.
// 6. The products are bound by the latency of their mma chains, not by the
//    tensor cores or the loads (-DEFA_MMA_PROBE under chip_smoke.py
//    --steps): each warp keeps as many independent accumulators as its
//    registers allow.  B2 (32 rows, 128 registers): four tiles a pass, the
//    k-steps of each over two accumulators; the grid kernel at two CTAs
//    per SM eight tiles of one, at three four tiles of two.
// m16n8k8 TF32, m16n8k16 bf16, fp32 accumulators.  wgmma (m64nNk8 / k16)
// is not used: it reads both TF32 operands K-major from shared memory in
// its core-matrix layout, and staged copies of X and L^T cost the grid
// kernel a CTA per SM (PERF.md §6 has the measurements).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace efa_mma {

// The product modes (ops/precision.py MODES, in order).
constexpr int kIeee = 0, kTf32 = 1, kBf16 = 2;

// Parts of the products that a build with -DEFA_MMA_PROBE=<bits> leaves
// out, to time what each costs: 1 the mma instructions (a cheap use of the
// fragments instead), 2 the fragment loads (addresses in their place).
// The results of such a build are wrong; 0 in every build that is used.
#ifndef EFA_MMA_PROBE
#define EFA_MMA_PROBE 0
#endif
constexpr bool kProbeMma = (EFA_MMA_PROBE & 1) != 0;
constexpr bool kProbeLoads = (EFA_MMA_PROBE & 2) != 0;

// A fragment word from shared memory (or, probing, its address).
template <typename T>
__device__ __forceinline__ uint32_t frag(const T* p) {
  if constexpr (kProbeLoads)
    return static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p));
  else
    return *reinterpret_cast<const uint32_t*>(p);
}

// Bytes of K per mma k-step: 8 TF32 or 16 bf16 values.
constexpr int kStepBytes = 32;


// Words of a staged row of n values, K padded with zeros to whole k-steps
// (the wrapper's rounded Y rows in bf16), and the values they hold.
__host__ __device__ inline int staged_words(int mode, int n) {
  return (n * (mode == kBf16 ? 2 : 4) + kStepBytes - 1) / kStepBytes *
         kStepBytes / 4;
}
__host__ __device__ inline int staged_values(int mode, int n) {
  return staged_words(mode, n) * (mode == kBf16 ? 2 : 1);
}
// Row stride (floats) of the X and Y buffers in a mode: 4 x odd, at least
// the staged K, so that D0 reads whole k-steps inside each row.
__host__ __device__ inline int mode_row_stride(int mode, int M) {
  return 4 * ((staged_values(mode, M) >> 2) | 1);
}
// U's row stride in a mode (the fp32 mode keeps T).
__host__ __device__ inline int u_stride(int mode, int T) {
  return mode == kIeee ? T : T + 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  if (kProbeLoads) {
    r[0] = addr, r[1] = addr + 1, r[2] = addr + 2, r[3] = addr + 3;
    return;
  }
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              uint32_t addr) {
  if (kProbeLoads) {
    r[0] = addr, r[1] = addr + 1;
    return;
  }
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// d += a b: a 16 x K (row), b K x 8 (col), d 16 x 8 fp32; K = 8 (TF32) or
// 16 (bf16).  Fragments (g = lane / 4, t = lane % 4):
//   tf32: a = {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]},
//         b = {B[t][g], B[t+4][g]};
//   bf16: a = {A[g][2t, 2t+1], A[g+8][2t, 2t+1], A[g][2t+8, 2t+9],
//              A[g+8][2t+8, 2t+9]}, b = {B[2t, 2t+1][g], B[2t+8, 2t+9][g]};
//   d = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.
template <int kMode>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  static_assert(kMode == kTf32 || kMode == kBf16, "a tensor-core mode");
  if constexpr (kProbeMma) {
    d[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[0] ^ b[1]) &
                            0x007FFFFFu);
  } else if constexpr (kMode == kTf32) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// L rounded in place: for ob i < nobs of the compact alive list (whole
// panels), at U row ob(i) (stride Us, T values), coef(j) times the values,
// rounded: TF32 in the same words; bf16 the pair of obs (2q, 2q + 1), the
// lower in the low half, into the even row.  Obs at or past B give zeros.
template <int kMode, typename Ob, typename Coef>
__device__ __forceinline__ void round_left(float* U, int Us, int T, int nobs,
                                           int B, Ob ob, Coef coef, int tid,
                                           int nth) {
  const int C = T >> 2;  // float4 chunks of a row
  const auto scaled = [&](int j, int c) {
    if (j >= B) return make_float4(0.f, 0.f, 0.f, 0.f);
    const float f = coef(j);
    const float4 u = *reinterpret_cast<const float4*>(U + j * Us + 4 * c);
    return make_float4(f * u.x, f * u.y, f * u.z, f * u.w);
  };
  if constexpr (kMode == kTf32) {
    for (int idx = tid; idx < nobs * C; idx += nth) {
      const int i = idx / C, c = idx - i * C;
      const int j = ob(i);
      const float4 v = scaled(j, c);
      *reinterpret_cast<uint4*>(U + j * Us + 4 * c) =
          make_uint4(tf32(v.x), tf32(v.y), tf32(v.z), tf32(v.w));
    }
  } else {
    for (int idx = tid; idx < (nobs >> 1) * C; idx += nth) {
      const int q = idx / C, c = idx - q * C;
      const int j = ob(2 * q);  // the pair's obs j, j + 1 share a panel
      const float4 lo = scaled(j, c), hi = scaled(j + 1, c);
      *reinterpret_cast<uint4*>(U + j * Us + 4 * c) =
          make_uint4(bf16x2(lo.x, hi.x), bf16x2(lo.y, hi.y),
                     bf16x2(lo.z, hi.z), bf16x2(lo.w, hi.w));
    }
  }
}

// D0 of one warp, transposed (d0^T = Y X^T): state rows r0 .. r0 + 7 of
// the fp32 X (stride Ys), rounded into B fragments once, kSteps k-steps at
// a time, against every m-tile m of 16 obs: panels 2m and 2m + 1 of the np
// alive ones (row i of panel p at Y + yrow(p, i); the second absent when
// 2m + 1 == np), kM m-tiles a pass, ksteps k-steps in all, each tile's
// k-steps dealt over kSplit accumulators (independent mma chains); d0 of
// ob job(p) + i and row r written to U[(job(p) + i) * Us + r] (a later
// chunk of k-steps adds to it; so does the first where `add`: a later
// member slice of X and Y).
template <int kMode, int kSteps, int kM, int kSplit, typename YRow,
          typename JOb>
__device__ __forceinline__ void d0t_warp(const float* Xs, int Ys,
                                         const float* Y, YRow yrow, JOb job,
                                         int np, int ksteps, float* U, int Us,
                                         int r0, int lane, bool add = false) {
  const int g = lane >> 2, t = lane & 3, lr = lane & 7, lm = lane >> 3;
  const int nmt = (np + 1) >> 1;
  const float* x = Xs + (r0 + g) * Ys;
  for (int k0 = 0; k0 < ksteps; k0 += kSteps) {
    // B fragments: tf32 {X[g][k + t], X[g][k + t + 4]}; bf16 {X[g][k + 2t,
    // + 1], X[g][k + 8 + 2t, + 1]}, k the k-step's first member.
    uint32_t xb[kSteps][2];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      xb[s][0] = xb[s][1] = 0u;
      if (k0 + s < ksteps) {
        if constexpr (kProbeLoads) {
          xb[s][0] = frag(x + s), xb[s][1] = frag(x + s + 4);
        } else if constexpr (kMode == kTf32) {
          const float* xk = x + 8 * (k0 + s) + t;
          xb[s][0] = tf32(xk[0]);
          xb[s][1] = tf32(xk[4]);
        } else {
          const float* xk = x + 16 * (k0 + s) + 2 * t;
          const float2 p = *reinterpret_cast<const float2*>(xk);
          const float2 q = *reinterpret_cast<const float2*>(xk + 8);
          xb[s][0] = bf16x2(p.x, p.y);
          xb[s][1] = bf16x2(q.x, q.y);
        }
      }
    }
    for (int mb = 0; mb < nmt; mb += kM) {
      float acc[kM][kSplit][4];
      uint32_t a_addr[kM];
#pragma unroll
      for (int i = 0; i < kM; ++i) {
#pragma unroll
        for (int e = 0; e < 4 * kSplit; ++e) acc[i][e >> 2][e & 3] = 0.f;
        // ldmatrix rows: lanes 0-7 / 16-23 the first panel's 8 obs at the
        // k-step's first / second 16 bytes, lanes 8-15 / 24-31 the second's.
        const int m = min(mb + i, nmt - 1);
        const int p = (lm & 1) && 2 * m + 1 < np ? 2 * m + 1 : 2 * m;
        a_addr[i] = smem_addr(Y + yrow(p, lr)) + 16 * (lm >> 1) +
                    kStepBytes * k0;
      }
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        if (k0 + s < ksteps) {
#pragma unroll
          for (int i = 0; i < kM; ++i) {
            if (mb + i < nmt) {
              uint32_t a[4];
              ldsm_x4(a, a_addr[i] + kStepBytes * s);
              mma<kMode>(acc[i][s % kSplit], a, xb[s]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kM; ++i) {
        const int m = mb + i;
        if (m < nmt) {
          // d = {(ob g, rows 2t, 2t + 1), (ob g + 8, the same rows)}.
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (h == 0 || 2 * m + 1 < np) {
              float2* u = reinterpret_cast<float2*>(
                  U + (job(2 * m + h) + g) * Us + r0 + 2 * t);
              float2 v = make_float2(0.f, 0.f);
#pragma unroll
              for (int k = 0; k < kSplit; ++k)
                v.x += acc[i][k][2 * h], v.y += acc[i][k][2 * h + 1];
              if (k0 > 0 || add) {
                const float2 w = *u;
                v.x += w.x, v.y += w.y;
              }
              *u = v;
            }
          }
        }
      }
    }
  }
}

// The apply of one warp: X[r0 .. r0 + 15, members of n-tiles n = n0, n0 +
// dn, ... < nn] (kN a pass, the k-steps of each dealt over kSplit
// accumulators) -= sum over the alive panels a < na of L[ob][r] Y[ob][c],
// L rounded in place in U (row i of panel a at U + lrow(a, i), stride Us;
// bf16 pairs in the even rows) and Y rounded by the wrapper (row i of
// panel a at Y + yrow(a, i)).  Members at or past M are not written.
template <int kMode, int kN, int kSplit, typename YRow, typename LRow>
__device__ __forceinline__ void apply_warp(float* Xs, int Ys, const float* U,
                                           LRow lrow, int Us, const float* Y,
                                           YRow yrow, int na, int M, int r0,
                                           int n0, int dn, int nn, int lane) {
  const int g = lane >> 2, t = lane & 3, lr = lane & 7, lm = lane >> 3;
  const uint32_t* L = reinterpret_cast<const uint32_t*>(U);
  // A k-step: one panel (TF32) or two (bf16).
  const int kp = kMode == kTf32 ? 1 : 2;
  for (int nb = n0; nb < nn; nb += kN * dn) {
    float acc2[kSplit][kN][4];
#pragma unroll
    for (int i = 0; i < kN; ++i)
#pragma unroll
      for (int e = 0; e < 4 * kSplit; ++e) acc2[e >> 2][i][e & 3] = 0.f;
    // The k-step at panel a into acc.
    const auto step = [&](int a, float (&acc)[kN][4]) {
      if constexpr (kMode == kTf32) {
        // k index t is ob 2t of the panel, t + 4 ob 2t + 1.
        const uint32_t* l = L + lrow(a, 2 * t) + r0 + g;
        const uint32_t af[4] = {frag(l), frag(l + 8), frag(l + Us),
                                frag(l + Us + 8)};
        const float* y0 = Y + yrow(a, 2 * t) + g;
        const float* y1 = Y + yrow(a, 2 * t + 1) + g;
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          const int n = nb + i * dn;
          if (n < nn) {
            const uint32_t bf[2] = {frag(y0 + 8 * n), frag(y1 + 8 * n)};
            mma<kMode>(acc[i], af, bf);
          }
        }
      } else {
        // k indices 0-7 are panel a's obs, 8-15 panel a + 1's.
        const bool two = a + 1 < na;
        const uint32_t* l0 = L + lrow(a, 2 * t) + r0 + g;
        const uint32_t* l1 = two ? L + lrow(a + 1, 2 * t) + r0 + g : l0;
        const uint32_t af[4] = {frag(l0), frag(l0 + 8), two ? frag(l1) : 0u,
                                two ? frag(l1 + 8) : 0u};
        const uint32_t y_addr =
            smem_addr(Y + yrow((lm & 1) && two ? a + 1 : a, lr));
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          const int n = nb + i * dn;
          if (n < nn) {
            uint32_t bf[2];
            ldsm_x2_trans(bf, y_addr + 16 * n);
            if (!two) bf[1] = 0u;
            mma<kMode>(acc[i], af, bf);
          }
        }
      }
    };
    for (int a = 0; a < na; a += kSplit * kp) {
#pragma unroll
      for (int k = 0; k < kSplit; ++k)
        if (a + k * kp < na) step(a + k * kp, acc2[k]);
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < kSplit; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += acc2[k][i][e];
      const int c = 8 * (nb + i * dn) + 2 * t;
      if (nb + i * dn < nn && c < M) {
        float* x0 = Xs + (r0 + g) * Ys + c;
        float* x1 = x0 + 8 * Ys;
        if (c + 1 < M) {
          float2 v0 = *reinterpret_cast<float2*>(x0);
          float2 v1 = *reinterpret_cast<float2*>(x1);
          v0.x -= acc[0], v0.y -= acc[1];
          v1.x -= acc[2], v1.y -= acc[3];
          *reinterpret_cast<float2*>(x0) = v0;
          *reinterpret_cast<float2*>(x1) = v1;
        } else {
          x0[0] -= acc[0];
          x1[0] -= acc[2];
        }
      }
    }
  }
}

}  // namespace efa_mma
