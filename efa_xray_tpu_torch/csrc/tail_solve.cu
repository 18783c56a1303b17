// B1: exact serial EnSRF solve of one observation panel, one CTA per panel.
//
// Replaces: efa_xray_tpu/ops/tail_solve_pallas.py, _make_tail_solve_kernel
// (launched by tail_panel_solve_pallas), reached from
// efa_xray_tpu/assimilation/ensrf_core.py::_panel_solve_pallas.
//
// What it computes, for each ob i of the panel in order (f = assim flag):
//   ye = tp[i, :];  mu = mean(ye);  varye = sum((ye - mu)^2) / vden
//   innov = value_i - tm[i];  kdenom = varye + R_i
//   scale = 1 / (kdenom (M - 1));  beta = 1 / (1 + sqrt(R_i / kdenom))
//   kmat_j = (tp[j, :] . ye) * w[i, j] * scale          for every row j
//   tm[j] += (f innov) kmat_j;   tp[j, :] -= ((f beta) kmat_j) ye
// and emits the ye sequence, gain/sqrt coefficients, and the prior and
// posterior obs-space mean/variance (NaN where skipped; the posterior row i
// is (1 - beta kmat_i) ye, so post_var = (1 - beta kmat_i)^2 varye).
//
// What bounds it on an H100: latency.  The P steps are a serial chain; each
// step is a few thousand FMAs (P rows x M members), far below what one SM
// can do per microsecond, so the time is the per-step chain of shared-memory
// loads, one warp reduction and three __syncthreads.  Panels are sequential
// in tail_scan_blocked anyway, so one CTA per panel loses nothing.
//
// What the design does about it: the [P, M] slab lives in dynamic shared
// memory for the whole panel (512 x 80 x 4 B = 160 KB), so no step touches
// device memory except for ob i's weight row, which is read coalesced from
// global memory (the [P, P] matrix, 1 MB at P = 512, does not fit beside the
// slab).  One thread owns each row: the dot product and the rank-1 update of
// that row run in registers and shared memory with no cross-thread traffic.
// The slab's row stride is padded to an odd number of words, so the threads
// of a warp, which read 32 different rows at the same column, hit 32
// different banks.  The Pallas kernel's one-hot matvecs (a Mosaic
// workaround for dynamic row extraction) have no counterpart here: row i is
// simply indexed.
//
// Plain fp32 FMA throughout; no tensor cores.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;

__global__ void tail_solve_kernel(
    const float* __restrict__ tm_in,   // [P]
    const float* __restrict__ tp_in,   // [P, M]
    const float* __restrict__ vals,    // [P]
    const float* __restrict__ errs,    // [P]
    const unsigned char* __restrict__ assim,  // [P] 0/1
    const float* __restrict__ w,       // [P, P] w[i, j]; nullptr = no localization
    int P, int M, int stride, int unbiased,
    float* __restrict__ tm_out,        // [P]
    float* __restrict__ tp_out,        // [P, M]
    float* __restrict__ ye_out,        // [P, M]
    float* __restrict__ gain_out,      // [P]
    float* __restrict__ sqrt_out,      // [P]
    float* __restrict__ pm_out,        // [P]
    float* __restrict__ pv_out,        // [P]
    float* __restrict__ om_out,        // [P]
    float* __restrict__ ov_out) {      // [P]
  extern __shared__ float smem[];
  float* tp = smem;                 // [P, stride]
  float* tm = tp + P * stride;      // [P]
  float* ye = tm + P;               // [M]
  __shared__ float sc[6];           // mye, varye, innov, scale, beta, f

  const int tid = threadIdx.x;
  for (int idx = tid; idx < P * M; idx += blockDim.x) {
    int j = idx / M, m = idx - j * M;
    tp[j * stride + m] = tp_in[idx];
  }
  for (int j = tid; j < P; j += blockDim.x) tm[j] = tm_in[j];
  __syncthreads();

  const float vden = unbiased ? (float)(M - 1) : (float)M;
  const float nan = __int_as_float(0x7fc00000);

  for (int i = 0; i < P; ++i) {
    for (int m = tid; m < M; m += blockDim.x) {
      float v = tp[i * stride + m];
      ye[m] = v;
      ye_out[i * M + m] = v;
    }
    __syncthreads();
    if (tid < 32) {
      float s = 0.f;
      for (int m = tid; m < M; m += 32) s += ye[m];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      const float mu = s / (float)M;
      float q = 0.f;
      for (int m = tid; m < M; m += 32) {
        float d = ye[m] - mu;
        q += d * d;
      }
      for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
      if (tid == 0) {
        const float varye = q / vden;
        const float mye = tm[i];
        const float r = errs[i];
        const float kdenom = varye + r;
        sc[0] = mye;
        sc[1] = varye;
        sc[2] = vals[i] - mye;
        sc[3] = 1.0f / (kdenom * (float)(M - 1));
        sc[4] = 1.0f / (1.0f + sqrtf(r / kdenom));
        sc[5] = assim[i] ? 1.0f : 0.0f;
      }
    }
    __syncthreads();
    const float mye = sc[0], varye = sc[1], innov = sc[2];
    const float scale = sc[3], beta = sc[4], f = sc[5];
    const float fi = f * innov, fb = f * beta;
    for (int j = tid; j < P; j += blockDim.x) {
      float* row = tp + j * stride;
      float kcov = 0.f;
      for (int m = 0; m < M; ++m) kcov += row[m] * ye[m];
      const float wij = w ? w[(size_t)i * P + j] : 1.0f;
      const float kmat = kcov * wij * scale;
      tm[j] += fi * kmat;
      const float c = fb * kmat;
      for (int m = 0; m < M; ++m) row[m] -= c * ye[m];
      if (j == i) {
        const bool a = f != 0.0f;
        const float shrink = 1.0f - beta * kmat;
        gain_out[i] = fi * scale;
        sqrt_out[i] = fb * scale;
        pm_out[i] = mye;
        pv_out[i] = varye;
        om_out[i] = a ? mye + kmat * innov : nan;
        ov_out[i] = a ? shrink * shrink * varye : nan;
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < P * M; idx += blockDim.x) {
    int j = idx / M, m = idx - j * M;
    tp_out[idx] = tp[j * stride + m];
  }
  for (int j = tid; j < P; j += blockDim.x) tm_out[j] = tm[j];
}

// Dynamic shared memory the kernel needs for a [P, M] panel.
int smem_bytes(int P, int M) {
  const int stride = M | 1;
  return (int)sizeof(float) * (P * stride + P + M);
}

}  // namespace

extern "C" {

int efa_tail_solve(const float* tm_in, const float* tp_in, const float* vals,
                   const float* errs, const unsigned char* assim,
                   const float* w, int P, int M, int unbiased, float* tm_out,
                   float* tp_out, float* ye_out, float* gain_out,
                   float* sqrt_out, float* pm_out, float* pv_out,
                   float* om_out, float* ov_out, void* stream) {
  const int stride = M | 1;
  const int smem = smem_bytes(P, M);
  cudaError_t e = cudaFuncSetAttribute(
      tail_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  tail_solve_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      tm_in, tp_in, vals, errs, assim, w, P, M, stride, unbiased, tm_out,
      tp_out, ye_out, gain_out, sqrt_out, pm_out, pv_out, om_out, ov_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
