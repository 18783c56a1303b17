// LG: the LETKF chunk's local precision, ensemble-space Gram and right-hand
// side in one kernel.
//
// Replaces no Pallas kernel: the JAX package computes rho and the A / b
// einsums of each chunk as plain XLA inside its lax.map
// (efa_xray_tpu/assimilation/letkf_core.py, _analyze_body_chunked's `one`
// and solve_patch_weights's `one`), where in eager torch they were about
// forty operations a chunk issued from the host.
//
// What it computes, for each unit c of a chunk (a patch, or a (group,
// patch) in vertical mode) over its K selected obs o = ii[c, k]:
//   a_k = rinv_o * GC(chord(px_c, x_o), r_o)      (localize; else rinv_o)
//         * GC(|pv_c - v_o|, vr_o)                 (vertical: pv given)
//         * vl[uv_c, ovar_o]                       (varloc: vl given)
//   A_c = (M - 1) I + sum_k (a_k y_k) y_k^T,   b_c = sum_k (a_k y_k) d_o
// with y_k = ye[o] and d_o the innovation, in float32.  The weights follow
// observation/localization.py chordal_gc_weights term by term (the dot as
// three rounded products and two sums, the clamp, _arccos_as, the exact
// Gaspari-Cohn form), every operation rounded as torch rounds it (no FMA
// contraction), and a_k y_k is rounded before it enters the sum, as the
// einsum over ya = yl * a does.  Padded units (zero centroids) weigh as the
// plain version weighs them.
//
// What bounds it on an H100: config 7's chunk is 512 units x 64 obs x 80
// members: 0.4 GFLOP (0.006 ms at 67 TFLOP/s), and the bytes of the gathered
// ye rows (10.5 MB), the indices and A (13.1 MB): about 0.007 ms at 3.35
// TB/s.  Its plain version is some forty torch operations.
//
// What the design does about it: one CTA a unit.  The obs come in slices
// of kSlice: one thread a slot computes a_k and d_o from the packed obs
// table (x, y, z, radius, rinv, innov, level, level radius: one 32-byte row
// an ob), then the CTA gathers the slice's ye rows into shared memory twice,
// as y and as a_k y (rows padded to Mp = round4(M) with zeros).  Every
// thread owns a 4 x 4 tile of A and adds the slice's outer products from two
// float4 loads of the same row k per 16 FMAs (one FMA chain an entry in
// ascending k); the first Mp threads also sum b.  Past M = 128 the tiles
// outnumber 1024 threads and the CTA makes several passes over the obs.
// Past kSmallMembers (256) members, where one CTA would hold 2 x 32 x M
// floats and make M^2 / 16384 passes, a unit's A is dealt in blocks of
// 128 x 128 over CTAs of their own (lg_gram_tiles_kernel, one grid
// dimension over (unit, block)): each gathers a slice's rows of Y at its
// block's rows (as a_k y) and columns (as y), 32 KB of shared memory at
// any M, and evaluates the slice's a_k itself from the packed table (the
// same operations in the same order, so every block of a unit sees the
// same bits; K x 60 operations against the block's K x 2 x 128^2 FMAs);
// the blocks of the first column also sum b.  Each entry of A and b is
// the same FMA chain in ascending k as in the one-CTA kernel.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSlice = 32;
constexpr int kMaxThreads = 1024;
constexpr int kSmallMembers = 256;
constexpr int kBlk = 128;
constexpr int kObsCols = 8;
constexpr float kEarthRadiusKm = 6371.0f;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline int threads_for(int Mp) {
  const int tiles = (Mp / 4) * (Mp / 4);
  const int t = tiles < kMaxThreads ? tiles : kMaxThreads;
  return ((t > Mp ? t : Mp) + 31) / 32 * 32;
}

__host__ __device__ inline int smem_bytes(int Mp) {
  return 2 * kSlice * Mp * (int)sizeof(float);
}

// observation/localization.py gaspari_cohn, every operation rounded.
__device__ __forceinline__ float gaspari_cohn(float dist, float halfwidth) {
  const float r = __fdiv_rn(dist, fabsf(halfwidth));
  float p = __fmul_rn(-0.25f, r);
  p = __fadd_rn(p, 0.5f);
  p = __fadd_rn(__fmul_rn(p, r), 0.625f);
  p = __fsub_rn(__fmul_rn(p, r), (float)(5.0 / 3.0));
  const float inner = __fadd_rn(__fmul_rn(p, __fmul_rn(r, r)), 1.0f);
  const float rs = r > 0.0f ? r : 1.0f;
  float q = __fsub_rn(__fdiv_rn(r, 12.0f), 0.5f);
  q = __fadd_rn(__fmul_rn(q, r), 0.625f);
  q = __fadd_rn(__fmul_rn(q, r), (float)(5.0 / 3.0));
  q = __fsub_rn(__fmul_rn(q, r), 5.0f);
  q = __fadd_rn(__fmul_rn(q, r), 4.0f);
  const float outer = __fsub_rn(q, __fdiv_rn(2.0f, __fmul_rn(3.0f, rs)));
  return r <= 1.0f ? inner : (r < 2.0f ? outer : 0.0f);
}

// observation/localization.py _arccos_as (Abramowitz & Stegun 4.4.46).
__device__ __forceinline__ float arccos_as(float t) {
  const float x = fabsf(t);
  const float cs[7] = {0.0066700901f, -0.0170881256f, 0.0308918810f,
                       -0.0501743046f, 0.0889789874f, -0.2145988016f,
                       1.5707963050f};
  float p = -0.0012624911f;
#pragma unroll
  for (int i = 0; i < 7; ++i) p = __fadd_rn(__fmul_rn(p, x), cs[i]);
  const float a = __fmul_rn(__fsqrt_rn(fmaxf(__fsub_rn(1.0f, x), 0.0f)), p);
  return t >= 0.0f ? a : __fsub_rn((float)3.141592653589793, a);
}

// a_k of ob o at unit centroid (px, py, pz), level pv.
__device__ __forceinline__ float weight(const float* ob, float px, float py,
                                        float pz, float pv, int localize,
                                        int vertical) {
  float a = ob[4];
  if (localize) {
    float dot = __fadd_rn(__fadd_rn(__fmul_rn(px, ob[0]),
                                    __fmul_rn(py, ob[1])),
                          __fmul_rn(pz, ob[2]));
    dot = fminf(fmaxf(dot, -1.0f), 1.0f);
    float rho =
        gaspari_cohn(__fmul_rn(kEarthRadiusKm, arccos_as(dot)), ob[3]);
    if (vertical)
      rho = __fmul_rn(rho, gaspari_cohn(fabsf(__fsub_rn(pv, ob[6])), ob[7]));
    a = __fmul_rn(a, rho);
  }
  return a;
}

__global__ void __launch_bounds__(kMaxThreads) lg_gram_kernel(
    const float* ye, const float* obs, const long long* obs_var,
    const float* vl, int nv, const float* px, const float* pv,
    const long long* uv, const long long* ii, float* amat, float* b, int K,
    int M, int Mp, int localize) {
  extern __shared__ __align__(16) float smem[];
  float* Ya = smem;                // [kSlice, Mp]: a_k y_k
  float* Yl = smem + kSlice * Mp;  // [kSlice, Mp]: y_k
  __shared__ float as[kSlice], ds[kSlice];
  __shared__ long long os[kSlice];
  const int c = blockIdx.x, tid = threadIdx.x;
  const float cx = px[3 * c], cy = px[3 * c + 1], cz = px[3 * c + 2];
  const float cv = pv ? pv[c] : 0.0f;
  const float* vrow = vl ? vl + uv[c] * nv : nullptr;
  const long long* idx = ii + (long)c * K;
  const int Q = Mp / 4, tiles = Q * Q;
  for (int t0 = 0; t0 < tiles; t0 += blockDim.x) {
    const int task = t0 + tid;
    const bool on = task < tiles;
    const int rg = task / Q, cg = task - (task / Q) * Q;
    const bool first = t0 == 0;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float bacc = 0.f;
    for (int k0 = 0; k0 < K; k0 += kSlice) {
      const int kn = K - k0 < kSlice ? K - k0 : kSlice;
      if (tid < kn) {
        const long long o = idx[k0 + tid];
        const float* ob = obs + o * kObsCols;
        float a = weight(ob, cx, cy, cz, cv, localize, pv != nullptr);
        if (vrow) a = __fmul_rn(a, vrow[obs_var[o]]);
        as[tid] = a;
        ds[tid] = ob[5];
        os[tid] = o;
      }
      __syncthreads();
      for (int e = tid; e < kn * Mp; e += blockDim.x) {
        const int k = e / Mp, m = e - k * Mp;
        const float y = m < M ? ye[os[k] * M + m] : 0.0f;
        Yl[k * Mp + m] = y;
        Ya[k * Mp + m] = __fmul_rn(as[k], y);
      }
      __syncthreads();
      if (on) {
        for (int k = 0; k < kn; ++k) {
          const float4 av =
              *reinterpret_cast<const float4*>(Ya + k * Mp + 4 * rg);
          const float4 bv =
              *reinterpret_cast<const float4*>(Yl + k * Mp + 4 * cg);
          const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][0] = fmaf(ar[i], bv.x, acc[i][0]);
            acc[i][1] = fmaf(ar[i], bv.y, acc[i][1]);
            acc[i][2] = fmaf(ar[i], bv.z, acc[i][2]);
            acc[i][3] = fmaf(ar[i], bv.w, acc[i][3]);
          }
        }
      }
      if (first && tid < M)
        for (int k = 0; k < kn; ++k)
          bacc = fmaf(Ya[k * Mp + tid], ds[k], bacc);
      __syncthreads();
    }
    if (on) {
      float* out = amat + (long)c * M * M;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = 4 * rg + i, col = 4 * cg + j;
          if (r < M && col < M)
            out[r * M + col] =
                r == col ? __fadd_rn((float)(M - 1), acc[i][j]) : acc[i][j];
        }
    }
    if (first && tid < M) b[(long)c * M + tid] = bacc;
  }
}

// One 128 x 128 block of a unit's A (and, in the first block column, its
// rows of b): CTA blockIdx.x = unit x nbk^2 + block, 1024 threads of 4 x
// 4 tiles.
__global__ void __launch_bounds__(kMaxThreads) lg_gram_tiles_kernel(
    const float* ye, const float* obs, const long long* obs_var,
    const float* vl, int nv, const float* px, const float* pv,
    const long long* uv, const long long* ii, float* amat, float* b, int K,
    int M, int nbk, int localize) {
  __shared__ __align__(16) float Ya[kSlice][kBlk];  // a_k y_k, block rows
  __shared__ __align__(16) float Yl[kSlice][kBlk];  // y_k, block columns
  __shared__ float as[kSlice], ds[kSlice];
  __shared__ long long os[kSlice];
  const int nblk = nbk * nbk;
  const long bid = blockIdx.x;
  const int c = (int)(bid / nblk), blk = (int)(bid - (long)c * nblk);
  const int r0 = kBlk * (blk / nbk), c0 = kBlk * (blk - (blk / nbk) * nbk);
  const int tid = threadIdx.x, rg = tid >> 5, cg = tid & 31;
  const bool first = c0 == 0;
  const float cx = px[3 * c], cy = px[3 * c + 1], cz = px[3 * c + 2];
  const float cv = pv ? pv[c] : 0.0f;
  const float* vrow = vl ? vl + uv[c] * nv : nullptr;
  const long long* idx = ii + (long)c * K;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float bacc = 0.f;
  for (int k0 = 0; k0 < K; k0 += kSlice) {
    const int kn = K - k0 < kSlice ? K - k0 : kSlice;
    if (tid < kn) {
      const long long o = idx[k0 + tid];
      const float* ob = obs + o * kObsCols;
      float a = weight(ob, cx, cy, cz, cv, localize, pv != nullptr);
      if (vrow) a = __fmul_rn(a, vrow[obs_var[o]]);
      as[tid] = a;
      ds[tid] = ob[5];
      os[tid] = o;
    }
    __syncthreads();
    for (int e = tid; e < kn * kBlk; e += blockDim.x) {
      const int k = e / kBlk, m = e - k * kBlk;
      const float* yrow = ye + os[k] * M;
      const float yr = r0 + m < M ? yrow[r0 + m] : 0.0f;
      Ya[k][m] = __fmul_rn(as[k], yr);
      Yl[k][m] = c0 + m < M ? yrow[c0 + m] : 0.0f;
    }
    __syncthreads();
    for (int k = 0; k < kn; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&Ya[k][4 * rg]);
      const float4 bv = *reinterpret_cast<const float4*>(&Yl[k][4 * cg]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(ar[i], bv.x, acc[i][0]);
        acc[i][1] = fmaf(ar[i], bv.y, acc[i][1]);
        acc[i][2] = fmaf(ar[i], bv.z, acc[i][2]);
        acc[i][3] = fmaf(ar[i], bv.w, acc[i][3]);
      }
    }
    if (first && tid < kBlk)
      for (int k = 0; k < kn; ++k) bacc = fmaf(Ya[k][tid], ds[k], bacc);
    __syncthreads();
  }
  float* out = amat + (long)c * M * M;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + 4 * rg + i, col = c0 + 4 * cg + j;
      if (r < M && col < M)
        out[(long)r * M + col] =
            r == col ? __fadd_rn((float)(M - 1), acc[i][j]) : acc[i][j];
    }
  if (first && tid < kBlk && r0 + tid < M)
    b[(long)c * M + r0 + tid] = bacc;
}

}  // namespace

extern "C" {

// LG over the C units of a chunk: ye [No, M]; obs [No, 8] (x, y, z,
// radius, rinv, innov, level, level radius); obs_var [No] and vl [nvars,
// nv] (varloc, the table's rows the unit's variable) or nullptr; px [C, 3];
// pv [C] (vertical) or nullptr; uv [C] (varloc) or nullptr; ii [C, K];
// amat [C, M, M], b [C, M] out.  Returns a cudaError_t.
int efa_letkf_gram(const float* ye, const float* obs, const long long* obs_var,
                   const float* vl, int nv, const float* px, const float* pv,
                   const long long* uv, const long long* ii, float* amat,
                   float* b, int C, int K, int M, int localize,
                   void* stream) {
  if (M < 1 || C <= 0 || K < 0 || (vl && (!uv || !obs_var || nv < 1)))
    return (int)cudaErrorInvalidValue;
  if (M > kSmallMembers) {
    const int nbk = (M + kBlk - 1) / kBlk;
    const long ctas = (long)C * nbk * nbk;
    if (ctas > 0x7fffffffL) return (int)cudaErrorInvalidConfiguration;
    lg_gram_tiles_kernel<<<(unsigned)ctas, kMaxThreads, 0,
                           (cudaStream_t)stream>>>(
        ye, obs, obs_var, vl, nv, px, pv, uv, ii, amat, b, K, M, nbk,
        localize);
    return (int)cudaGetLastError();
  }
  const int Mp = round4(M);
  const int smem = smem_bytes(Mp);
  cudaError_t e = cudaFuncSetAttribute(
      lg_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  lg_gram_kernel<<<C, threads_for(Mp), smem, (cudaStream_t)stream>>>(
      ye, obs, obs_var, vl, nv, px, pv, uv, ii, amat, b, K, M, Mp,
      localize);
  return (int)cudaGetLastError();
}

}  // extern "C"
