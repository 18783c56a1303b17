// B1 and B1h: exact serial EnSRF solve of one observation panel, by
// sub-panels, over a thread-block cluster.
//
// Replaces: efa_xray_tpu/ops/tail_solve_pallas.py, _make_tail_solve_kernel
// (launched by tail_panel_solve_pallas), reached from
// efa_xray_tpu/assimilation/ensrf_core.py::_panel_solve_pallas.  B1h, the
// hybrid instantiation (kHybrid), has no TPU kernel: it carries the static
// column of ensrf_core.tail_scan, which the JAX package solves with its
// plain scan.  B1e, the stochastic EnKF's instantiation (kEnkf), has no TPU
// kernel either: it solves efa_xray_tpu/assimilation/enkf.py::
// enkf_tail_scan (a lax.scan there) panel by panel.
//
// What it computes, for each ob i of the panel in order (f = assim flag):
//   ye = tp[i, :];  varye_e = var(ye) (ddof 0, or 1 when unbiased)
//   varye = varye_e, or alpha varye_e + (1 - alpha) sig_i^2 (B1h)
//   innov = value_i - tm[i];  kdenom = varye + R_i
//   scale = 1 / (kdenom (M - 1));  beta = 1 / (1 + sqrt(R_i / kdenom))
//   kmat_j = (tp[j, :] . ye) w[i, j] scale                  for every row j
//   (B1h: kmat_j = alpha kmat_j + (1 - alpha) sig_j sig_i gc[i, j] / kdenom)
//   tm[j] += (f innov) kmat_j;   tp[j, :] -= ((f beta) kmat_j) ye
// and emits the ye sequence, the gain/sqrt coefficients (times alpha in
// B1h), B1h's static-column scalars (1 - alpha) sig_i f {innov, beta} /
// kdenom, and the prior and posterior obs-space mean and variance (NaN
// where skipped; the posterior row i is (1 - beta kmat_i) ye, so post_var =
// (1 - beta kmat_i)^2 varye_e).
//
// B1e (kEnkf) takes the panel's perturbed-ob draws eps [P, M] and applies
// each ob's full gain to its departure row z_i = ye - eps[i, :]:
//   gain = f innov scale, sqrt = f scale (no beta);
//   tm[j] += (f innov) kmat_j;   tp[j, :] -= (f kmat_j) z_i
// and emits the z rows too.  The rank update of the other rows then runs
// against G = Z Y^T (z_p . ye_t, not symmetric) and applies X -= V Z, and
// the posterior variance of row i is taken from the updated row itself.
//
// What bounds it on an H100: the serial chain, not arithmetic or bytes.  A
// 512 x 80 panel is 42M FMAs (under a microsecond of the card, a third of a
// millisecond of one SM) in 512 dependent steps.  One thread per row with
// the slab in one CTA took 5.6 us a step: three CTA barriers, a reduction by
// warp 0 while 15 warps waited, and the whole [P, M] slab streamed through
// one SM's shared memory twice (480 KB a step); and a slab over 227 KB (512
// obs x 112 members, or 1024 x 80) cannot sit in one CTA at all.
//
// What the design does about it.
// 1. Sub-panels (the right-looking form that won on B3/B4).  For each
//    sub-panel of kSub obs (8 or 16): warp 0 of the CTA that owns its rows
//    runs the kSub-step serial problem on those rows alone, with each
//    step's sums (the shifted mean and variance and the kSub covariances)
//    in one butterfly of shuffles and no CTA barrier; then every other row
//    of the panel takes one rank-kSub update, ensrf_core._block_recurrence
//    inside the panel: D0 = X Y^T, a kSub-step forward substitution against
//    G = Y Y^T (B1h: plus the static column), xm += U gain, X -= V Y.  The
//    slab crosses shared memory twice per sub-panel instead of twice per ob,
//    and there are two barriers per sub-panel instead of three per ob.
// 2. A cluster of 1, 2, 4 or 8 CTAs deals the rows out in equal blocks of
//    whole sub-panels (the wrapper pads the panel).  The owner of a
//    sub-panel writes its Y rows, G and coefficients into every CTA's
//    shared memory (distributed shared memory), and each step ends at a
//    cluster barrier.  Each CTA holds only its share of the slab: 1024 x
//    256 x 4 B is 128 KB a CTA at 8.  The wrapper picks the smallest
//    cluster that fits (ops/tail_solve.py pick_cluster, from MIN_CLUSTER
//    on).
// 3. The weight rows w[i0:i0+kSub, own rows] (and B1h's static rows)
//    stream through a two-slot cp.async ring, one sub-panel ahead.
// 4. Where a CTA has fewer rows than threads, 2, 4 or 8 threads share a row
//    in the rank update (strided members, D0 summed by shuffles).
// 5. The warp's steps issue every member slot of the sub-panel's rows, so
//    the solve is built for 3 slots a lane (up to 96 members) as well as 8:
//    at 80 members that took B1 from 0.50 to 0.40 of the one-CTA kernel's
//    time (PERF.md).  Past 256 members the wide instantiation (kWide)
//    takes each step's sums over chunks of 256 members, 8 a lane, then
//    reads the row again chunk by chunk for its writes: any ensemble.
// 6. Where no cluster of 8 holds its shares of the slab (512 members at
//    panels of 1024, or any ensemble past about 440 members at panels of
//    512), the wide instantiation keeps the rows in tp_out in device
//    memory (L2-resident: 2 MB at 1024 x 512), each CTA's own, and the
//    sub-panel's Y (Z), G and coefficients in a device scratch ring that
//    every CTA of the cluster reads after the cluster barrier (L2 loads,
//    __ldcg) instead of pushing them into each CTA (`global`, a runtime
//    flag of the wide instantiation, so that one build serves both).
//    Shared memory then holds the weight rings and the per-row scalars
//    only, so any ensemble runs at any panel.
// Plain fp32 FMA throughout; no tensor cores.
//
// Shared memory (floats; make_layout below, mirrored by ops/tail_solve.py
// smem_bytes): weight ring [2][kSub][Pc] (and the static ring), Y [2][M]
// [kSub] (transposed, so a row's kSub values are float4 loads), (B1e: Z
// [2][M][kSub] likewise), G [2][kSub][kSub], coefficients [2][4][kSub], the
// rows X [Pc][M | 1] (odd stride: one thread per row reads 32 banks), tm,
// (sigma), value, error, flag [Pc]; a `global` launch keeps the rings and
// the rows in device memory instead.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// Members per lane in the warp's solve (a chunk of 256 members at a time
// past 256), and the fewer slots the solve is also built for (ensembles up
// to 96 members then issue no work for empty slots).
constexpr int kMaxLanes = 8;
constexpr int kChunk = 32 * kMaxLanes;
constexpr int kFewLanes = 3;
constexpr int kSlots = 2;
// Per-ob scalars of a sub-panel: gain, sqrt_coef, static gain, static sqrt.
constexpr int kCoef = 4;
constexpr int kMaxThreads = 512;
constexpr int kMaxSmemBytes = 232448;
// Parts of the kernel that a build with -DEFA_TAIL_SKIP=<bits> leaves out,
// to time what each costs (no profiler sees inside a kernel here): the
// results of such a build are wrong.  0 in every build that is used.
#ifndef EFA_TAIL_SKIP
#define EFA_TAIL_SKIP 0
#endif
constexpr int kSkipSteps = 1, kSkipGram = 2, kSkipPush = 4, kSkipUpdate = 8;
// Sub-panels of 16 obs are built only with -DEFA_TAIL_SUB16=1 (for
// timing): measured slower than 8 at every shape, and their unrolled steps
// take most of the build.
#ifndef EFA_TAIL_SUB16
#define EFA_TAIL_SUB16 0
#endif
__host__ __device__ constexpr bool skips(int part) {
  return (EFA_TAIL_SKIP & part) != 0;
}

struct Layout {
  int wring, gring, yt, zt, g, coef, x, tm, sig, vals, errs, flags, total;
};

// In shared memory (global = false), or with the rows and the rings in
// device memory (global: their offsets index the scratch ring, X none).
__host__ __device__ inline Layout make_layout(int Pc, int M, int sub,
                                              bool hybrid, bool enkf,
                                              bool global = false) {
  Layout L;
  int o = 0;
  L.wring = o;
  o += kSlots * sub * Pc;
  L.gring = o;
  o += hybrid ? kSlots * sub * Pc : 0;
  int r = 0;  // the ring's offsets
  int& ro = global ? r : o;
  L.yt = ro;
  ro += kSlots * M * sub;
  L.zt = ro;
  ro += enkf ? kSlots * M * sub : 0;
  L.g = ro;
  ro += kSlots * sub * sub;
  L.coef = ro;
  ro += kSlots * kCoef * sub;
  L.x = o;
  o += global ? 0 : Pc * (M | 1);
  L.tm = o;
  o += Pc;
  L.sig = o;
  o += hybrid ? Pc : 0;
  L.vals = o;
  o += Pc;
  L.errs = o;
  o += Pc;
  L.flags = o;
  o += Pc;
  L.total = o;
  return L;
}

long long smem_bytes(int Pc, int M, int sub, bool hybrid, bool enkf,
                     bool global = false) {
  return (long long)sizeof(float) *
         make_layout(Pc, M, sub, hybrid, enkf, global).total;
}

// Whether the slab stays in device memory: its shares do not fit a CTA.
bool in_global(int Pc, int M, int sub, bool hybrid, bool enkf) {
  return smem_bytes(Pc, M, sub, hybrid, enkf) > kMaxSmemBytes;
}

// A scratch-ring word (global: written by another CTA of the cluster
// before the cluster barrier, read from L2) or a shared one.
__device__ __forceinline__ float ld(const float* p, bool global) {
  return global ? __ldcg(p) : *p;
}
__device__ __forceinline__ float4 ld4(const float* p, bool global) {
  return global ? __ldcg(reinterpret_cast<const float4*>(p))
                : *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous copy of 16 bytes (both addresses 16-byte aligned).
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
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

struct Args {
  const float* tm_in;           // [P]
  const float* tp_in;           // [P, M]
  const float* vals;            // [P]
  const float* errs;            // [P]
  const unsigned char* assim;   // [P] 0/1
  const float* w;               // [P, P] w[i, j]; nullptr = no localization
  const float* gc;              // [P, P] static correlation (B1h)
  const float* sig;             // [P] static std (B1h)
  const float* eps;             // [P, M] perturbed-ob draws (B1e)
  float* ring;                  // global: the scratch ring
  float alpha;
  int P, M, unbiased, cluster, tpr;
  float* tm_out;                // [P]
  float* tp_out;                // [P, M]
  float* ye_out;                // [P, M]
  float* gain_out;              // [P] (each [P] below)
  float* sqrt_out;
  float* pm_out;
  float* pv_out;
  float* om_out;
  float* ov_out;
  float* sg_out;                // B1h
  float* ss_out;                // B1h
  float* z_out;                 // [P, M] B1e
};

// The shared arrays of one CTA.
struct Smem {
  float *wring, *gring, *yt, *zt, *g, *coef, *x, *tm, *sig, *vals, *errs,
      *flags;
};

__device__ __forceinline__ void cluster_sync(int C) {
  if (C > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// Warp 0 of the owning CTA: the serial solve of sub-panel k (obs and rows
// k kSub .. k kSub + kSub - 1, local rows il0 ..), then its Gram matrix,
// and the sub-panel's Y (B1e: and Z), G and coefficients pushed into every
// CTA (global: left in the device ring).  kChunked: the members in chunks
// of kLanes a lane, any M.
template <bool kHybrid, bool kEnkf, int kSub, int kLanes, bool kChunked>
__device__ void solve_subpanel(const Args& a, const Smem& s, int k, int il0,
                               int slot, int Pc, int S, int rank,
                               bool global) {
  const int lane = threadIdx.x & 31;
  const int M = a.M;
  const float vden = a.unbiased ? (float)(M - 1) : (float)M;
  const float nan = __int_as_float(0x7fc00000);
  const float alpha = a.alpha;
  float* rows = s.x + il0 * S;
  const float* wslot = s.wring + slot * kSub * Pc + il0;
  const float* gslot = s.gring + slot * kSub * Pc + il0;
  float* ys = s.yt + slot * M * kSub;
  float* zs = s.zt + slot * M * kSub;
  float* coef = s.coef + slot * kCoef * kSub;

  float tmv[kSub], sgr[kSub];
#pragma unroll
  for (int r = 0; r < kSub; ++r) {
    tmv[r] = s.tm[il0 + r];
    sgr[r] = kHybrid ? s.sig[il0 + r] : 0.f;
  }
  // The steps are unrolled, so every row and register index is fixed (a
  // rolled loop timed within the spread between machines: PERF.md).
  // Lane l holds members l, l + 32, ... of row t in registers; the slots
  // past M are predicated off, not branched around, so that each step is
  // one block of straight-line code.
  const float inv_m = 1.f / (float)M, inv_vden = 1.f / vden;
  const float inv_m1 = 1.f / (float)(M - 1);
  const int nchunk = kChunked ? (M + 32 * kLanes - 1) / (32 * kLanes) : 1;
#pragma unroll
  for (int t = 0; t < (skips(kSkipSteps) ? 0 : kSub); ++t) {
    const int gi = k * kSub + t;
    // Row t as it stands after the sub-panel's earlier obs (written by
    // every lane: hence the __syncwarp); its sums are taken about its
    // first member, so the variance does not cancel.
    __syncwarp();
    const float* yt = rows + t * S;
    float ye[kLanes], z[kLanes];
    // Row t's members m0 + q 32 + lane (and B1e's departures).
    const auto load = [&](int m0) {
#pragma unroll
      for (int q = 0; q < kLanes; ++q) {
        const int m = m0 + q * 32 + lane;
        ye[q] = (m < M) ? yt[m] : 0.f;
        // B1e: the departure row z = ye - eps[gi, :]; the square root
        // applies ye itself.
        z[q] = kEnkf ? ((m < M) ? ye[q] - a.eps[(long)gi * M + m] : 0.f)
                     : ye[q];
      }
    };
    const float c0 = yt[0];
    float red[kSub + 2];
#pragma unroll
    for (int v = 0; v < kSub + 2; ++v) red[v] = 0.f;
    for (int ch = 0; ch < nchunk; ++ch) {
      const int m0 = ch * 32 * kLanes;
      load(m0);
#pragma unroll
      for (int q = 0; q < kLanes; ++q) {
        const int m = m0 + q * 32 + lane;
        if (m < M) {
          const float dv = ye[q] - c0;
          red[kSub] += dv;
          red[kSub + 1] += dv * dv;
#pragma unroll
          for (int r = 0; r < kSub; ++r) red[r] += rows[r * S + m] * ye[q];
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int v = 0; v < kSub + 2; ++v)
        red[v] += __shfl_xor_sync(0xffffffffu, red[v], o);
    }
    const float sd = red[kSub];
    const float varye_e =
        fmaxf(red[kSub + 1] - sd * sd * inv_m, 0.f) * inv_vden;
    float mye = 0.f, sgt = 0.f;
#pragma unroll
    for (int r = 0; r < kSub; ++r) {
      if (r == t) {
        mye = tmv[r];
        sgt = sgr[r];
      }
    }
    const float varye =
        kHybrid ? alpha * varye_e + (1.f - alpha) * sgt * sgt : varye_e;
    const float r_err = s.errs[il0 + t];
    const float innov = s.vals[il0 + t] - mye;
    const float kdenom = varye + r_err;
    // Reciprocals rounded to nearest (MUFU plus a correction), not the
    // division routine: the chain of one step is what bounds the solve.
    const float inv_kd = __frcp_rn(kdenom);
    const float scale = inv_kd * inv_m1;
    // B1e applies the full gain: beta = 1.
    const float beta =
        kEnkf ? 1.f : __frcp_rn(1.f + __fsqrt_rn(r_err * inv_kd));
    const float f = s.flags[il0 + t];
    const float fi = f * innov, fb = f * beta;
    const float sfac = kHybrid ? (1.f - alpha) * sgt * inv_kd : 0.f;
    float kt = 0.f, cr[kSub];
#pragma unroll
    for (int r = 0; r < kSub; ++r) {
      float km = red[r] * (a.w ? wslot[t * Pc + r] : 1.f) * scale;
      if (kHybrid) km = alpha * km + sfac * sgr[r] * gslot[t * Pc + r];
      if (r == t) kt = km;
      tmv[r] += fi * km;
      cr[r] = fb * km;
    }
    float crt = 0.f;
#pragma unroll
    for (int r = 0; r < kSub; ++r)
      if (r == t) crt = cr[r];
    // B1e: the sums of row t after its own ob, about its first member.
    float post[2] = {0.f, 0.f};
    const float c1 = kEnkf ? c0 - crt * (c0 - a.eps[(long)gi * M]) : 0.f;
    for (int ch = 0; ch < nchunk; ++ch) {
      const int m0 = ch * 32 * kLanes;
      // Chunked, the row is read again (its chunk is not yet written).
      if (kChunked) load(m0);
#pragma unroll
      for (int q = 0; q < kLanes; ++q) {
        const int m = m0 + q * 32 + lane;
        if (m < M) {
          a.ye_out[(long)gi * M + m] = ye[q];
          ys[m * kSub + t] = ye[q];
          if (kEnkf) {
            a.z_out[(long)gi * M + m] = z[q];
            zs[m * kSub + t] = z[q];
            const float dv = ye[q] - crt * z[q] - c1;
            post[0] += dv;
            post[1] += dv * dv;
          }
#pragma unroll
          for (int r = 0; r < kSub; ++r) rows[r * S + m] -= cr[r] * z[q];
        }
      }
    }
    if (kEnkf) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        post[0] += __shfl_xor_sync(0xffffffffu, post[0], o);
        post[1] += __shfl_xor_sync(0xffffffffu, post[1], o);
      }
    }
    if (lane == 0) {
      const float ens = kHybrid ? alpha : 1.f;
      const float gain = ens * (fi * scale), sq = ens * (fb * scale);
      const bool as = f != 0.f;
      const float shrink = 1.f - beta * kt;
      const float post_var =
          kEnkf ? fmaxf(post[1] - post[0] * post[0] * inv_m, 0.f) * inv_vden
                : shrink * shrink * varye_e;
      a.gain_out[gi] = gain;
      a.sqrt_out[gi] = sq;
      a.pm_out[gi] = mye;
      a.pv_out[gi] = varye;
      a.om_out[gi] = as ? mye + kt * innov : nan;
      a.ov_out[gi] = as ? post_var : nan;
      coef[t] = gain;
      coef[kSub + t] = sq;
      coef[2 * kSub + t] = sfac * fi;
      coef[3 * kSub + t] = sfac * fb;
      if (kHybrid) {
        a.sg_out[gi] = sfac * fi;
        a.ss_out[gi] = sfac * fb;
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kSub; ++r) s.tm[il0 + r] = tmv[r];
  }
  __syncwarp();
  // G[p][t] = a_p . ye_t for p < t (a = ye, B1e: z), one pair per lane at a
  // time.
  const float* as_ = kEnkf ? zs : ys;
  float* g = s.g + slot * kSub * kSub;
  constexpr int kPairs = kSub * (kSub - 1) / 2;
  for (int e = lane; e < (skips(kSkipGram) ? 0 : kPairs); e += 32) {
    int t = 1;
    while (t * (t + 1) / 2 <= e) ++t;
    const int p = e - t * (t - 1) / 2;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int m = 0;
    for (; m + 4 <= M; m += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        acc[u] += ld(as_ + (m + u) * kSub + p, global) *
                  ld(ys + (m + u) * kSub + t, global);
    }
    for (; m < M; ++m)
      acc[0] += ld(as_ + m * kSub + p, global) *
                ld(ys + m * kSub + t, global);
    g[p * kSub + t] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
  __syncwarp();
  if (!global && a.cluster > 1 && !skips(kSkipPush)) {
    cg::cluster_group cl = cg::this_cluster();
    const float4* y4 = reinterpret_cast<const float4*>(ys);
    const float4* z4 = reinterpret_cast<const float4*>(zs);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const float4* c4 = reinterpret_cast<const float4*>(coef);
    for (int r = 0; r < a.cluster; ++r) {
      if (r == rank) continue;
      float4* dy = reinterpret_cast<float4*>(cl.map_shared_rank(ys, r));
      float4* dg = reinterpret_cast<float4*>(cl.map_shared_rank(g, r));
      float4* dc = reinterpret_cast<float4*>(cl.map_shared_rank(coef, r));
      for (int e = lane; e < M * kSub / 4; e += 32) dy[e] = y4[e];
      if (kEnkf) {
        float4* dz = reinterpret_cast<float4*>(cl.map_shared_rank(zs, r));
        for (int e = lane; e < M * kSub / 4; e += 32) dz[e] = z4[e];
      }
      for (int e = lane; e < kSub * kSub / 4; e += 32) dg[e] = g4[e];
      for (int e = lane; e < kCoef * kSub / 4; e += 32) dc[e] = c4[e];
    }
  }
}

// Every row of this CTA outside the sub-panel: one rank-kSub update (B1e:
// X -= V Z).
// kWide: `global` (else shared rings) is the launch's.
template <bool kHybrid, bool kEnkf, int kSub, bool kWide>
__device__ void rank_update(const Args& a, const Smem& s, int skip0,
                            int slot, int Pc, int S, bool wide_global) {
  const bool global = kWide && wide_global;
  const int M = a.M;
  const int tpr = a.tpr;
  const int tid = threadIdx.x;
  const int groups = blockDim.x / tpr;
  const int q = tid % tpr, grp = tid / tpr;
  const float* wslot = s.wring + slot * kSub * Pc;
  const float* gslot = s.gring + slot * kSub * Pc;
  const float* ys = s.yt + slot * M * kSub;
  const float* as_ = kEnkf ? s.zt + slot * M * kSub : ys;
  const float* g = s.g + slot * kSub * kSub;
  const float* coef = s.coef + slot * kCoef * kSub;
  const int passes = (Pc + groups - 1) / groups;
  for (int pass = 0; pass < passes; ++pass) {
    const int jl = pass * groups + grp;
    const bool mine = jl < Pc && (jl < skip0 || jl >= skip0 + kSub);
    float* x = s.x + jl * S;
    float d[kSub];
#pragma unroll
    for (int t = 0; t < kSub; ++t) d[t] = 0.f;
    if (mine) {
      for (int m = q; m < M; m += tpr) {
        const float xv = x[m];
#pragma unroll
        for (int t4 = 0; t4 < kSub / 4; ++t4) {
          const float4 y = ld4(ys + m * kSub + 4 * t4, global);
          d[4 * t4] += xv * y.x;
          d[4 * t4 + 1] += xv * y.y;
          d[4 * t4 + 2] += xv * y.z;
          d[4 * t4 + 3] += xv * y.w;
        }
      }
    }
    for (int o = 1; o < tpr; o <<= 1) {
#pragma unroll
      for (int t = 0; t < kSub; ++t)
        d[t] += __shfl_xor_sync(0xffffffffu, d[t], o);
    }
    if (!mine) continue;
    float v[kSub];
    float mean = 0.f;
    const float sj = kHybrid ? s.sig[jl] : 0.f;
#pragma unroll
    for (int t = 0; t < kSub; ++t) {
      float dt = d[t];
#pragma unroll
      for (int p = 0; p < t; ++p) dt -= v[p] * ld(g + p * kSub + t, global);
      const float u = a.w ? wslot[t * Pc + jl] * dt : dt;
      v[t] = ld(coef + kSub + t, global) * u;
      mean += ld(coef + t, global) * u;
      if (kHybrid) {
        const float col = sj * gslot[t * Pc + jl];
        v[t] += ld(coef + 3 * kSub + t, global) * col;
        mean += ld(coef + 2 * kSub + t, global) * col;
      }
    }
    if (q == 0) s.tm[jl] += mean;
    for (int m = q; m < M; m += tpr) {
      float acc = x[m];
#pragma unroll
      for (int t4 = 0; t4 < kSub / 4; ++t4) {
        const float4 y = ld4(as_ + m * kSub + 4 * t4, global);
        acc -= v[4 * t4] * y.x;
        acc -= v[4 * t4 + 1] * y.y;
        acc -= v[4 * t4 + 2] * y.z;
        acc -= v[4 * t4 + 3] * y.w;
      }
      x[m] = acc;
    }
  }
}

// kWide: the chunked solve (any M) and, where a.ring is given (global),
// the rows in tp_out and the rings in a.ring (device memory).
template <bool kHybrid, bool kEnkf, int kSub, bool kWide>
__global__ void __launch_bounds__(kMaxThreads, 1)
    tail_solve_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int C = a.cluster;
  const int rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const bool global = kWide && a.ring != nullptr;
  const int P = a.P, M = a.M, S = global ? M : M | 1, Pc = P / C;
  const int row0 = rank * Pc;
  const int tid = threadIdx.x, nth = blockDim.x;
  const Layout L = make_layout(Pc, M, kSub, kHybrid, kEnkf, global);
  float* ring = global ? a.ring : smem;
  const Smem s{smem + L.wring, smem + L.gring, ring + L.yt,  ring + L.zt,
               ring + L.g,     ring + L.coef,
               global ? a.tp_out + (long)row0 * M : smem + L.x,
               smem + L.tm,    smem + L.sig,   smem + L.vals, smem + L.errs,
               smem + L.flags};

  // The weight rows of sub-panel k (and B1h's static rows) at this CTA's
  // rows, into ring slot `slot`.
  auto fetch = [&](int k, int slot) {
    const int n4 = Pc / 4;
    for (int e = tid; e < kSub * n4; e += nth) {
      const int t = e / n4, c4 = e - t * n4;
      const long src = (long)(k * kSub + t) * P + row0 + 4 * c4;
      const int dst = slot * kSub * Pc + t * Pc + 4 * c4;
      if (a.w) cp_async16(s.wring + dst, a.w + src);
      if (kHybrid) cp_async16(s.gring + dst, a.gc + src);
    }
    cp_async_commit();
  };

  fetch(0, 0);
  for (int idx = tid; idx < Pc * M; idx += nth) {
    const int j = idx / M, m = idx - j * M;
    s.x[j * S + m] = a.tp_in[(long)row0 * M + idx];
  }
  for (int j = tid; j < Pc; j += nth) {
    s.tm[j] = a.tm_in[row0 + j];
    s.vals[j] = a.vals[row0 + j];
    s.errs[j] = a.errs[row0 + j];
    s.flags[j] = a.assim[row0 + j] ? 1.f : 0.f;
    if (kHybrid) s.sig[j] = a.sig[row0 + j];
  }
  // Every CTA of the cluster is running before any writes into another.
  cluster_sync(C);

  const int nsub = P / kSub, per_cta = Pc / kSub;
  for (int k = 0; k < nsub; ++k) {
    const int slot = k & 1;
    // Sub-panel k's weights have landed; this CTA's update of sub-panel
    // k - 1 is done (so the owner's rows are current and slot ^ 1 is free).
    cp_async_wait_all();
    __syncthreads();
    if (k + 1 < nsub) fetch(k + 1, slot ^ 1);
    const int owner = k / per_cta;
    const int il0 = (k - owner * per_cta) * kSub;
    if (rank == owner && tid < 32) {
      if (kWide)
        solve_subpanel<kHybrid, kEnkf, kSub, kMaxLanes, true>(
            a, s, k, il0, slot, Pc, S, rank, global);
      else if (M <= 32 * kFewLanes)
        solve_subpanel<kHybrid, kEnkf, kSub, kFewLanes, false>(
            a, s, k, il0, slot, Pc, S, rank, false);
      else
        solve_subpanel<kHybrid, kEnkf, kSub, kMaxLanes, false>(
            a, s, k, il0, slot, Pc, S, rank, false);
    }
    cluster_sync(C);
    if (!skips(kSkipUpdate))
      rank_update<kHybrid, kEnkf, kSub, kWide>(
          a, s, rank == owner ? il0 : Pc, slot, Pc, S, global);
  }
  __syncthreads();
  for (int idx = tid; !global && idx < Pc * M; idx += nth) {
    const int j = idx / M, m = idx - j * M;
    a.tp_out[(long)row0 * M + idx] = s.x[j * S + m];
  }
  for (int j = tid; j < Pc; j += nth) a.tm_out[row0 + j] = s.tm[j];
}

template <bool kHybrid, bool kEnkf, int kSub, bool kWide = false>
cudaError_t launch(const Args& a, int threads, int smem,
                   cudaStream_t stream) {
  auto kernel = tail_solve_kernel<kHybrid, kEnkf, kSub, kWide>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

// The launch of one panel (P a multiple of sub x cluster: the wrapper
// pads): threads per CTA and per row, then the instantiation.
// wide: past kChunk members, or with the slab in device memory (a.ring).
cudaError_t run(Args a, int sub, int smem, cudaStream_t s, bool hybrid,
                bool enkf, bool wide) {
  const int Pc = a.P / a.cluster;
  // One thread per row up to 512 rows; below 256 rows a CTA keeps 256
  // threads and shares each row among 2, 4 or 8 of them.
  const int threads = Pc >= kMaxThreads ? kMaxThreads : 256;
  int tpr = 1;
  while (tpr < 8 && Pc * tpr * 2 <= threads) tpr *= 2;
  a.tpr = tpr;
  cudaError_t e;
  if (sub == 8 && wide) {
    e = enkf     ? launch<false, true, 8, true>(a, threads, smem, s)
        : hybrid ? launch<true, false, 8, true>(a, threads, smem, s)
                 : launch<false, false, 8, true>(a, threads, smem, s);
  } else if (sub == 8) {
    e = enkf     ? launch<false, true, 8>(a, threads, smem, s)
        : hybrid ? launch<true, false, 8>(a, threads, smem, s)
                 : launch<false, false, 8>(a, threads, smem, s);
  } else if (wide) {
    return cudaErrorInvalidValue;
  } else {
#if EFA_TAIL_SUB16
    e = hybrid ? launch<true, false, 16>(a, threads, smem, s)
               : launch<false, false, 16>(a, threads, smem, s);
#else
    return cudaErrorInvalidValue;
#endif
  }
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

bool bad_shape(int P, int M, int sub, int cluster) {
  return (sub != 8 && sub != 16) ||
         (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
         P <= 0 || P % (sub * cluster) != 0 || M < 2;
}

// The launch of either instantiation (eps given: B1e; gc and sig: B1h),
// the slab in shared memory where its shares fit, else in device memory
// with the scratch ring `ring` (make_layout's ring offsets, global).
int launch_panel(Args a, int sub, void* stream) {
  const bool hybrid = a.gc != nullptr, enkf = a.eps != nullptr;
  if (bad_shape(a.P, a.M, sub, a.cluster) || hybrid != (a.sig != nullptr) ||
      (hybrid && (!a.sg_out || !a.ss_out)) || (hybrid && enkf) ||
      (enkf && (sub != 8 || !a.z_out)))
    return (int)cudaErrorInvalidValue;
  const int Pc = a.P / a.cluster;
  const bool global = in_global(Pc, a.M, sub, hybrid, enkf);
  const long long smem = smem_bytes(Pc, a.M, sub, hybrid, enkf, global);
  if (smem > kMaxSmemBytes || global != (a.ring != nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)run(a, sub, (int)smem, (cudaStream_t)stream, hybrid, enkf,
                  global || a.M > kChunk);
}

}  // namespace

extern "C" {

// Shared memory of one CTA owning `rows` rows (for the wrapper's check),
// the slab's shares in it where they fit; kind 0 B1, 1 B1h, 2 B1e.
int efa_tail_solve_smem(int rows, int M, int sub, int kind) {
  return (int)smem_bytes(rows, M, sub, kind == 1, kind == 2,
                         in_global(rows, M, sub, kind == 1, kind == 2));
}

// Every instantiation behind one entry: B1, B1h (gc and sig given) or B1e
// (eps and z_out given; sub-panels of 8); ring: the scratch ring of
// make_layout's global offsets in device memory where the slab's shares
// do not fit the cluster's shared memory (in_global), else nullptr.  P must be a
// multiple of sub x cluster (the wrapper pads).  Returns a cudaError_t.
int efa_tail_launch(const float* tm_in, const float* tp_in,
                    const float* vals, const float* errs,
                    const unsigned char* assim, const float* w,
                    const float* gc, const float* sig, const float* eps,
                    float* ring, float alpha, int P, int M, int unbiased,
                    int sub, int cluster, float* tm_out, float* tp_out,
                    float* ye_out, float* z_out, float* gain_out,
                    float* sqrt_out, float* pm_out, float* pv_out,
                    float* om_out, float* ov_out, float* sg_out,
                    float* ss_out, void* stream) {
  Args a{tm_in,  tp_in,   vals,    errs,     assim,  w,        gc,
         sig,    eps,     ring,    alpha,    P,      M,        unbiased,
         cluster, 0,      tm_out,  tp_out,   ye_out, gain_out, sqrt_out,
         pm_out, pv_out,  om_out,  ov_out,   sg_out, ss_out,   z_out};
  return launch_panel(a, sub, stream);
}

}  // extern "C"
