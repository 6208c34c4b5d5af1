// The reduce-mode observers' per-chain folds and their per-CTA partial
// rows, shared by the block step (block_step.cuh: K8 alone), the
// observer fold (wide_fold.cu obs_fold: K8 + K9 over the producer's
// arrays) and the wide fold (wide_fold.cu: K4 merges): one chain per
// thread, THREADS threads per 128-chain group.
//
// TelField is obs/telemetry.py fold_second's per-field fold, FltChain with
// flt_second its analytics fold (obs/analytics.py fold_second, without the
// level-full regime sums, which need the cloud state).  At block end each
// chain group reduces its chains' leaves (warp butterflies in double, then
// the 4 warps in order) into a partial row, and collapse_partials
// (block_step.cu) combines the rows over groups in index order: sums in
// double, rounded once by the caller, so reruns give the same bits.
// Histograms count with integer atomics (in shared memory, flushed with
// one atomicAdd per non-zero slot, or in global memory when too large):
// every count is exact and order-free.  The exceedance slots count in
// registers against thresholds passed by value (up to MAX_THR; with
// ascending thresholds slot k is the used samples above threshold k - 1
// less those above threshold k), reduced over the warp before one atomic
// per slot (exc_count, exc_flush: the scenario fold's too); past MAX_THR
// one atomic per used sample.
// Which ramp grids a second closes is worked out once per CTA into
// shared memory (ramp_flags): no modulo per chain-second.
#pragma once
#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

#include "nanminmax.cuh"

#define THREADS 128
#define WARPS (THREADS / 32)

// per-CTA partial leaves: telemetry 6 per field x 4 fields + the covered
// count; analytics (see FltLeaf); per cohort 6 (count, sums of meter, pv,
// residual, min, max of residual)
#define TEL_LEAVES 25
#define TEL_CHAIN_I 9
#define TEL_CHAIN_F 16
#define CSI_BINS 8
enum FltLeaf { F_COUNT = 0, F_MIN, F_MAX, F_LOLS, F_LOLE, F_R1, F_R2, F_R3,
               F_COV, F_SM, F_SP, F_SR, F_CSM, F_CSP, F_CSR, FLT_LEAVES };
#define FLT_CHAIN_I 8
#define FLT_CHAIN_F 14
#define COH_LEAVES 6
// the most thresholds whose exceedance slots count in registers (the
// observer, wide and scenario folds; kernels/block_step.py MAX_THR)
#define MAX_THR 8
static_assert(MAX_THR == 8, "Obs::thr_v and Scen::thr_v hold MAX_THR floats");
enum Kind { K_SUM = 0, K_MIN = 1, K_MAX = 2 };

// the observers' arguments
struct Obs {
  // K8 telemetry
  int tel_full;
  double* tel_part;      // (n_ctas, TEL_LEAVES)
  int* csi_hist;         // (CSI_BINS,), zeroed by the caller
  float* tel_count;      // (1,)
  int* tel_chain_i;      // optional (TEL_CHAIN_I, n)
  float* tel_chain_f;    // optional (TEL_CHAIN_F, n)
  // K9 analytics
  int flt_full, bins, n_thr, lolp_k, n_cohorts, hist_shared, coh_shared;
  int ramp_w[3];
  float lo, inv_w, capacity;
  const float* thr;      // (n_thr,), ascending
  float thr_v[8];        // the first MAX_THR of them, then +inf
  int* res_hist;         // (bins + 2,), zeroed by the caller
  int* exceed;           // (n_thr + 1,), zeroed
  int* cohort_hist;      // (n_cohorts, bins + 2), zeroed
  const int* cohort;     // (n,)
  double* flt_part;      // (n_ctas, FLT_LEAVES)
  double* coh_part;      // (n_ctas, n_cohorts, COH_LEAVES)
  int* flt_chain_i;      // optional (FLT_CHAIN_I, n)
  float* flt_chain_f;    // optional (FLT_CHAIN_F, n)
};

// one telemetry field's per-chain leaves (obs/telemetry.py fold_second)
struct TelField {
  int nan = 0, nf = 0;
  float mn = FLT_MAX, mx = -FLT_MAX, sum = 0.0f, sumsq = 0.0f;

  __device__ __forceinline__ void fold(float v, bool valid) {
    const bool use = valid && isfinite(v);
    nan += (valid && v != v) ? 1 : 0;
    nf += (valid && !use) ? 1 : 0;
    mn = nminf(mn, use ? v : FLT_MAX);
    mx = nmaxf(mx, use ? v : -FLT_MAX);
    const float v0 = use ? v : 0.0f;
    sum = sum + v0;
    // the JAX scan contracts sumsq + v0 * v0 into a multiply-add
    sumsq = fmaf(v0, v0, sumsq);
  }
};

// the analytics per-chain leaves (obs/analytics.py fold_second)
struct FltChain {
  int n_use = 0, lol_run = 0, lol_s = 0, lol_e = 0, cov = 0;
  int seen[3] = {0, 0, 0};
  float mn = FLT_MAX, mx = -FLT_MAX;
  float ramp[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  float prev[3] = {0.0f, 0.0f, 0.0f};
  float sm = 0.0f, sp = 0.0f, sr = 0.0f, cm = 0.0f, cp = 0.0f, cr = 0.0f;
};

// which ramp grids each of the block's T seconds closes (bit k: window
// k) and whether it is valid (bit 3: t < duration_s), once per CTA into
// flags[T]; the CTA's threads all take part
#define FLAG_VALID 8
__device__ __forceinline__ void ramp_flags(const Obs& o, const int* t, int T,
                                           int duration_s,
                                           unsigned char* flags) {
  for (int s = threadIdx.x; s < T; s += blockDim.x) {
    const int ts = t[s];
    int bits = ts < duration_s ? FLAG_VALID : 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int w = o.ramp_w[k];
      if (w == 1 || (ts + 1) % w == 0) bits |= 1 << k;
    }
    flags[s] = (unsigned char)bits;
  }
}

// one used sample r counted against the thresholds passed by value
// (thr_v: the first MAX_THR ascending thresholds, then +inf)
__device__ __forceinline__ void exc_count(const float (&thr_v)[MAX_THR],
                                          float r, int (&above)[MAX_THR]) {
#pragma unroll
  for (int j = 0; j < MAX_THR; ++j) above[j] += thr_v[j] < r ? 1 : 0;
}

// the register exceedance counts (used: the thread's used samples) added
// to the global slots exceed[0 .. n_thr]: slot k is the used samples above
// threshold k - 1 (all of them for k = 0) less those above threshold k,
// reduced over the warp, one atomicAdd per warp and slot (every thread of
// the warp takes part)
__device__ __forceinline__ void exc_flush(int n_thr, int used,
                                          const int (&above)[MAX_THR],
                                          int* exceed) {
#pragma unroll
  for (int k = 0; k <= MAX_THR; ++k) {
    if (k > n_thr) break;
    const int hi = k == 0 ? used : above[k > 0 ? k - 1 : 0];
    const int lo = k < n_thr ? above[k < MAX_THR ? k : 0] : 0;
    const int cnt = __reduce_add_sync(0xffffffffu, hi - lo);
    if ((threadIdx.x & 31) == 0 && cnt) atomicAdd(&exceed[k], cnt);
  }
}

// one second of the analytics fold of one chain: the residual histogram,
// the exceedance count (in registers, above[], or past MAX_THR
// thresholds one atomic into exc) and, with cohorts, the cohort histogram
// (hist, exc, coh_hist: shared or global), the loss run, the three ramp
// grids (grid: the second's ramp_flags) and the sums of the used samples.
// RES_TEL: the residual's extrema and sum are telemetry's residual field
// (TelField::fold of the same values under the same mask, in the same
// order), taken from it at block end, so not folded here.  Returns
// whether the sample was used (valid and finite).
template <bool RES_TEL>
__device__ __forceinline__ bool flt_second(FltChain& f, const Obs& o,
                                           float meter, float ac, float r,
                                           bool valid, int grid, int* hist,
                                           int* exc, int* coh_hist,
                                           int cohort, bool exc_regs,
                                           int (&above)[MAX_THR]) {
  const bool use = valid && isfinite(r);
  if (use) {
    f.n_use += 1;
    float b = (r - o.lo) * o.inv_w;
    b = nclampf(b, -1.0f, (float)o.bins);
    const int idx = (int)floorf(b) + 1;
    atomicAdd(&hist[idx], 1);
    if (exc_regs) {
      exc_count(o.thr_v, r, above);
    } else {
      int slot = 0;
      for (int j = 0; j < o.n_thr; ++j) slot += o.thr[j] < r ? 1 : 0;
      atomicAdd(&exc[slot], 1);
    }
    if (coh_hist != nullptr) atomicAdd(&coh_hist[cohort * (o.bins + 2) + idx], 1);
  }
  if constexpr (!RES_TEL) {
    f.mn = nminf(f.mn, use ? r : FLT_MAX);
    f.mx = nmaxf(f.mx, use ? r : -FLT_MAX);
  }
  f.lol_run = (use && r > o.capacity) ? f.lol_run + 1 : 0;
  f.lol_e += f.lol_run == o.lolp_k ? 1 : 0;
  f.lol_s += f.lol_run >= o.lolp_k ? 1 : 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (grid >> k & 1) {
      if (use && f.seen[k] > 0)
        f.ramp[k] = nmaxf(f.ramp[k], fabsf(r - f.prev[k]));
      if (use) f.prev[k] = r;
      f.seen[k] = use ? 1 : 0;
    }
  }
  f.sm = f.sm + (use ? meter : 0.0f);
  f.sp = f.sp + (use ? ac : 0.0f);
  if constexpr (!RES_TEL) f.sr = f.sr + (use ? r : 0.0f);
  return use;
}

template <int KIND>
__device__ __forceinline__ double combine(double x, double y) {
  return KIND == K_SUM ? x + y : (KIND == K_MIN ? fmin(x, y) : fmax(x, y));
}

// one leaf over the warp: an xor butterfly, the same order every run
template <int KIND>
__device__ __forceinline__ double warp_reduce(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = combine<KIND>(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// the CTA's partial row of L leaves: each warp reduces every leaf, lane 0
// stages it, then thread l combines leaf l over the warps in order
template <int L>
__device__ __forceinline__ void cta_partials(double (&v)[L],
                                             const int (&kind)[L],
                                             double* s_stage, double* row) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    double x = kind[l] == K_SUM   ? warp_reduce<K_SUM>(v[l])
               : kind[l] == K_MIN ? warp_reduce<K_MIN>(v[l])
                                  : warp_reduce<K_MAX>(v[l]);
    if (lane == 0) s_stage[warp * L + l] = x;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    double x = s_stage[l];
    for (int w = 1; w < WARPS; ++w) {
      const double y = s_stage[w * L + l];
      x = kind[l] == K_SUM ? x + y : (kind[l] == K_MIN ? fmin(x, y)
                                                        : fmax(x, y));
    }
    row[l] = x;
  }
  __syncthreads();
}

// a shared histogram's counts added to its global copy (one atomic per
// non-zero slot), when it was counted in shared memory
__device__ __forceinline__ void flush_hist(const int* s, int* g, int len) {
  for (int k = threadIdx.x; k < len; k += blockDim.x)
    if (s[k]) atomicAdd(&g[k], s[k]);
}

// the telemetry leaves' per-chain outputs (when asked for) and the chain
// group's partial row (row: the group's index; every thread takes part, a
// dead thread holds the identities)
__device__ __forceinline__ void tel_epilogue(const TelField (&tel)[4],
                                             int occ, const Obs& o, int64_t n,
                                             int64_t i, bool live,
                                             double* s_stage, int64_t row) {
  if (live && o.tel_chain_i != nullptr) {
    for (int k = 0; k < 4; ++k) {
      o.tel_chain_i[(2 * k) * n + i] = tel[k].nan;
      o.tel_chain_i[(2 * k + 1) * n + i] = tel[k].nf;
      o.tel_chain_f[(4 * k) * n + i] = tel[k].mn;
      o.tel_chain_f[(4 * k + 1) * n + i] = tel[k].mx;
      o.tel_chain_f[(4 * k + 2) * n + i] = tel[k].sum;
      o.tel_chain_f[(4 * k + 3) * n + i] = tel[k].sumsq;
    }
    o.tel_chain_i[8 * n + i] = occ;
  }
  double v[TEL_LEAVES];
  int kind[TEL_LEAVES];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[6 * k] = tel[k].nan;
    v[6 * k + 1] = tel[k].nf;
    v[6 * k + 2] = tel[k].mn;
    v[6 * k + 3] = tel[k].mx;
    v[6 * k + 4] = tel[k].sum;
    v[6 * k + 5] = tel[k].sumsq;
    kind[6 * k] = kind[6 * k + 1] = kind[6 * k + 4] = kind[6 * k + 5] =
        K_SUM;
    kind[6 * k + 2] = K_MIN;
    kind[6 * k + 3] = K_MAX;
  }
  v[24] = occ;
  kind[24] = K_SUM;
  cta_partials(v, kind, s_stage, o.tel_part + row * TEL_LEAVES);
}

// the analytics leaves' per-chain outputs (when asked for) and the chain
// group's partial row; regime: fold the level-full sums (F_COV .. F_CSR) too,
// else they stay zero
__device__ __forceinline__ void flt_epilogue(const FltChain& f, bool regime,
                                             const Obs& o, int64_t n,
                                             int64_t i, bool live,
                                             double* s_stage, int64_t row) {
  if (live && o.flt_chain_i != nullptr) {
    const int vi[FLT_CHAIN_I] = {f.lol_s,   f.lol_e,   f.lol_run, f.seen[0],
                                 f.seen[1], f.seen[2], f.cov,     f.n_use};
    const float vf[FLT_CHAIN_F] = {f.mn,      f.mx,      f.ramp[0],
                                   f.ramp[1], f.ramp[2], f.prev[0],
                                   f.prev[1], f.prev[2], f.sm,
                                   f.sp,      f.sr,      f.cm,
                                   f.cp,      f.cr};
    for (int k = 0; k < FLT_CHAIN_I; ++k) o.flt_chain_i[k * n + i] = vi[k];
    for (int k = 0; k < FLT_CHAIN_F; ++k) o.flt_chain_f[k * n + i] = vf[k];
  }
  double v[FLT_LEAVES] = {(double)f.n_use, f.mn, f.mx, (double)f.lol_s,
                          (double)f.lol_e, f.ramp[0], f.ramp[1], f.ramp[2],
                          (double)f.cov, f.sm, f.sp, f.sr, f.cm, f.cp, f.cr};
  if (!regime)
    for (int k = F_COV; k < FLT_LEAVES; ++k) v[k] = 0.0;
  int kind[FLT_LEAVES];
#pragma unroll
  for (int k = 0; k < FLT_LEAVES; ++k) kind[k] = K_SUM;
  kind[F_MIN] = K_MIN;
  kind[F_MAX] = kind[F_R1] = kind[F_R2] = kind[F_R3] = K_MAX;
  cta_partials(v, kind, s_stage, o.flt_part + row * FLT_LEAVES);
}

// the cohort partials: per cohort over the group's chains in chain order
// (staged in shared memory: ids, use counts and 5 values per chain), one
// thread per cohort, into the group's row
__device__ __forceinline__ void cohort_partials(const FltChain& f,
                                                const Obs& o, bool live,
                                                int cohort, int* s_cid,
                                                int* s_cuse,
                                                float (*s_cval)[THREADS],
                                                int64_t row) {
  const int C = o.n_cohorts;
  s_cid[threadIdx.x] = live ? cohort : -1;
  s_cuse[threadIdx.x] = f.n_use;
  s_cval[0][threadIdx.x] = f.sm;
  s_cval[1][threadIdx.x] = f.sp;
  s_cval[2][threadIdx.x] = f.sr;
  s_cval[3][threadIdx.x] = f.mn;
  s_cval[4][threadIdx.x] = f.mx;
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    double cnt = 0.0, sm = 0.0, sp = 0.0, sr = 0.0;
    float mn = FLT_MAX, mx = -FLT_MAX;
    for (int k = 0; k < THREADS; ++k) {
      if (s_cid[k] != c) continue;
      cnt += s_cuse[k];
      sm += s_cval[0][k];
      sp += s_cval[1][k];
      sr += s_cval[2][k];
      mn = nminf(mn, s_cval[3][k]);
      mx = nmaxf(mx, s_cval[4][k]);
    }
    double* out = o.coh_part + (row * C + c) * COH_LEAVES;
    out[0] = cnt;
    out[1] = sm;
    out[2] = sp;
    out[3] = sr;
    out[4] = mn;
    out[5] = mx;
  }
  __syncthreads();
}
