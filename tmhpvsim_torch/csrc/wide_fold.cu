// K4 merges: the wide formulation's statistics over a block's materialised
// time-major (T, n) meter and pv (the K4 trace launch's output); and the
// observer fold, K8 + K9 over the acc producer's (T, n) arrays.
//
// Replaces (tmhpvsim_tpu/engine/simulation.py):
//   wide_fold    _block_stats (:958) + _merge_acc (:1070) /
//                _block_stats_acc (:1078): the seven per-chain statistics,
//                masked by t < duration_s, merged into the accumulator (add
//                / max / min); with TEL the wide telemetry fold
//                (_wide_telemetry :1377, obs/telemetry.py fold_wide :186),
//                with FLT the wide fleet fold (_wide_fleet :1565,
//                obs/analytics.py fold_wide :337);
//   wide_series  _ensemble_series (:983): per second, the sums over chains
//                of meter and pv (with series_sum, block_step.cu, as its
//                second pass);
//   obs_fold     the observers of _block_step_scan_acc_fleet (:1481, body
//                :1394) and _block_step_scan_acc_tel_fleet (:1524, body
//                :1436): obs/analytics.py fold_second (:223) with
//                reduce_chainwise (:311), and with telemetry
//                obs/telemetry.py fold_second (:110) with reduce_chainwise
//                (:157) -- K9, K8 + K9; the block step's acc producer
//                (block_step.cuh) writes what they read.
// Plain versions: tmhpvsim_torch/kernels/wide.py wide_fold_plain and
// wide_series_plain (with obs/telemetry.py and obs/analytics.py
// fold_wide); kernels/block_step.py obs_fold_plain.
//
// Design.  wide_fold: one thread per chain loops over the block's T rows
// in second order, its loads coalesced across the warp's chains, and
// folds the seven statistics in registers with the block step's acc
// epilogue's own expressions (block_step.cuh), so on the same meter and
// pv it gives K3's bits.  The acc fold alone (no observer) keeps WIDE_RING
// seconds of loads in flight a thread (two register chunks: the next
// chunk's loads issued before the current chunk folds): with one thread a
// chain, 512 CTAs at 65536 chains put ~4 CTAs on an SM, and a loop that
// waited on each unrolled group of 4 seconds kept ~16 KB in flight an SM
// (45 % of the bytes bound on an H100, PERF.md); 16 seconds keep ~64 KB
// (84 %).  The observers are template flags of the
// same launch, so one pass reads the arrays once whatever is on: TEL folds
// meter, pv and residual as K8 does (csi is never materialised and stays
// at its identities; no histogram, no occupancy), FLT folds K9's leaves
// (flt_second, fold.cuh) without the level-full regime sums; loss runs
// and ramp pairs restart at the block's start, as the JAX fold's do.  The
// per-chain leaves become per-CTA partial rows (fold.cuh) for
// collapse_partials; histograms count in shared memory or, when they do
// not fit, with global atomics, as K9's do.
// wide_series: CTA (c, k) sums seconds [60k, 60k + 60) over chains
// [128c, 128c + 128) in the series epilogue's order (a warp xor-butterfly,
// then the 4 warps in index order) into the (n_ctas, T) partials that
// series_sum adds over CTAs in index order, so on the same values it
// gives the scan ensemble's bits.
// obs_fold: the fused epilogue's folds moved out of the step, whose
// registers they pushed past 128 a thread (3 or 2 CTAs an SM, so two
// waves of the 512 CTAs at 65536 chains).  Its threads are the step's 128
// chains of a group, one chain each in second order, so every group's
// partial rows (telemetry, analytics, cohorts) and their collapse keep
// the fused launch's bits.  Built for 4 CTAs an SM (at most 128
// registers), a CTA walks groups_per_cta groups, chosen by occupancy so
// the grid is one wave (one group per CTA at 65536 chains); the residual
// and cohort histograms count in shared memory (one atomic per used
// sample, which cost nothing measurable in the fused launch) and are
// flushed once per CTA; the exceedance counts in registers against the
// thresholds passed by value (fold.cuh); which ramp grids a second closes
// and whether it is valid are worked out once per CTA (the modulos took
// 0.24 ms of the fused launch); the csi histogram's 8 bins count in two
// packed registers (CsiRegs: a shift, two selects and two adds a
// sample), reduced over the warp once per group; OBS_CHUNK seconds'
// loads are in flight while the previous chunk folds.  With telemetry on,
// its residual field and K9's residual extrema and sum fold the same
// values under the same mask, so they are folded once.  The choices are
// obs_fold_ab.py's timings (PERF.md).
//
// Bound: bytes.  wide_fold reads 2 x 4 bytes per chain-second (566 MB
// per 65536 x 1080 block, 0.169 ms at 3.35 TB/s); the fold's arithmetic,
// K9's per-sample work with FLT, stays under that at this card's rates.
// obs_fold reads 13 bytes per chain-second with telemetry full (meter,
// pv, csi, covered: 920 MB, 0.275 ms); its issue bound, the fused
// epilogue's per-sample folds on one issue rate, is about as long.
#include <algorithm>

#include "fold.cuh"

#define SERIES_TILE 60
// the acc fold's loads in flight a thread: WIDE_RING seconds of meter and
// pv (the bits do not depend on it)
#define WIDE_RING 16

struct WideArgs {
  int64_t n;
  int T, duration_s;
  const float *meter, *pv;  // (T, n)
  const int* t;             // (T,) global seconds
  float *pv_sum, *pv_max, *meter_sum, *residual_sum, *residual_min,
      *residual_max;
  int* n_seconds;
  Obs o;
};

template <bool TEL, bool FLT>
__global__ void __launch_bounds__(THREADS) wide_fold_kernel(const WideArgs a) {
  __shared__ double s_stage[TEL || FLT ? WARPS * TEL_LEAVES : 1];
  // analytics: the cohort partials' staging, one entry per chain
  __shared__ int s_cid[FLT ? THREADS : 1], s_cuse[FLT ? THREADS : 1];
  __shared__ float s_cval[FLT ? 5 : 1][FLT ? THREADS : 1];
  extern __shared__ int s_dyn[];
  const int64_t n = a.n;
  const int T = a.T;
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const bool live = i < n;
  const int64_t ii = live ? i : 0;

  TelField tel[4];  // meter, csi (never folded), pv, residual
  FltChain f;
  const int nb = a.o.bins + 2, ne = a.o.n_thr + 1;
  int *hist = nullptr, *exc = nullptr, *coh_hist = nullptr;
  unsigned char* grid = nullptr;
  int cohort = 0;
  const bool exc_regs = a.o.n_thr <= MAX_THR;
  int above[MAX_THR];
#pragma unroll
  for (int j = 0; j < MAX_THR; ++j) above[j] = 0;
  if constexpr (FLT) {
    // dynamic shared memory: the sketch (when shared), then the ramp flags
    const int coh_off = a.o.hist_shared ? nb + ne : 0;
    const int len = coh_off + (a.o.coh_shared ? a.o.n_cohorts * nb : 0);
    for (int k = threadIdx.x; k < len; k += blockDim.x) s_dyn[k] = 0;
    hist = a.o.hist_shared ? s_dyn : a.o.res_hist;
    exc = a.o.hist_shared ? s_dyn + nb : a.o.exceed;
    if (a.o.n_cohorts) {
      coh_hist = a.o.coh_shared ? s_dyn + coh_off : a.o.cohort_hist;
      cohort = a.o.cohort[ii];
    }
    grid = reinterpret_cast<unsigned char*>(s_dyn + len);
    ramp_flags(a.o, a.t, T, a.duration_s, grid);
    __syncthreads();
  }
  if (live) {
    float pv_sum = a.pv_sum[i], pv_max = a.pv_max[i],
          meter_sum = a.meter_sum[i], residual_sum = a.residual_sum[i],
          residual_min = a.residual_min[i], residual_max = a.residual_max[i];
    int n_seconds = a.n_seconds[i];
    // the acc epilogue's fold (block_step.cuh), expression for expression
    auto fold = [&](int s, float meter, float ac) {
      const int t = __ldg(&a.t[s]);
      const float residual = meter - ac;
      const bool valid = t < a.duration_s;
      const float vz = valid ? 1.0f : 0.0f;
      pv_sum = pv_sum + ac * vz;
      pv_max = nmaxf(pv_max, valid ? ac : -FLT_MAX);
      meter_sum = meter_sum + meter * vz;
      residual_sum = residual_sum + residual * vz;
      residual_min = nminf(residual_min, valid ? residual : FLT_MAX);
      residual_max = nmaxf(residual_max, valid ? residual : -FLT_MAX);
      n_seconds += valid ? 1 : 0;
      if constexpr (TEL) {
        tel[0].fold(meter, valid);
        tel[2].fold(ac, valid);
        tel[3].fold(residual, valid);
      }
      if constexpr (FLT)
        flt_second<TEL>(f, a.o, meter, ac, residual, valid, grid[s], hist,
                        exc, coh_hist, cohort, exc_regs, above);
    };
    if constexpr (!TEL && !FLT) {
      // WIDE_RING seconds of meter and pv in flight while the previous
      // WIDE_RING fold: the next chunk's loads are issued before this
      // chunk's folds, which wait on nothing of them
      const float* pm = a.meter + i;
      const float* pa = a.pv + i;
      float mc[WIDE_RING], ac[WIDE_RING];
#pragma unroll
      for (int u = 0; u < WIDE_RING; ++u) {
        mc[u] = u < T ? __ldg(pm + (int64_t)u * n) : 0.0f;
        ac[u] = u < T ? __ldg(pa + (int64_t)u * n) : 0.0f;
      }
      for (int s0 = 0; s0 < T; s0 += WIDE_RING) {
        float mx[WIDE_RING], ax[WIDE_RING];
#pragma unroll
        for (int u = 0; u < WIDE_RING; ++u) {
          const int s = s0 + WIDE_RING + u;
          mx[u] = s < T ? __ldg(pm + (int64_t)s * n) : 0.0f;
          ax[u] = s < T ? __ldg(pa + (int64_t)s * n) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < WIDE_RING; ++u)
          if (s0 + u < T) fold(s0 + u, mc[u], ac[u]);
#pragma unroll
        for (int u = 0; u < WIDE_RING; ++u) {
          mc[u] = mx[u];
          ac[u] = ax[u];
        }
      }
    } else {
#pragma unroll 4
      for (int s = 0; s < T; ++s)
        fold(s, a.meter[(int64_t)s * n + i], a.pv[(int64_t)s * n + i]);
    }
    a.pv_sum[i] = pv_sum;
    a.pv_max[i] = pv_max;
    a.meter_sum[i] = meter_sum;
    a.residual_sum[i] = residual_sum;
    a.residual_min[i] = residual_min;
    a.residual_max[i] = residual_max;
    a.n_seconds[i] = n_seconds;
  }
  if constexpr (TEL && FLT) {  // the residual's extrema and sum, shared
    f.mn = tel[3].mn;
    f.mx = tel[3].mx;
    f.sr = tel[3].sum;
  }
  // the per-CTA partial rows (every thread takes part; a dead thread
  // holds the identities)
  if constexpr (TEL) {
    tel_epilogue(tel, 0, a.o, n, i, live, s_stage, blockIdx.x);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      // the count leaf as the JAX fold takes it: the valid seconds (an
      // exact float32 sum) times the chains, rounded once
      int nv = 0;
      for (int s = 0; s < T; ++s) nv += a.t[s] < a.duration_s ? 1 : 0;
      a.o.tel_count[0] = (float)nv * (float)n;
    }
  }
  if constexpr (FLT) {
    flt_epilogue(f, false, a.o, n, i, live, s_stage, blockIdx.x);
    if (a.o.hist_shared) {
      flush_hist(s_dyn, a.o.res_hist, nb);
      if (!exc_regs) flush_hist(s_dyn + nb, a.o.exceed, ne);
    }
    if (exc_regs) exc_flush(a.o.n_thr, f.n_use, above, a.o.exceed);
    if (a.o.n_cohorts) {
      if (a.o.coh_shared)
        flush_hist(s_dyn + (a.o.hist_shared ? nb + ne : 0), a.o.cohort_hist,
                   a.o.n_cohorts * nb);
      cohort_partials(f, a.o, live, cohort, s_cid, s_cuse, s_cval,
                      blockIdx.x);
    }
  }
}

// The observer fold (K8 + K9 over the producer's arrays, obs_fold below):
// per chain group, one chain per thread in second order, the fused
// epilogue's per-sample folds (TelField, flt_second, the csi histogram,
// the occupancy and K9's level-full sums) on the producer's time-major
// (T, n) meter, pv, csi and covered.
struct FoldArgs {
  int64_t n;
  int T, duration_s;
  const int* t;                // (T,) global seconds
  const float *meter, *pv;     // (T, n)
  const float* csi;            // (T, n), with telemetry
  const unsigned char* cov;    // (T, n), with telemetry or analytics full
  Obs o;
};

// the seconds per load chunk (blocks are whole minutes; obs_fold_ab.py
// timed 2, 3, 4 and 8: 8 spills)
#define OBS_CHUNK 4

// The csi histogram's 8 bins count in two registers, four 16-bit fields
// each, and reach the shared histogram once per chain group (a warp
// reduction, one atomic per warp and bin) or, within a group, every 32768
// seconds (per thread) before a field could carry.  (Warp-aggregated
// shared atomics, __match_any_sync, were 1.6-4 % slower on an H100:
// obs_fold_ab.py.)
struct CsiRegs {
  unsigned long long lo = 0ull, hi = 0ull;

  __device__ __forceinline__ void add(int b) {
    const unsigned long long one = 1ull << (16 * (b & 3));
    lo += b < 4 ? one : 0ull;
    hi += b < 4 ? 0ull : one;
  }
  __device__ __forceinline__ int get(int b) const {
    return (int)(((b < 4 ? lo : hi) >> (16 * (b & 3))) & 0xFFFFull);
  }
  // per thread, inside the loop
  __device__ __forceinline__ void spill(int* s_csi) {
#pragma unroll
    for (int b = 0; b < CSI_BINS; ++b)
      if (get(b)) atomicAdd(&s_csi[b], get(b));
    lo = hi = 0ull;
  }
  // every thread of the CTA takes part
  __device__ __forceinline__ void flush(int* s_csi) {
#pragma unroll
    for (int b = 0; b < CSI_BINS; ++b) {
      const int c = __reduce_add_sync(0xffffffffu, get(b));
      if ((threadIdx.x & 31) == 0 && c) atomicAdd(&s_csi[b], c);
    }
    lo = hi = 0ull;
  }
};

// at most 128 registers a thread: 4 CTAs an SM, so one chain group per
// CTA in one wave at 65536 chains
template <bool TEL>
__global__ void __launch_bounds__(THREADS, 4)
    obs_fold_kernel(const FoldArgs a, int groups_per_cta) {
  __shared__ double s_stage[WARPS * TEL_LEAVES];
  __shared__ int s_csi[TEL ? CSI_BINS : 1];
  __shared__ int s_cid[THREADS], s_cuse[THREADS];
  __shared__ float s_cval[5][THREADS];
  extern __shared__ int s_dyn[];
  const Obs& o = a.o;
  const int64_t n = a.n;
  const int T = a.T;
  const int n_groups = (int)((n + THREADS - 1) / THREADS);
  const int g0 = blockIdx.x * groups_per_cta;
  const int g1 = min(n_groups, g0 + groups_per_cta);
  const int nb = o.bins + 2, ne = o.n_thr + 1;
  const bool exc_regs = o.n_thr <= MAX_THR;
  // dynamic shared memory: the sketch (when shared), then the ramp flags
  const int coh_off = o.hist_shared ? nb + ne : 0;
  const int len = coh_off + (o.coh_shared ? o.n_cohorts * nb : 0);
  for (int k = threadIdx.x; k < len; k += blockDim.x) s_dyn[k] = 0;
  if (TEL && threadIdx.x < CSI_BINS) s_csi[threadIdx.x] = 0;
  int* const hist = o.hist_shared ? s_dyn : o.res_hist;
  int* const exc = o.hist_shared ? s_dyn + nb : o.exceed;
  int* const coh_hist = o.n_cohorts == 0 ? nullptr
                        : o.coh_shared   ? s_dyn + coh_off
                                         : o.cohort_hist;
  unsigned char* const grid = reinterpret_cast<unsigned char*>(s_dyn + len);
  ramp_flags(o, a.t, T, a.duration_s, grid);
  __syncthreads();
  const bool tel_full = TEL && o.tel_full, flt_full = o.flt_full;
  int used = 0, above[MAX_THR];
#pragma unroll
  for (int j = 0; j < MAX_THR; ++j) above[j] = 0;
  CsiRegs cr;

  for (int g = g0; g < g1; ++g) {
    const int64_t i = (int64_t)g * THREADS + threadIdx.x;
    const bool live = i < n;
    TelField tel[4];  // meter, csi, pv, residual
    int occ = 0;
    FltChain f;
    const int cohort = live && o.n_cohorts ? o.cohort[i] : 0;
    if (live) {
      const float* pm = a.meter + i;
      const float* pa = a.pv + i;
      const float* pc = TEL ? a.csi + i : nullptr;
      const unsigned char* pq = a.cov != nullptr ? a.cov + i : nullptr;
      // OBS_CHUNK seconds at a time, the next chunk's loads in flight
      // while this one folds
      float mc[OBS_CHUNK], ac[OBS_CHUNK], cc[OBS_CHUNK];
      int qc[OBS_CHUNK];
#pragma unroll
      for (int u = 0; u < OBS_CHUNK; ++u) {
        mc[u] = __ldg(pm + (int64_t)u * n);
        ac[u] = __ldg(pa + (int64_t)u * n);
        cc[u] = TEL ? __ldg(pc + (int64_t)u * n) : 0.0f;
        qc[u] = pq != nullptr ? __ldg(pq + (int64_t)u * n) : 0;
      }
      for (int s0 = 0; s0 < T; s0 += OBS_CHUNK) {
        float mx_[OBS_CHUNK], ax_[OBS_CHUNK], cx_[OBS_CHUNK];
        int qx_[OBS_CHUNK];
        const bool more = s0 + OBS_CHUNK < T;
#pragma unroll
        for (int u = 0; u < OBS_CHUNK; ++u) {
          const int64_t o2 = (int64_t)(s0 + OBS_CHUNK + u) * n;
          mx_[u] = more ? __ldg(pm + o2) : 0.0f;
          ax_[u] = more ? __ldg(pa + o2) : 0.0f;
          cx_[u] = TEL && more ? __ldg(pc + o2) : 0.0f;
          qx_[u] = pq != nullptr && more ? __ldg(pq + o2) : 0;
        }
        if (TEL && tel_full && s0 > 0 && (s0 & 32767) == 0) cr.spill(s_csi);
#pragma unroll
        for (int u = 0; u < OBS_CHUNK; ++u) {
          const int s = s0 + u;
          const float meter = mc[u], pv = ac[u];
          const float residual = meter - pv;
          const int flags = grid[s];
          const bool valid = (flags & FLAG_VALID) != 0;
          const bool covered = qc[u] != 0;
          if constexpr (TEL) {  // K8: obs/telemetry.py fold_second
            const float csi = cc[u];
            tel[0].fold(meter, valid);
            tel[1].fold(csi, valid);
            tel[2].fold(pv, valid);
            tel[3].fold(residual, valid);
            if (tel_full) {
              if (valid && isfinite(csi))
                cr.add((int)nclampf(csi / 0.25f, 0.0f,
                                    (float)(CSI_BINS - 1)));
              occ += (valid && covered) ? 1 : 0;
            }
          }
          // K9: obs/analytics.py fold_second
          const bool use = flt_second<TEL>(f, o, meter, pv, residual, valid,
                                           flags, hist, exc, coh_hist,
                                           cohort, exc_regs, above);
          if (flt_full) {
            const bool cv = covered && use;
            f.cov += cv ? 1 : 0;
            f.cm = f.cm + (cv ? meter : 0.0f);
            f.cp = f.cp + (cv ? pv : 0.0f);
            f.cr = f.cr + (cv ? residual : 0.0f);
          }
        }
#pragma unroll
        for (int u = 0; u < OBS_CHUNK; ++u) {
          mc[u] = mx_[u];
          ac[u] = ax_[u];
          cc[u] = cx_[u];
          qc[u] = qx_[u];
        }
      }
    }
    if constexpr (TEL) {  // the residual's extrema and sum, shared
      f.mn = tel[3].mn;
      f.mx = tel[3].mx;
      f.sr = tel[3].sum;
    }
    used += f.n_use;
    // reduce_chainwise, first pass: the group's partial rows (every thread
    // takes part; a dead thread holds the identities)
    if constexpr (TEL) {
      tel_epilogue(tel, occ, o, n, i, live, s_stage, g);
      if (tel_full) cr.flush(s_csi);
    }
    flt_epilogue(f, true, o, n, i, live, s_stage, g);
    if (o.n_cohorts)
      cohort_partials(f, o, live, cohort, s_cid, s_cuse, s_cval, g);
  }
  // the histograms, once per CTA
  __syncthreads();
  if (o.hist_shared) {
    flush_hist(s_dyn, o.res_hist, nb);
    if (!exc_regs) flush_hist(s_dyn + nb, o.exceed, ne);
  }
  if (o.n_cohorts && o.coh_shared)
    flush_hist(s_dyn + coh_off, o.cohort_hist, o.n_cohorts * nb);
  if (exc_regs) exc_flush(o.n_thr, used, above, o.exceed);
  if constexpr (TEL) {
    if (tel_full) flush_hist(s_csi, o.csi_hist, CSI_BINS);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      // the count leaf: valid seconds x n, added in float32 per second
      float count = 0.0f;
      for (int s = 0; s < T; ++s)
        if (a.t[s] < a.duration_s) count = count + (float)n;
      o.tel_count[0] = count;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    wide_series_kernel(int64_t n, int T, const float* __restrict__ meter,
                       const float* __restrict__ pv, float* part_m,
                       float* part_p) {
  __shared__ float red_m[WARPS][SERIES_TILE];
  __shared__ float red_p[WARPS][SERIES_TILE];
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const bool live = i < n;
  const int base = blockIdx.y * SERIES_TILE;
  for (int s = 0; s < SERIES_TILE; ++s) {
    const int64_t o = (int64_t)(base + s) * n + i;
    float m = live ? meter[o] : 0.0f, p = live ? pv[o] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      m += __shfl_xor_sync(0xffffffffu, m, off);
      p += __shfl_xor_sync(0xffffffffu, p, off);
    }
    if ((threadIdx.x & 31) == 0) {
      red_m[threadIdx.x >> 5][s] = m;
      red_p[threadIdx.x >> 5][s] = p;
    }
  }
  __syncthreads();
  if (threadIdx.x < SERIES_TILE) {
    float m = red_m[0][threadIdx.x], p = red_p[0][threadIdx.x];
    for (int w = 1; w < WARPS; ++w) {
      m = m + red_m[w][threadIdx.x];
      p = p + red_p[w][threadIdx.x];
    }
    const int64_t o = (int64_t)blockIdx.x * T + base + threadIdx.x;
    part_m[o] = m;
    part_p[o] = p;
  }
}

template <bool TEL, bool FLT>
static int launch_fold(const WideArgs& a, unsigned blocks, int smem,
                       cudaStream_t st) {
  auto kernel = wide_fold_kernel<TEL, FLT>;
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// acc: the seven (n,) statistics, merged in place; obs: the observers'
// arguments (nullptr with tel and flt 0); smem: the analytics' dynamic
// shared histograms, in bytes
extern "C" int wide_fold(int64_t n, int T, int duration_s, const float* meter,
                         const float* pv, const int* t, float* pv_sum,
                         float* pv_max, float* meter_sum, float* residual_sum,
                         float* residual_min, float* residual_max,
                         int* n_seconds, const Obs* obs, int tel, int flt,
                         int smem, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  WideArgs a = {};
  a.n = n;
  a.T = T;
  a.duration_s = duration_s;
  a.meter = meter;
  a.pv = pv;
  a.t = t;
  a.pv_sum = pv_sum;
  a.pv_max = pv_max;
  a.meter_sum = meter_sum;
  a.residual_sum = residual_sum;
  a.residual_min = residual_min;
  a.residual_max = residual_max;
  a.n_seconds = n_seconds;
  if (obs != nullptr) a.o = *obs;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  switch ((tel ? 2 : 0) + (flt ? 1 : 0)) {
    case 0: return launch_fold<false, false>(a, blocks, smem, st);
    case 1: return launch_fold<false, true>(a, blocks, smem, st);
    case 2: return launch_fold<true, false>(a, blocks, smem, st);
    default: return launch_fold<true, true>(a, blocks, smem, st);
  }
}

// the acc fold's launch shape (no observer): out = {registers, CTAs per
// SM, local (spill) bytes}
extern "C" int wide_fold_attrs(int* out, void* stream) {
  (void)stream;
  auto kernel = wide_fold_kernel<false, false>;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel,
                                                      THREADS, 0);
  out[0] = fa.numRegs;
  out[2] = (int)fa.localSizeBytes;
  return (int)e;
}

// the observer fold's grid: one wave of CTAs (as many as fit on the
// card at once at smem bytes), each walking groups_per_cta chain groups
template <bool TEL>
static cudaError_t obs_fold_grid(int64_t n, int smem, int* gpc, int* blocks,
                                 int* regs, int* per_sm) {
  auto kernel = obs_fold_kernel<TEL>;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                      THREADS, smem);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  *regs = fa.numRegs;
  const int64_t n_groups = (n + THREADS - 1) / THREADS;
  const int64_t wave = std::max<int64_t>(1, (int64_t)sms * *per_sm);
  const int64_t g = std::max<int64_t>(1, (n_groups + wave - 1) / wave);
  *gpc = (int)g;
  *blocks = (int)((n_groups + g - 1) / g);
  return cudaSuccess;
}

// The observer fold (K8 + K9 of the fused epilogue, now over the
// producer's arrays): t the block's (T,) global seconds; meter, pv (T, n)
// float32; csi (T, n) float32 with tel; cov (T, n) uint8 (the renewal's
// covered flag) with telemetry or analytics at level full, else nullptr;
// obs the observers' arguments (analytics on); smem the sketch's shared
// bytes (when shared) plus T bytes of ramp flags, rounded up to 4.
extern "C" int obs_fold(int64_t n, int T, int duration_s, const int* t,
                        const float* meter, const float* pv,
                        const float* csi, const unsigned char* cov,
                        const Obs* obs, int tel, int smem, void* stream) {
  if (T <= 0 || T % OBS_CHUNK || obs == nullptr || (tel && csi == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  FoldArgs a = {};
  a.n = n;
  a.T = T;
  a.duration_s = duration_s;
  a.t = t;
  a.meter = meter;
  a.pv = pv;
  a.csi = csi;
  a.cov = cov;
  a.o = *obs;
  int gpc = 1, blocks = 0, regs = 0, per_sm = 0;
  const cudaError_t e =
      tel ? obs_fold_grid<true>(n, smem, &gpc, &blocks, &regs, &per_sm)
          : obs_fold_grid<false>(n, smem, &gpc, &blocks, &regs, &per_sm);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  if (tel)
    obs_fold_kernel<true><<<blocks, THREADS, smem, st>>>(a, gpc);
  else
    obs_fold_kernel<false><<<blocks, THREADS, smem, st>>>(a, gpc);
  return (int)cudaGetLastError();
}

// the observer fold's launch shape at n chains: out = {registers, CTAs
// per SM, chain groups per CTA, CTAs}
extern "C" int obs_fold_attrs(int64_t n, int tel, int smem, int* out,
                              void* stream) {
  (void)stream;
  const cudaError_t e =
      tel ? obs_fold_grid<true>(n, smem, &out[2], &out[3], &out[0], &out[1])
          : obs_fold_grid<false>(n, smem, &out[2], &out[3], &out[0], &out[1]);
  return (int)e;
}

// the layout check of the wrapper's ctypes mirror of Obs
extern "C" int wide_obs_struct_size(void* stream) {
  (void)stream;
  return (int)sizeof(Obs);
}

// part_m, part_pv: the (n_ctas, T) per-CTA partial sums of meter and pv
extern "C" int wide_series(int64_t n, int T, const float* meter,
                           const float* pv, float* part_m, float* part_p,
                           void* stream) {
  if (T % SERIES_TILE) return (int)cudaErrorInvalidValue;
  if (n > 0 && T > 0) {
    const dim3 grid((unsigned)((n + THREADS - 1) / THREADS),
                    (unsigned)(T / SERIES_TILE));
    wide_series_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        n, T, meter, pv, part_m, part_p);
  }
  return (int)cudaGetLastError();
}
