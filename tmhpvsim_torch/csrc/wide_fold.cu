// K4 merges: the wide formulation's statistics over a block's materialised
// time-major (T, n) meter and pv (the K4 trace launch's output).
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
//                second pass).
// Plain versions: tmhpvsim_torch/kernels/wide.py wide_fold_plain and
// wide_series_plain (with obs/telemetry.py and obs/analytics.py
// fold_wide).
//
// Design.  wide_fold: one thread per chain loops over the block's T rows
// in second order, its loads coalesced across the warp's chains, and
// folds the seven statistics in registers with the block step's acc
// epilogue's own expressions (block_step.cuh), so on the same meter and
// pv it gives K3's bits.  The observers are template flags of the same
// launch, so one pass reads the arrays once whatever is on: TEL folds
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
//
// Bound: bytes.  Each reads 2 x 4 bytes per chain-second (566 MB per
// 65536 x 1080 block, 0.169 ms at 3.35 TB/s); the fold's arithmetic, K9's
// per-sample work with FLT, stays under that at this card's rates.
#include "fold.cuh"

#define SERIES_TILE 60

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
  int cohort = 0;
  if constexpr (FLT) {
    const int coh_off = a.o.hist_shared ? nb + ne : 0;
    const int len = coh_off + (a.o.coh_shared ? a.o.n_cohorts * nb : 0);
    for (int k = threadIdx.x; k < len; k += blockDim.x) s_dyn[k] = 0;
    hist = a.o.hist_shared ? s_dyn : a.o.res_hist;
    exc = a.o.hist_shared ? s_dyn + nb : a.o.exceed;
    if (a.o.n_cohorts) {
      coh_hist = a.o.coh_shared ? s_dyn + coh_off : a.o.cohort_hist;
      cohort = a.o.cohort[ii];
    }
    __syncthreads();
  }
  if (live) {
    float pv_sum = a.pv_sum[i], pv_max = a.pv_max[i],
          meter_sum = a.meter_sum[i], residual_sum = a.residual_sum[i],
          residual_min = a.residual_min[i], residual_max = a.residual_max[i];
    int n_seconds = a.n_seconds[i];
#pragma unroll 4
    for (int s = 0; s < T; ++s) {
      const int t = __ldg(&a.t[s]);
      const float meter = a.meter[(int64_t)s * n + i];
      const float ac = a.pv[(int64_t)s * n + i];
      // the acc epilogue's fold (block_step.cuh), expression for
      // expression
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
        flt_second(f, a.o, meter, ac, residual, valid, t, hist, exc,
                   coh_hist, cohort);
    }
    a.pv_sum[i] = pv_sum;
    a.pv_max[i] = pv_max;
    a.meter_sum[i] = meter_sum;
    a.residual_sum[i] = residual_sum;
    a.residual_min[i] = residual_min;
    a.residual_max[i] = residual_max;
    a.n_seconds[i] = n_seconds;
  }
  // the per-CTA partial rows (every thread takes part; a dead thread
  // holds the identities)
  if constexpr (TEL) {
    tel_epilogue(tel, 0, a.o, n, i, live, s_stage);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      // the count leaf as the JAX fold takes it: the valid seconds (an
      // exact float32 sum) times the chains, rounded once
      int nv = 0;
      for (int s = 0; s < T; ++s) nv += a.t[s] < a.duration_s ? 1 : 0;
      a.o.tel_count[0] = (float)nv * (float)n;
    }
  }
  if constexpr (FLT) {
    flt_epilogue(f, false, a.o, n, i, live, s_stage);
    if (a.o.hist_shared) {
      flush_hist(s_dyn, a.o.res_hist, nb);
      flush_hist(s_dyn + nb, a.o.exceed, ne);
    }
    if (a.o.n_cohorts) {
      if (a.o.coh_shared)
        flush_hist(s_dyn + (a.o.hist_shared ? nb + ne : 0), a.o.cohort_hist,
                   a.o.n_cohorts * nb);
      cohort_partials(f, a.o, live, cohort, s_cid, s_cuse, s_cval);
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
