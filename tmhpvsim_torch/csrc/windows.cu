// K2: one block's sampler windows, one thread per chain; with a regime
// vector also K7's regime gather.
//
// Replaces: Simulation._windows_one_chain (tmhpvsim_tpu/engine/
// simulation.py:785-828) vmapped over chains, i.e. clearsky_index.cc_window
// -> markov_hourly.chain_window (:96), cloudy_window (:134),
// clear_day_window (:153), ws_window (:165), minute_noise_values_device
// (:212) and value_major_tables (:447); K7: markov_hourly.select_regime
// (:70) as the vmapped window gathers it (engine/simulation.py:800-806).
// Plain version: tmhpvsim_torch/kernels/windows.py windows_plain.
//
// Regimes: the three stacked 6-bin step tables (3 x 6 x 5 floats) live in
// constant memory, flattened regime-major; a chain reads row
// regime * 6 + bin.  Without a regime vector every chain reads regime 0,
// the Munich table, with the arithmetic of the single-table kernel.
//
// Each thread runs its chain's sequential hour loop of Markov transitions
// (asymmetric-Laplace or Student-t steps chosen by a 6-bin search, clipped
// to [0, 1]), keeps the hour window in registers/local memory for the
// cloudy and minute-noise draws, then draws cloudy csi (normal or scaled
// gamma by cloud-cover band), clear-day csi, windspeed (2.14 * gamma(2.69))
// and the two minute-noise values per minute.  Outputs are value-major
// (value, chain) so consecutive threads write consecutive addresses, and
// K3 reads them the same way.  Only the branch a draw selects is computed:
// the plain version computes both and selects, with the same result.
//
// Bound: operations.  Per chain and block it does ~(w_hours + w_cd +
// 2 * n_min) draws of a few hashes each, plus Marsaglia-Tsang loops for
// the gamma and Student-t draws; it writes (2 w_hours + w_cd + w_days +
// 2 n_min + 1) floats per chain.  It runs once per block, beside K3's
// per-second work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "consts.cuh"
#include "threefry.cuh"

#define MAX_HOURS 64

// distributions.asymmetric_laplace_ppf, with XLA's CPU contraction of
// 1 + k^2 in the split and the upper branch (not in the lower one)
__device__ __forceinline__ float al_ppf(float q, float kappa) {
  const float k2 = kappa * kappa;
  const float one_k2 = fmaf(kappa, kappa, 1.0f);
  const float split = k2 / one_k2;
  if (q < split)
    return kappa * tf::xla_log(fmaxf((1.0f + k2) / k2 * q, 1e-38f));
  return -(1.0f / kappa) * tf::xla_log(fmaxf(one_k2 * (1.0f - q), 1e-38f));
}

// markov_hourly.transition for one chain, from its regime's table
__device__ __forceinline__ float transition(tf::Key key, float state,
                                            int regime) {
  int idx = 0;
#pragma unroll
  for (int b = 0; b < 6; ++b) idx += MK_BINS[b] < state ? 1 : 0;
  if (idx > 5) idx = 5;
  idx += regime * 6;
  const float loc = MK_LOC[idx], scale = MK_SCALE[idx];
  float step;
  if (MK_IS_T[idx] > 0.5f) {
    step = fmaf(scale, tf::student_t(tf::split_at(key, 1u), MK_DF[idx]), loc);
  } else {
    const float q = tf::uniform_tiny(tf::split_at(key, 0u));
    step = fmaf(scale, al_ppf(q, MK_KAPPA[idx]), loc);
  }
  return fminf(fmaxf(state + step, 0.0f), 1.0f);
}

__global__ void sampler_windows_kernel(
    int64_t n, const int64_t* __restrict__ k_arr,
    const int64_t* __restrict__ k_min, const float* __restrict__ cc_carry,
    const float* __restrict__ cc0, const int* __restrict__ regimes,
    int hour_lo, int n_hours, int n_cloudy,
    int hour_next_lo, int cd_lo, int n_cd, int day_lo, int n_days,
    int min_lo, int n_min, const int* __restrict__ mh_idx,
    const float* __restrict__ mh_frac, float* __restrict__ out_cc,
    float* __restrict__ out_cloudy, float* __restrict__ out_cd,
    float* __restrict__ out_ws, float* __restrict__ out_ml,
    float* __restrict__ out_mc, float* __restrict__ out_carry) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const tf::Key ka = tf::load_key(k_arr, i);
  const tf::Key k_cc = tf::split_at(ka, 0u), k_cloudy = tf::split_at(ka, 1u),
                k_day = tf::split_at(ka, 2u), k_ws = tf::split_at(ka, 3u);

  // hourly cloud cover: the chain's sequential Markov loop
  float cc[MAX_HOURS];
  const float carry_in = cc_carry[i];
  const int regime = regimes != nullptr ? regimes[i] : 0;
  float state = carry_in;
  for (int j = 0; j < n_hours; ++j) {
    state = transition(tf::fold_in(k_cc, (uint32_t)(hour_lo + j)), state,
                       regime);
    cc[j] = state;
    out_cc[j * n + i] = state;
  }
  float carry = carry_in;
  if (n_hours > 0 && hour_next_lo != hour_lo) {
    int adv = hour_next_lo - hour_lo - 1;
    adv = adv < 0 ? 0 : (adv > n_hours - 1 ? n_hours - 1 : adv);
    carry = cc[adv];
  }
  out_carry[i] = carry;

  // cloudy csi: value k >= 2 sees cc[k-1], the primers see cc0
  const float c0 = cc0[i];
  for (int j = 0; j < n_cloudy; ++j) {
    const int idx = hour_lo + j;
    float cc_at = c0;
    if (idx >= 2) {
      int pos = idx - 1 - hour_lo;
      const int w = n_hours > 0 ? n_hours : 1;
      pos = pos < 0 ? 0 : (pos > w - 1 ? w - 1 : pos);
      cc_at = cc[pos];
    }
    const tf::Key key = tf::fold_in(k_cloudy, (uint32_t)idx);
    float v;
    if (cc_at < 0.75f) {
      v = CL_LOC + CL_SCALE * tf::normal(tf::split_at(key, 0u), 0u);
    } else {
      const bool mid = cc_at < 0.875f;
      const float a = mid ? CL_MID_A : CL_HIGH_A;
      const float sc = mid ? CL_MID_SCALE : CL_HIGH_SCALE;
      v = sc * tf::gamma(tf::split_at(key, 1u), a);
    }
    out_cloudy[j * n + i] = v;
  }

  for (int j = 0; j < n_cd; ++j) {
    const tf::Key key = tf::fold_in(k_day, (uint32_t)(cd_lo + j));
    out_cd[j * n + i] = CD_LOC + CD_SCALE * tf::normal(key, 0u);
  }
  for (int j = 0; j < n_days; ++j) {
    const tf::Key key = tf::fold_in(k_ws, (uint32_t)(day_lo + j));
    out_ws[j * n + i] = WS_SCALE * tf::gamma(key, WS_SHAPE);
  }

  // minute noise: sigma from the cloud cover at the value's draw instant
  const tf::Key km = tf::load_key(k_min, i);
  for (int j = 0; j < n_min; ++j) {
    const int h = mh_idx[j];
    const float f = mh_frac[j];
    const float cc_at = cc[h] * (1.0f - f) + cc[h + 1] * f;
    const tf::Key key = tf::fold_in(km, (uint32_t)(min_lo + j));
    const float s_cloudy = SIGMA_MIN * (MN_CLOUDY_S0 + MN_CLOUDY_S1X8 * cc_at);
    const float s_clear = SIGMA_MIN * (MN_CLEAR_S0 + MN_CLEAR_S1X8 * cc_at);
    out_mc[j * n + i] =
        1.0f + s_cloudy * tf::normal(tf::fold_in(key, 0u), 0u);
    out_ml[j * n + i] = 1.0f + s_clear * tf::normal(tf::fold_in(key, 1u), 0u);
  }
}

extern "C" int sampler_windows(
    int64_t n, const int64_t* k_arr, const int64_t* k_min,
    const float* cc_carry, const float* cc0, const int* regimes,
    int hour_lo, int n_hours, int n_cloudy, int hour_next_lo, int cd_lo,
    int n_cd, int day_lo, int n_days, int min_lo, int n_min, const int* mh_idx,
    const float* mh_frac, float* out_cc, float* out_cloudy, float* out_cd,
    float* out_ws, float* out_ml, float* out_mc, float* out_carry,
    void* stream) {
  if (n_hours > MAX_HOURS || n_cloudy > MAX_HOURS) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int threads = 128;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    sampler_windows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        n, k_arr, k_min, cc_carry, cc0, regimes, hour_lo, n_hours, n_cloudy,
        hour_next_lo, cd_lo, n_cd, day_lo, n_days, min_lo, n_min, mh_idx,
        mh_frac, out_cc, out_cloudy, out_cd, out_ws, out_ml, out_mc,
        out_carry);
  }
  return (int)cudaGetLastError();
}
