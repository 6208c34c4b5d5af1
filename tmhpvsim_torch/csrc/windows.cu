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
// K13 (prng_impl='rbg', a 4-word key per chain): jax vmaps the window
// functions over the chains, and inside them over the window's values, so
// each batched draw takes its batch's FIRST key (philox.cuh): the Markov
// step's uniform and the Student-t normal of hour j are word c of the keys
// derived from chain 0's k_arr at hour j; a cloudy, clear-day or
// minute-noise value j of chain c is word c * w + j (w the window's
// length) of the key of chain 0 and value 0.  The gamma draws (cloudy,
// Student-t, windspeed) are per key, from the chain's own keys, as jax
// maps them.  sampler_windows_rbg_kernel draws so; its plain version is
// the same windows_plain on rbg keys.
//
// Bound: operations.  Per chain and block it does ~(w_hours + w_cd +
// 2 * n_min) draws of a few hashes each, plus Marsaglia-Tsang loops for
// the gamma and Student-t draws; it writes (2 w_hours + w_cd + w_days +
// 2 n_min + 1) floats per chain.  It runs once per block, beside K3's
// per-second work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "consts.cuh"
#include "philox.cuh"
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

// markov_hourly.transition under rbg: kb0 the batch's key of this hour
// (chain 0's), kb the chain's own, c the chain's index in the batch
__device__ __forceinline__ float transition_rbg(ph::Key4 kb0, ph::Key4 kb,
                                                uint64_t c, float state,
                                                int regime) {
  int idx = 0;
#pragma unroll
  for (int b = 0; b < 6; ++b) idx += MK_BINS[b] < state ? 1 : 0;
  if (idx > 5) idx = 5;
  idx += regime * 6;
  const float loc = MK_LOC[idx], scale = MK_SCALE[idx];
  float step;
  if (MK_IS_T[idx] > 0.5f) {
    // jax.random.t: the normal batched, the gamma per key
    const ph::Key4 kt0 = ph::split_at(kb0, 1u), kt = ph::split_at(kb, 1u);
    const float nrm =
        tf::normal_from_bits(ph::word(ph::split_at(kt0, 0u), c));
    const float half_df = MK_DF[idx] / 2.0f;
    const float g = tf::gamma(ph::split_at(kt, 1u), half_df);
    step = fmaf(scale, nrm * sqrtf(half_df / g), loc);
  } else {
    const float q = tf::uniform_range(ph::word(ph::split_at(kb0, 0u), c),
                                      1.17549435e-38f, 1.0f);
    step = fmaf(scale, al_ppf(q, MK_KAPPA[idx]), loc);
  }
  return fminf(fmaxf(state + step, 0.0f), 1.0f);
}

// the rbg windows of one chain (see the header): everything but the
// Markov carry, which the caller handles as in the threefry kernel
__device__ void windows_rbg(
    int64_t i, int64_t n, const int64_t* __restrict__ k_arr,
    const int64_t* __restrict__ k_min, float state, float c0, int regime,
    int hour_lo, int n_hours, int n_cloudy, int cd_lo, int n_cd, int day_lo,
    int n_days, int min_lo, int n_min, const int* __restrict__ mh_idx,
    const float* __restrict__ mh_frac, float* cc, float* __restrict__ out_cc,
    float* __restrict__ out_cloudy, float* __restrict__ out_cd,
    float* __restrict__ out_ws, float* __restrict__ out_ml,
    float* __restrict__ out_mc) {
  const ph::Key4 ka = ph::load_key(k_arr, i), ka0 = ph::load_key(k_arr, 0);
  const ph::Key4 k_cc = ph::split_at(ka, 0u), k_cc0 = ph::split_at(ka0, 0u);
  const uint64_t c = (uint64_t)i;
  for (int j = 0; j < n_hours; ++j) {
    const uint32_t h = (uint32_t)(hour_lo + j);
    state = transition_rbg(ph::fold_in(k_cc0, h), ph::fold_in(k_cc, h), c,
                           state, regime);
    cc[j] = state;
    out_cc[j * n + i] = state;
  }
  // cloudy csi: the normal's batch key is value 0's of chain 0
  const ph::Key4 k_cl = ph::split_at(ka, 1u);
  const ph::Key4 kn0 =
      ph::split_at(ph::fold_in(ph::split_at(ka0, 1u), (uint32_t)hour_lo), 0u);
  for (int j = 0; j < n_cloudy; ++j) {
    const int idx = hour_lo + j;
    float cc_at = c0;
    if (idx >= 2) {
      int pos = idx - 1 - hour_lo;
      const int w = n_hours > 0 ? n_hours : 1;
      pos = pos < 0 ? 0 : (pos > w - 1 ? w - 1 : pos);
      cc_at = cc[pos];
    }
    float v;
    if (cc_at < 0.75f) {
      v = CL_LOC + CL_SCALE * tf::normal_from_bits(
                                  ph::word(kn0, c * n_cloudy + j));
    } else {
      const bool mid = cc_at < 0.875f;
      const float a = mid ? CL_MID_A : CL_HIGH_A;
      const float sc = mid ? CL_MID_SCALE : CL_HIGH_SCALE;
      v = sc * tf::gamma(ph::split_at(ph::fold_in(k_cl, (uint32_t)idx), 1u),
                         a);
    }
    out_cloudy[j * n + i] = v;
  }
  const ph::Key4 kd0 =
      ph::fold_in(ph::split_at(ka0, 2u), (uint32_t)cd_lo);
  for (int j = 0; j < n_cd; ++j)
    out_cd[j * n + i] =
        CD_LOC + CD_SCALE * tf::normal_from_bits(ph::word(kd0, c * n_cd + j));
  const ph::Key4 k_ws = ph::split_at(ka, 3u);
  for (int j = 0; j < n_days; ++j)
    out_ws[j * n + i] =
        WS_SCALE * tf::gamma(ph::fold_in(k_ws, (uint32_t)(day_lo + j)),
                             WS_SHAPE);
  const ph::Key4 km = ph::fold_in(ph::load_key(k_min, 0), (uint32_t)min_lo);
  const ph::Key4 km_cloudy = ph::fold_in(km, 0u), km_clear = ph::fold_in(km, 1u);
  for (int j = 0; j < n_min; ++j) {
    const int h = mh_idx[j];
    const float f = mh_frac[j];
    const float cc_at = cc[h] * (1.0f - f) + cc[h + 1] * f;
    const float s_cloudy = SIGMA_MIN * (MN_CLOUDY_S0 + MN_CLOUDY_S1X8 * cc_at);
    const float s_clear = SIGMA_MIN * (MN_CLEAR_S0 + MN_CLEAR_S1X8 * cc_at);
    const uint64_t w = c * n_min + j;
    out_mc[j * n + i] =
        1.0f + s_cloudy * tf::normal_from_bits(ph::word(km_cloudy, w));
    out_ml[j * n + i] =
        1.0f + s_clear * tf::normal_from_bits(ph::word(km_clear, w));
  }
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

// K13: the same windows from rbg keys (windows_rbg), the carry advanced
// as above
__global__ void sampler_windows_rbg_kernel(
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
  float cc[MAX_HOURS];
  const float carry_in = cc_carry[i];
  windows_rbg(i, n, k_arr, k_min, carry_in, cc0[i],
              regimes != nullptr ? regimes[i] : 0, hour_lo, n_hours,
              n_cloudy, cd_lo, n_cd, day_lo, n_days, min_lo, n_min, mh_idx,
              mh_frac, cc, out_cc, out_cloudy, out_cd, out_ws, out_ml,
              out_mc);
  float carry = carry_in;
  if (n_hours > 0 && hour_next_lo != hour_lo) {
    int adv = hour_next_lo - hour_lo - 1;
    adv = adv < 0 ? 0 : (adv > n_hours - 1 ? n_hours - 1 : adv);
    carry = cc[adv];
  }
  out_carry[i] = carry;
}

extern "C" int sampler_windows(
    int64_t n, const int64_t* k_arr, const int64_t* k_min,
    const float* cc_carry, const float* cc0, const int* regimes,
    int hour_lo, int n_hours, int n_cloudy, int hour_next_lo, int cd_lo,
    int n_cd, int day_lo, int n_days, int min_lo, int n_min, const int* mh_idx,
    const float* mh_frac, float* out_cc, float* out_cloudy, float* out_cd,
    float* out_ws, float* out_ml, float* out_mc, float* out_carry,
    int rbg, void* stream) {
  if (n_hours > MAX_HOURS || n_cloudy > MAX_HOURS) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int threads = 128;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    auto kernel = rbg ? sampler_windows_rbg_kernel : sampler_windows_kernel;
    kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        n, k_arr, k_min, cc_carry, cc0, regimes, hour_lo, n_hours, n_cloudy,
        hour_next_lo, cd_lo, n_cd, day_lo, n_days, min_lo, n_min, mh_idx,
        mh_frac, out_cc, out_cloudy, out_cd, out_ws, out_ml, out_mc,
        out_carry);
  }
  return (int)cudaGetLastError();
}
