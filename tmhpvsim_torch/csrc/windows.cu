// K2: one block's sampler windows; with a regime vector also K7's regime
// gather.
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
// Design.  A CTA of K2_THREADS (256) threads takes K2_CHAINS (128)
// consecutive chains, 512 CTAs in one wave at 65536 chains (at most 64
// registers: 4 CTAs an SM), in three steps of one launch:
//   0. one thread a chain (threads 0 .. K2_CHAINS - 1) loads the chain's
//      keys and derives the ones its draws start from into shared memory,
//      while the other threads derive the keys every chain of the CTA
//      shares (rbg and unsafe_rbg: chain 0's, see below);
//   1. those threads run their chain's sequential Markov hour loop
//      (asymmetric-Laplace or Student-t steps chosen by a 6-bin search,
//      clipped to [0, 1]) with the hour window staged in shared memory,
//      and advance the carry; meanwhile the other threads draw the rows
//      that read no hour window (clear-day csi, windspeed 2.14 *
//      gamma(2.69));
//   2. every thread draws the rows that do: the cloudy csi (normal or
//      scaled gamma by cloud-cover band) and the two minute-noise values
//      per minute.
// A row is drawn over (value, chain) tiles: value r of chain c by thread
// (r mod G) * K2_CHAINS + c of the G = K2_THREADS / K2_CHAINS groups, so
// a warp writes 32 consecutive chains of one value (value-major,
// coalesced; K3 reads them the same way).  Each value's arithmetic is
// that of the one-thread-per-chain kernel it replaces, expression for
// expression, so every table and the carry keep its bits.  Only the
// branch a draw selects is computed: the plain version computes both and
// selects, with the same result.  What bounds it (ab_kernels.py K2M /
// K2H, PERF.md): the threefry rows' integer hashing, not the warps in
// flight -- the one-thread-per-chain kernel's 15-16 warps an SM already
// issued them almost as fast as 32 do.  One thread a chain with the same
// shared keys and hour window was measured beside this form: 4 % slower
// under threefry2x32 (K2, K7's regime), 18 % under rbg, 2 % faster under
// unsafe_rbg (device time, H100 80GB HBM3 at 700 W, PERF.md).

// K13 (prng_impl='rbg', a 4-word key per chain): jax vmaps the window
// functions over the chains, and inside them over the window's values, so
// each batched draw takes its batch's FIRST key (philox.cuh): the Markov
// step's uniform and the Student-t normal of hour j are word c of the keys
// derived from chain 0's k_arr at hour j; a cloudy, clear-day or
// minute-noise value j of chain c is word c * w + j (w the window's
// length) of the key of chain 0 and value 0.  The gamma draws (cloudy,
// Student-t, windspeed) are per key, from the chain's own keys, as jax
// maps them.  Chain 0's keys are derived once per CTA (RShared).
//
// K14 (prng_impl='unsafe_rbg'): the same bits, but split and fold_in are
// Philox rows too (philox.cuh UKey), batched as jax batches them: the
// 4-way split of k_arr under the chain vmap takes chain 0's k_arr
// (member c at counter 40 c + 10 i), the hour loop's fold_in(k_cc, h)
// is per key (a scan index) and the transition's split and the
// Student-t's split are batched over the chains; the windows' fold_in
// over the value index is a batched datum (value j: counter 10 j + 9 of
// the seed of the window's first index), and the cloudy draw's split, the
// gamma entry splits (cloudy, Student-t, windspeed) and every draw are
// batched over (chain, value), member p = c w + j.  Only chain 0's keys
// and each member's position enter a chain's values, so the keys every
// chain shares (per hour three, per window six) are derived once per CTA
// (UShared); each thread derives its own gamma entry keys.
//
// Bound: operations.  Per chain and block it does ~(w_hours + w_cd +
// 2 * n_min) draws of a few hashes each, plus Marsaglia-Tsang loops for
// the gamma and Student-t draws; it writes (2 w_hours + w_cd + w_days +
// 2 n_min + 1) floats per chain.  It runs once per block, beside K3's
// per-second work.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "consts.cuh"
#include "philox.cuh"
#include "threefry.cuh"

#define MAX_HOURS 64

// the CTA shape: K2_THREADS threads take K2_CHAINS chains, at least
// K2_MIN_CTAS CTAs an SM (the bits do not depend on it)
#define K2_THREADS 256
#define K2_CHAINS 128
#define K2_MIN_CTAS 4
#define K2_GROUPS (K2_THREADS / K2_CHAINS)
static_assert(K2_CHAINS % 32 == 0 && K2_THREADS % K2_CHAINS == 0 &&
                  K2_GROUPS >= 2,
              "a warp takes 32 chains of one value; a CTA two groups or more");
static_assert(K2_THREADS >= MAX_HOURS + 4,
              "the shared derivations take MAX_HOURS + 4 threads");

// the kernel's key-implementation argument (kernels/windows.py _IMPL_CODE)
enum Impl { TF = 0, RBG = 1, URBG = 2 };

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

// the Markov step table's row of a state (6-bin search) and regime
__device__ __forceinline__ int step_row(float state, int regime) {
  int idx = 0;
#pragma unroll
  for (int b = 0; b < 6; ++b) idx += MK_BINS[b] < state ? 1 : 0;
  if (idx > 5) idx = 5;
  return idx + regime * 6;
}

// markov_hourly.transition for one chain, from its regime's table
__device__ __forceinline__ float transition(tf::Key key, float state,
                                            int regime) {
  const int idx = step_row(state, regime);
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

// the K13 keys a CTA shares: per hour the Markov step's AL key and the
// Student-t's normal key (of chain 0, the batch's first); per window the
// cloudy normal key, the clear-day key and the two minute-noise keys (of
// chain 0 and value 0); per chain its cloudy and windspeed keys
struct RShared {
  ph::Key4 al[MAX_HOURS], tn[MAX_HOURS];
  ph::Key4 cl_n, cd, mc, ml;
  ph::Key4 cl[K2_CHAINS], ws[K2_CHAINS];
};

// RShared's per-hour and per-window keys: derivation s of the CTA
__device__ void rbg_shared(RShared& S, const int64_t* __restrict__ k_arr,
                           const int64_t* __restrict__ k_min, int s,
                           int hour_lo, int n_hours, int cd_lo, int min_lo) {
  if (s < n_hours) {
    const ph::Key4 kb0 = ph::fold_in(
        ph::split_at(ph::load_key(k_arr, 0), 0u), (uint32_t)(hour_lo + s));
    S.al[s] = ph::split_at(kb0, 0u);
    S.tn[s] = ph::split_at(ph::split_at(kb0, 1u), 0u);
  } else if (s == MAX_HOURS) {
    S.cl_n = ph::split_at(
        ph::fold_in(ph::split_at(ph::load_key(k_arr, 0), 1u),
                    (uint32_t)hour_lo),
        0u);
  } else if (s == MAX_HOURS + 1) {
    S.cd = ph::fold_in(ph::split_at(ph::load_key(k_arr, 0), 2u),
                       (uint32_t)cd_lo);
  } else if (s == MAX_HOURS + 2) {
    const ph::Key4 km = ph::fold_in(ph::load_key(k_min, 0), (uint32_t)min_lo);
    S.mc = ph::fold_in(km, 0u);
    S.ml = ph::fold_in(km, 1u);
  }
}

// markov_hourly.transition under rbg for chain c at hour j: the batch's
// keys from S, the gamma's from the chain's own k_cc
__device__ __forceinline__ float transition_rbg(const RShared& S, int j,
                                                ph::Key4 k_cc, uint32_t h,
                                                uint64_t c, float state,
                                                int regime) {
  const int idx = step_row(state, regime);
  const float loc = MK_LOC[idx], scale = MK_SCALE[idx];
  float step;
  if (MK_IS_T[idx] > 0.5f) {
    // jax.random.t: the normal batched, the gamma per key
    const float nrm = tf::normal_from_bits(ph::word(S.tn[j], c));
    const float half_df = MK_DF[idx] / 2.0f;
    const ph::Key4 kt = ph::split_at(ph::fold_in(k_cc, h), 1u);
    const float g = tf::gamma(ph::split_at(kt, 1u), half_df);
    step = fmaf(scale, nrm * sqrtf(half_df / g), loc);
  } else {
    const float q = tf::uniform_range(ph::word(S.al[j], c), 1.17549435e-38f,
                                      1.0f);
    step = fmaf(scale, al_ppf(q, MK_KAPPA[idx]), loc);
  }
  return fminf(fmaxf(state + step, 0.0f), 1.0f);
}

// the K14 keys a CTA shares: per hour the Markov step's AL key, the
// Student-t's normal key and gamma key (of chain 0, the batch's first);
// per window the cloudy normal / gamma keys, the clear-day, windspeed and
// two minute-noise keys (of chain 0 and value 0)
struct UShared {
  ph::UKey al[MAX_HOURS], tn[MAX_HOURS], tg[MAX_HOURS];
  ph::UKey cl_n, cl_g, cd, ws, mc, ml;
};

// UShared's keys: derivation s of the CTA
__device__ void urbg_shared(UShared& S, const int64_t* __restrict__ k_arr,
                            const int64_t* __restrict__ k_min, int s,
                            int hour_lo, int n_hours, int cd_lo, int day_lo,
                            int min_lo) {
  if (s < n_hours) {
    const ph::UKey ka0 = ph::load_ukey(k_arr, 0);
    const ph::UKey kh =
        ph::row(ka0, 0ull) ^ ph::fold_row((uint32_t)(hour_lo + s), 0ull);
    S.al[s] = ph::row(kh, 0ull);
    const ph::UKey kt = ph::row(kh, 10ull);
    S.tn[s] = ph::row(kt, 0ull);
    S.tg[s] = ph::row(kt, 10ull);
  } else if (s == MAX_HOURS) {
    const ph::UKey k =
        ph::row(ph::load_ukey(k_arr, 0), 10ull) ^
        ph::fold_row((uint32_t)hour_lo, 0ull);
    S.cl_n = ph::row(k, 0ull);
    S.cl_g = ph::row(k, 10ull);
  } else if (s == MAX_HOURS + 1) {
    S.cd = ph::row(ph::load_ukey(k_arr, 0), 20ull) ^
           ph::fold_row((uint32_t)cd_lo, 0ull);
  } else if (s == MAX_HOURS + 2) {
    S.ws = ph::row(ph::load_ukey(k_arr, 0), 30ull) ^
           ph::fold_row((uint32_t)day_lo, 0ull);
  } else if (s == MAX_HOURS + 3) {
    const ph::UKey km =
        ph::load_ukey(k_min, 0) ^ ph::fold_row((uint32_t)min_lo, 0ull);
    S.mc = ph::fold_in(km, 0u);
    S.ml = ph::fold_in(km, 1u);
  }
}

// markov_hourly.transition under unsafe_rbg for chain c at hour j
__device__ __forceinline__ float transition_urbg(const UShared& S, int j,
                                                 uint64_t c, float state,
                                                 int regime) {
  const int idx = step_row(state, regime);
  const float loc = MK_LOC[idx], scale = MK_SCALE[idx];
  float step;
  if (MK_IS_T[idx] > 0.5f) {
    // jax.random.t: split and normal batched, the gamma's entry batched
    const float nrm = tf::normal_from_bits(ph::word(S.tn[j], c));
    const float half_df = MK_DF[idx] / 2.0f;
    const float g =
        tf::gamma_from(ph::split_batched(S.tg[j], c, 1u, 0u), half_df);
    step = fmaf(scale, nrm * sqrtf(half_df / g), loc);
  } else {
    const float q =
        tf::uniform_range(ph::word(S.al[j], c), 1.17549435e-38f, 1.0f);
    step = fmaf(scale, al_ppf(q, MK_KAPPA[idx]), loc);
  }
  return fminf(fmaxf(state + step, 0.0f), 1.0f);
}

// the threefry keys a CTA stages: each chain's cloudy, clear-day,
// windspeed and minute-noise keys
struct TShared {
  tf::Key cl[K2_CHAINS], cd[K2_CHAINS], ws[K2_CHAINS], km[K2_CHAINS];
};

template <int IMPL>
using Shared = typename std::conditional<
    IMPL == TF, TShared,
    typename std::conditional<IMPL == RBG, RShared, UShared>::type>::type;

struct WinArgs {
  int64_t n;
  const int64_t *k_arr, *k_min;
  const float *cc_carry, *cc0;
  const int* regimes;
  int hour_lo, n_hours, n_cloudy, hour_next_lo, cd_lo, n_cd, day_lo, n_days,
      min_lo, n_min;
  const int* mh_idx;
  const float* mh_frac;
  float *out_cc, *out_cloudy, *out_cd, *out_ws, *out_ml, *out_mc, *out_carry;
};

// one drawn value of chain i (lane l of the CTA's chains, its hour window
// at cc[h * K2_CHAINS]): row r of the window's cloudy, clear-day,
// windspeed and minute-noise values, in that order
template <int IMPL>
__device__ __forceinline__ void draw_value(const Shared<IMPL>& S,
                                           const WinArgs& a, int64_t i,
                                           int l, const float* cc, float c0,
                                           int r) {
  const int64_t n = a.n;
  const uint64_t c = (uint64_t)i;
  const int r_cd = a.n_cloudy, r_ws = r_cd + a.n_cd, r_min = r_ws + a.n_days;
  if (r < r_cd) {
    // cloudy csi: value k >= 2 sees cc[k-1], the primers see cc0
    const int j = r, idx = a.hour_lo + j;
    float cc_at = c0;
    if (idx >= 2) {
      int pos = idx - 1 - a.hour_lo;
      const int w = a.n_hours > 0 ? a.n_hours : 1;
      pos = pos < 0 ? 0 : (pos > w - 1 ? w - 1 : pos);
      cc_at = cc[pos * K2_CHAINS];
    }
    const bool mid = cc_at < 0.875f;
    const float ga = mid ? CL_MID_A : CL_HIGH_A;
    const float sc = mid ? CL_MID_SCALE : CL_HIGH_SCALE;
    float v;
    if constexpr (IMPL == TF) {
      const tf::Key key = tf::fold_in(S.cl[l], (uint32_t)idx);
      v = cc_at < 0.75f
              ? CL_LOC + CL_SCALE * tf::normal(tf::split_at(key, 0u), 0u)
              : sc * tf::gamma(tf::split_at(key, 1u), ga);
    } else if constexpr (IMPL == RBG) {
      v = cc_at < 0.75f
              ? CL_LOC + CL_SCALE * tf::normal_from_bits(ph::word(
                                        S.cl_n, c * a.n_cloudy + j))
              : sc * tf::gamma(ph::split_at(ph::fold_in(S.cl[l],
                                                        (uint32_t)idx),
                                            1u),
                               ga);
    } else {
      const uint64_t p = c * (uint64_t)a.n_cloudy + (uint64_t)j;
      v = cc_at < 0.75f
              ? CL_LOC + CL_SCALE * tf::normal_from_bits(ph::word(S.cl_n, p))
              : sc * tf::gamma_from(ph::split_batched(S.cl_g, p, 1u, 0u),
                                    ga);
    }
    a.out_cloudy[j * n + i] = v;
  } else if (r < r_ws) {
    const int j = r - r_cd;
    float z;
    if constexpr (IMPL == TF)
      z = tf::normal(tf::fold_in(S.cd[l], (uint32_t)(a.cd_lo + j)), 0u);
    else
      z = tf::normal_from_bits(
          ph::word(S.cd, c * (uint64_t)a.n_cd + (uint64_t)j));
    a.out_cd[j * n + i] = CD_LOC + CD_SCALE * z;
  } else if (r < r_min) {
    const int j = r - r_ws;
    float g;
    if constexpr (IMPL == TF)
      g = tf::gamma(tf::fold_in(S.ws[l], (uint32_t)(a.day_lo + j)),
                    WS_SHAPE);
    else if constexpr (IMPL == RBG)
      g = tf::gamma(ph::fold_in(S.ws[l], (uint32_t)(a.day_lo + j)),
                    WS_SHAPE);
    else
      g = tf::gamma_from(
          ph::split_batched(S.ws, c * (uint64_t)a.n_days + (uint64_t)j, 1u,
                            0u),
          WS_SHAPE);
    a.out_ws[j * n + i] = WS_SCALE * g;
  } else {
    // minute noise: sigma from the cloud cover at the value's draw instant
    const int j = r - r_min;
    const int h = __ldg(&a.mh_idx[j]);
    const float f = __ldg(&a.mh_frac[j]);
    const float cc_at = cc[h * K2_CHAINS] * (1.0f - f) +
                        cc[(h + 1) * K2_CHAINS] * f;
    const float s_cloudy = SIGMA_MIN * (MN_CLOUDY_S0 + MN_CLOUDY_S1X8 * cc_at);
    const float s_clear = SIGMA_MIN * (MN_CLEAR_S0 + MN_CLEAR_S1X8 * cc_at);
    float zc, zl;
    if constexpr (IMPL == TF) {
      const tf::Key key = tf::fold_in(S.km[l], (uint32_t)(a.min_lo + j));
      zc = tf::normal(tf::fold_in(key, 0u), 0u);
      zl = tf::normal(tf::fold_in(key, 1u), 0u);
    } else {
      const uint64_t w = c * (uint64_t)a.n_min + (uint64_t)j;
      zc = tf::normal_from_bits(ph::word(S.mc, w));
      zl = tf::normal_from_bits(ph::word(S.ml, w));
    }
    a.out_mc[j * n + i] = 1.0f + s_cloudy * zc;
    a.out_ml[j * n + i] = 1.0f + s_clear * zl;
  }
}

// K2 (threefry), K13 in K2 (rbg), K14 in K2 (unsafe_rbg); dynamic shared
// memory: the hour window, max(n_hours, 1) x K2_CHAINS floats
template <int IMPL>
__global__ void __launch_bounds__(K2_THREADS, K2_MIN_CTAS)
    sampler_windows_kernel(const WinArgs a) {
  __shared__ Shared<IMPL> S;
  __shared__ float s_c0[K2_CHAINS];
  extern __shared__ float s_cc[];
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * K2_CHAINS;
  const int64_t n = a.n;

  // step 0: a thread a chain stages the chain's own keys, while the
  // other threads derive the CTA's shared keys (derivation s: threads
  // K2_CHAINS, K2_CHAINS + 1, ... take s = 0, 1, ...)
  const bool lead = t < K2_CHAINS && base + t < n;
  const int64_t i = base + t;
  tf::Key tk_cc = {0u, 0u};
  ph::Key4 rk_cc = {0u, 0u, 0u, 0u};
  if (lead) {
    if constexpr (IMPL == TF) {
      const tf::Key ka = tf::load_key(a.k_arr, i);
      tk_cc = tf::split_at(ka, 0u);
      if (a.n_cloudy) S.cl[t] = tf::split_at(ka, 1u);
      if (a.n_cd) S.cd[t] = tf::split_at(ka, 2u);
      if (a.n_days) S.ws[t] = tf::split_at(ka, 3u);
      if (a.n_min) S.km[t] = tf::load_key(a.k_min, i);
    } else if constexpr (IMPL == RBG) {
      const ph::Key4 ka = ph::load_key(a.k_arr, i);
      rk_cc = ph::split_at(ka, 0u);
      if (a.n_cloudy) S.cl[t] = ph::split_at(ka, 1u);
      if (a.n_days) S.ws[t] = ph::split_at(ka, 3u);
    }
    s_c0[t] = a.cc0[i];
  }
  if constexpr (IMPL != TF) {
    const int s = (t + K2_THREADS - K2_CHAINS) % K2_THREADS;
    if constexpr (IMPL == RBG)
      rbg_shared(S, a.k_arr, a.k_min, s, a.hour_lo, a.n_hours, a.cd_lo,
                 a.min_lo);
    else
      urbg_shared(S, a.k_arr, a.k_min, s, a.hour_lo, a.n_hours, a.cd_lo,
                  a.day_lo, a.min_lo);
  }
  __syncthreads();
  const int l = t % K2_CHAINS;
  const int64_t ic = base + l;
  const bool live = ic < n;
  // the rows that read no hour window: clear-day, then windspeed
  const int n_free = a.n_cd + a.n_days;
  // step 1: the hourly cloud cover, the chain's sequential Markov loop
  if (lead) {
    const float carry_in = a.cc_carry[i];
    const int regime = a.regimes != nullptr ? a.regimes[i] : 0;
    float state = carry_in;
    for (int j = 0; j < a.n_hours; ++j) {
      const uint32_t h = (uint32_t)(a.hour_lo + j);
      if constexpr (IMPL == TF)
        state = transition(tf::fold_in(tk_cc, h), state, regime);
      else if constexpr (IMPL == RBG)
        state = transition_rbg(S, j, rk_cc, h, (uint64_t)i, state, regime);
      else
        state = transition_urbg(S, j, (uint64_t)i, state, regime);
      s_cc[j * K2_CHAINS + t] = state;
      a.out_cc[j * n + i] = state;
    }
    float carry = carry_in;
    if (a.n_hours > 0 && a.hour_next_lo != a.hour_lo) {
      int adv = a.hour_next_lo - a.hour_lo - 1;
      adv = adv < 0 ? 0 : (adv > a.n_hours - 1 ? a.n_hours - 1 : adv);
      carry = s_cc[adv * K2_CHAINS + t];
    }
    a.out_carry[i] = carry;
  } else if (t >= K2_CHAINS && live) {
    // meanwhile the other threads draw the rows that read no hour window
    for (int q = t / K2_CHAINS - 1; q < n_free; q += K2_GROUPS - 1)
      draw_value<IMPL>(S, a, ic, l, s_cc + l, 0.0f, a.n_cloudy + q);
  }
  __syncthreads();

  // step 2: every thread, the rows that read the hour window
  if (!live) return;
  const float c0 = s_c0[l];
  const int rows = a.n_cloudy + a.n_min;
  for (int q = t / K2_CHAINS; q < rows; q += K2_GROUPS)
    draw_value<IMPL>(S, a, ic, l, s_cc + l, c0,
                     q < a.n_cloudy ? q : q + n_free);
}

template <int IMPL>
static int launch(const WinArgs& a, cudaStream_t st) {
  const unsigned blocks = (unsigned)((a.n + K2_CHAINS - 1) / K2_CHAINS);
  const size_t smem =
      (size_t)(a.n_hours > 0 ? a.n_hours : 1) * K2_CHAINS * sizeof(float);
  sampler_windows_kernel<IMPL><<<blocks, K2_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// impl: 0 threefry2x32, 1 rbg, 2 unsafe_rbg
extern "C" int sampler_windows(
    int64_t n, const int64_t* k_arr, const int64_t* k_min,
    const float* cc_carry, const float* cc0, const int* regimes,
    int hour_lo, int n_hours, int n_cloudy, int hour_next_lo, int cd_lo,
    int n_cd, int day_lo, int n_days, int min_lo, int n_min, const int* mh_idx,
    const float* mh_frac, float* out_cc, float* out_cloudy, float* out_cd,
    float* out_ws, float* out_ml, float* out_mc, float* out_carry,
    int impl, void* stream) {
  if (n_hours > MAX_HOURS || n_cloudy > MAX_HOURS || impl < TF ||
      impl > URBG)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const WinArgs a = {n,       k_arr,  k_min,      cc_carry,   cc0,
                     regimes, hour_lo, n_hours,   n_cloudy,   hour_next_lo,
                     cd_lo,   n_cd,   day_lo,     n_days,     min_lo,
                     n_min,   mh_idx, mh_frac,    out_cc,     out_cloudy,
                     out_cd,  out_ws, out_ml,     out_mc,     out_carry};
  cudaStream_t st = (cudaStream_t)stream;
  return impl == URBG ? launch<URBG>(a, st)
         : impl == RBG ? launch<RBG>(a, st)
                       : launch<TF>(a, st);
}

// the launch shape of impl's kernel with an n_hours window: out =
// {registers, CTAs per SM, local bytes}
template <int IMPL>
static int attrs(int n_hours, int* out) {
  auto kernel = sampler_windows_kernel<IMPL>;
  const size_t smem =
      (size_t)(n_hours > 0 ? n_hours : 1) * K2_CHAINS * sizeof(float);
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel,
                                                      K2_THREADS, smem);
  out[0] = fa.numRegs;
  out[2] = (int)fa.localSizeBytes;
  return (int)e;
}

extern "C" int windows_attrs(int impl, int n_hours, int* out, void* stream) {
  (void)stream;
  return impl == URBG ? attrs<URBG>(n_hours, out)
         : impl == RBG ? attrs<RBG>(n_hours, out)
                       : attrs<TF>(n_hours, out);
}
