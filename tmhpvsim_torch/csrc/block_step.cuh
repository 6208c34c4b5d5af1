// K3 / K4 / K6 / K6s / K7 / K8 / K9 / K10 / K12 (with K11 inlined): one
// block, one thread per chain, looping over the block's seconds; a template
// over the kernel set (Exact | Table), the compute dtype (F32 | BF16, K12),
// the epilogue (acc | series | trace | scenario | acc producer), the
// geometry mode (shared rows | per-chain site | per-chain strided) and,
// for acc, the telemetry observer.  block_step.cu
// instantiates it for the Exact set, block_step_table.cu for the Table set
// (K11, tables.cuh), block_step_bf16.cu and block_step_bf16_table.cu for
// both sets under BF16: each is its own library, built by its own nvcc
// process.
//
// Replaces (tmhpvsim_tpu/engine/simulation.py):
//   acc    Simulation._block_step_scan_acc (:1276), i.e.
//          _scan_block_setup.step (:1190-1242) plus _make_acc_body
//          (:1246-1272) -- K3;
//   series _block_step_scan_series (:1692; same values as the scan2 form
//          :1667) -- K4, with series_sum as its second pass;
//   trace  _block_step (:844-956), every chain's meter and pv -- K4;
//   site   solar.device_geometry (models/solar.py:434-486, called from the
//          scan step at :1204-1213) per chain and second -- K6;
//   strided solar.device_geometry on the stride grid (:1144-1166; the wide
//          step :868-900) and solar.interp_sampled (models/solar.py:587)
//          per second -- K6s;
//   Table  models/tables.py table_kernels (:354) in every transcendental
//          of the solar / pv chain (Plan.kernel_impl='table') -- K11;
//   fleet  the per-site transforms of a heterogeneous fleet (:1228-1238;
//          :931-938 in the wide step), in every epilogue -- K7;
//   TEL    _make_acc_tel_body / _block_step_scan_acc_tel (:1298-1337):
//          obs/telemetry.py fold_second (:110) + reduce_chainwise (:157)
//          -- K8 alone;
//   prod   _make_acc_fleet_body / _block_step_scan_acc_fleet (:1394,
//          :1481; with telemetry :1436, :1524), two launches: this
//          epilogue, the acc producer, folds K3's statistics and writes
//          the block's meter, pv, csi and covered flags; obs_fold
//          (wide_fold.cu) folds obs/analytics.py fold_second (:223) +
//          reduce_chainwise (:311) and, with telemetry, K8's over them
//          -- K9, K8 + K9;
//   scen   _block_step_scan_scenario / _scenario_block_core (:1834,
//          :1871-1937), two launches: this epilogue, the producer, writes
//          the step's meter and pv; scenario_fold_kernel folds, per
//          scenario row, the knob transform, selectors, horizon mask, the
//          seven statistics and a risk FleetAcc with its reduce_chainwise
//          -- K10;
// and the pre-drawn streams of clearsky_index.scan_draws_tmajor /
// meter_block_tmajor (:278-319).  Plain versions:
// tmhpvsim_torch/kernels/block_step.py block_step_plain, series_plain,
// series_sum_plain, trace_plain, block_step_obs_plain (obs_producer_plain
// + obs_fold_plain), scenario_producer_plain, scenario_fold_plain, and
// models/solar.py
// device_geometry
// (with obs/telemetry.py and obs/analytics.py fold_second).
//
// Design.  The per-second pipeline is written once, in block_step_body's
// loop over a tile's seconds: the table lerps, the renewal step, csi,
// power() and the meter.  The renewal carry (and the seven statistics of
// the acc epilogue) stay in registers for the whole block.  The JAX scan
// path materialises three (T, n) random streams; here each chain derives
// its per-minute keys fold_in(fold_in(k_scan, g), 0 | 1) and
// fold_in(k_meter, g) in registers and hashes counter slot s % 60 as the
// second comes; the cycle uniform is drawn only on a renewal redraw, the
// only second that consumes it.  Each
// 60-second tile of the block's per-second rows is staged in shared
// memory by the first 60 threads: in the shared mode with that second's
// csi-independent physics terms (Spencer, DISC airmass and knc, the SAPM
// spectral and angle-of-incidence polynomials, the Hay-Davies beam ratio),
// once for all chains; in the site mode with the doy terms (Spencer at
// both constants, the Linke lerp) and the site-independent half of the PSA
// sun position (sun_time: the ephemeris of the split time, right
// ascension, declination and sidereal angle: 15 transcendentals a second,
// as the JAX function, which maps over the site scalars only, computes
// them), while every thread evaluates its own site's half (hour angle,
// zenith, azimuth), refraction, Kasten-Young, Ineichen and AOI, and the
// physics terms from them.
//
// The lean step (the shared-site acc, with or without the telemetry
// observer, series and trace steps).  The loop is bound by
// the instructions it issues, not by their latency: stripping a piece
// saved time in proportion to its instructions, and unrolling it, or
// splitting a chain over two threads, did not pay (k3_split.py, PERF.md).
// So these steps issue fewer:
//   - the table indices are the CTA's, so the chain's value pairs (cloud
//     cover and cloudy at the hour, clear day at hour + day, the minute
//     noises) stay in registers, loaded when an index changes (a uniform
//     branch), instead of six to eight loads every second;
//   - where the second's clear-sky GHI is zero (the CTA's row: a uniform
//     branch) power() is a constant for every csi (night_ac), so power()
//     is not computed; without the telemetry observer csi feeds nothing
//     else there, so neither the z word, erf_inv nor the csi lerps are
//     computed either (the observer folds csi every second, so with it
//     they are); the renewal steps as in every second.
// Every value keeps its expression, so the outputs keep their bits.
//
// K6s (strided).  The tile stages the calendar and the DISC Spencer term
// of each second (its exact doy) and the doy terms and the sun's time half
// of the stride samples the tile touches (2 at stride 60, 3 at stride 30).  Each
// thread evaluates its site's geometry at those samples, in registers,
// and carries the upper one into the next tile: one new evaluation per
// tile at stride 60, two at stride 30, against 60 in the site mode.  Per
// second it lerps the eight STRIDE_LERP_FIELDS as fmaf(lo, 1 - f, hi * f)
// (the contraction the JAX scan makes, tests/test_torch_stride.py) and
// derives the physics terms from them; azimuth is not lerped (only the
// samples' cos(AOI) reads it).  A (samples, chains) buffer filled by a
// pre-pass would be equally right; the registers spare it a launch and
// 8 x 4 bytes x (T/s + 1) x n of traffic per block.
//
// K11 (Table).  The same code with the KernelSet's functions swapped:
// minimax polynomials and the Spencer table (tables.cuh).  The renewal's
// powf is no member of the set and stays libm, as in the JAX package.
//
// K12 (BF16; tmhpvsim_tpu/engine/simulation.py:1129-1132, :713-733, :765,
// :830-842, :911-912, :1218).  The acc and series epilogues draw the
// per-second u / z in bf16 from the same threefry words (jax's 8-bit
// random_bits are the words' low 8 bits; their upper 7 are k: u = k / 128
// exactly, z = Z_BF16[k], the 128 bf16 normals tabulated by the plain
// version); the trace epilogue, the JAX _block_step, draws in float32.  The
// geometry reaches the physics in bf16: the shared rows arrive rounded by
// the host, the per-chain geometry is evaluated in float32 and narrowed,
// the strided samples are narrowed and lerped in bf16.  csi is narrowed
// before the physics, which runs with the JAX graph's types (bf16.cuh:
// phys_terms_bf, power_bf); its float32 steps are power()'s own.  The
// renewal and csi carry, the meter and every accumulator stay float32.
// The scenario epilogue runs under BF16 too (K12 in K10: the JAX
// ScenarioEngine runs _scan_block_setup's step in the compute dtype,
// :1887), with the acc epilogue's bf16 draws.
//
// K13 (RBG; prng_impl='rbg', tmhpvsim_tpu/engine/simulation.py:333).  The
// keys are 4 words and every u / z / meter word comes from Philox
// (philox.cuh).  jax draws a vmapped batch from its FIRST key, so all the
// chains of the block read one key's stream (chain 0's k_scan and
// k_meter), each at its own offset, which the JAX formulation fixes
// (Args::layout; models/clearsky_index.py DRAW_LAYOUTS):
//   0 scan   scan_draws_tmajor (:1130; groups outside, chains inside):
//            key fold_in(fold_in(k0, g0), 0 | 1), word (g n + c) 60 + s;
//   1 scan2  the nested scan's per-minute draws (:1622-1636): key
//            fold_in(fold_in(k0, g0 + g), 0 | 1), word c 60 + s;
//   2 trace  _block_step's minute-grouped draws (:844-956; chains outside,
//            groups inside, T / 60 + 1 groups): key as scan, word
//            (c (T / 60 + 1) + g) 60 + s;
// with g0 the block's first minute, g the tile, c the chain, s the second
// of the tile; the meter's key is fold_in(k0_meter, the same minute),
// without the 0 | 1.  Each thread derives the tile's three keys itself
// (two threefry hashes per half and key) and draws z and the meter four
// words per Philox call; u only on a redraw.
//
// K14 (URBG; prng_impl='unsafe_rbg').  K13's draws at K13's offsets, but
// the tile's keys come from unsafe_rbg's fold_in (philox.cuh UKey: the key
// XOR a Philox row of the datum's seed, jax/_src/prng.py
// _unsafe_rbg_fold_in).  The fold over the block's minutes is a batched
// datum in the scan and trace layouts (the first minute's seed, its row
// 10 p + 9 for minute p); the batch's first key is chain 0's at minute 0
// of the block, so the key is fold_in(k0, g0) in those layouts and
// fold_in(k0, g0 + g) in scan2, then fold_in(., 0 | 1), as in K13.  One
// thread of each CTA derives the tile's three keys (three Philox calls)
// into shared memory for all its chains.
//
// Epilogues.  acc folds in second order, chain by chain, as the scan adds.
// series reduces each second's meter and pv over the CTA's chains in a
// fixed order (a warp xor-butterfly, then the 4 warps in index order) into
// (n_ctas, T) partials; series_sum adds the partials over CTAs in double in
// a fixed strand order, spread over the whole card.  No atomics: a
// repeated run gives the same bits.  trace writes time-major (T, n) meter
// and pv, coalesced (consecutive threads are consecutive chains); the
// engine hands the host an (n, T) view.  scen writes the same (T, n) meter
// and pv with the acc epilogue's draws (the flat scan's layout; bf16 under
// BF16), for the scenario fold.
//
// K7.  Each chain loads its fleet leaves once per block; a column that is
// homogeneous passes a null pointer and its transform is skipped, so a
// fleet without heterogeneous columns runs the no-fleet arithmetic.  The
// demand transform is one fmaf: the JAX scan contracts meter * scale +
// shift into a multiply-add (tests/test_torch_fleet.py settles it).
//
// K8 alone (acc with TEL, analytics off).  Per-chain leaves live in
// registers for the block: telemetry's NaN / non-finite counts and min /
// max / sum / sum of squares of meter, csi, pv and residual (plus the
// covered count).  The 8 csi bins count with shared atomicAdd and are
// added to the zeroed global histogram with one atomicAdd per non-zero
// slot at block end: integer atomics commute, so every count is exact and
// order-free.  At block end each CTA reduces its chains' leaves (warp
// butterflies in double, then the 4 warps in order) into a per-CTA
// partial row; collapse_partials then combines the rows over CTAs in
// index order (reduce_chainwise): sums in double, rounded once by the
// caller, so reruns give the same bits.
//
// K9 and K8 + K9 (analytics on): two launches.  The acc producer (EPI ==
// PROD) is K3's step and statistics, bit for bit, that also writes the
// block's time-major meter and pv (after K7's transforms), csi (with
// telemetry) and the covered flags (uint8, with telemetry or analytics at
// level full), coalesced as the trace does: 13 bytes per chain-second at
// most.  obs_fold (wide_fold.cu) then folds both observers over them with
// its own occupancy.  Fused, their ~47 registers of per-chain state took
// the step past 128 registers a thread, so 3 or 2 CTAs an SM and two
// waves of the 512 CTAs at 65536 chains; the producer is built for 4
// CTAs an SM (__launch_bounds__(THREADS, 4)), one wave.
//
// K10 (scenario).  Two launches (kernels/block_step.py
// block_step_scenario).  The producer is the step, K3's unchanged (so a
// neutral row folds K3's statistics bit for bit), writing the block's
// time-major meter and pv; scenario_fold_kernel then folds every scenario
// row over them (its own comment says how).  The one-kernel form that
// staged each 60-second tile in shared memory and looped over the rows
// per tile spent ~95 % of its time in that row loop (k10_split.py).
//
// Bound: operations for acc and series (per site-second about three
// 20-round threefry hashes, XLA's erfinv and log1p polynomials, accurate
// expf and logf, plus powf x2 on a redraw; a lean step's second without
// clear-sky GHI about one hash; the site mode adds about 15
// accurate transcendentals and a powf per site-second and 15 per second
// for the CTA, the strided mode about as many per stride sample and 4 per
// site-second); trace adds 8 bytes per
// chain-second written, 566 MB per 65536 x 1080 block, still under the
// operation time.
//
// The including translation unit defines KSET (Exact, or Table after
// TMHPVSIM_TABLE_SET) and may define CDTYPE (F32 by default, or BF16).
#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

#include "bf16.cuh"
#include "consts.cuh"
#include "fold.cuh"
#include "nanminmax.cuh"
#include "philox.cuh"
#include "threefry.cuh"
#ifdef TMHPVSIM_TABLE_SET
#include "tables.cuh"
#endif

#define TILE 60
#ifndef CDTYPE
#define CDTYPE F32
#endif
#ifndef PRNG
#define PRNG TF
#endif

enum Epilogue { ACC = 0, SERIES = 1, TRACE = 2, SCEN = 3, PROD = 4 };


// compute dtypes (Plan.compute_dtype)
struct F32 {};
struct BF16 {};
// the key implementation: threefry2x32 (K1), rbg (K13) or unsafe_rbg (K14)
struct TF {};
struct RBG {};
struct URBG {};

// scenario fold: the per-(scenario, chain) risk leaves (int, float) and
// the per-(chain group, scenario) partial row
#define SCN_CHAIN_I 7
#define SCN_CHAIN_F 8
#define SCN_LEAVES 8
// the scenario fold's seconds per load chunk (blocks are whole minutes)
#define SCN_CHUNK 4
// a value at most this large in magnitude, times a knob at most this
// large, stays finite
#define SCN_TAME 1e18f

// one second's calendar: global second, rebased indices and fractions
struct Cal {
  int t, h, d, m;
  float one_m_hf, hf, one_m_df, df, one_m_mf, mf;
};

// the csi-independent terms power() reads
struct Phys {
  float csi_cap, ghi_clear, cos_zenith, dni_extra, cos_aoi;
  float i0, i0h, am, knc, rb, f1, f2;
  int zen_ok;
};

// the site mode's shared per-second terms (the strided mode's per stride
// sample): the doy terms and the site-independent half of the PSA sun
// position (right ascension, the declination's cos / sin / tan and the
// sidereal angle gmst_h * 15 * PV_DEG)
struct TimeC {
  float i0, dni_extra, tl, ra, cos_dec, sin_dec, tan_dec, gmst_ang;
};

// (16-byte aligned members: a thread reads a tile second's fields four at
// a time)
struct SharedSecond {
  alignas(16) Cal c;
  alignas(16) Phys p;
};

struct SiteSecond {
  Cal c;
  TimeC ts;
};

// the strided mode's per-second terms: the calendar and the DISC
// extraterrestrial irradiance at the second's exact doy
struct StrideSecond {
  Cal c;
  float i0;
};

// one site's per-chain constants
struct SiteC {
  float lon, cos_lat, sin_lat, pressure, refr, fh1, fh2, cg1, cg2;
  float cos_tilt, sin_tilt, saz, albedo;
};

struct Geo {
  float zenith, cos_zenith, app_zen, azimuth, csi_cap, ghi_clear, dni_extra,
      airmass_abs, cos_aoi, cos_app;
};

enum RowF { HF = 0, DF, MF, ZENITH, COS_ZENITH, APP_ZENITH, AZIMUTH, CSI_CAP,
            GHI_CLEAR, DNI_EXTRA, AIRMASS_ABS, COS_AOI, DOY };
enum RowFSite { DAY2000 = 3, SEC_OF_DAY, SDOY };
// strided mode: the second's doy, then the sample grid's split time and
// doy (T // stride + 1 entries, the rows padded to T)
enum RowFStride { TDOY = 3, SAMP_DAY2000, SAMP_SEC, SAMP_DOY };

// geometry modes: the host's shared rows, every chain's geometry every
// second, every chain's geometry on the stride grid lerped to 1 Hz
enum Geom { SHARED = 0, SITE = 1, STRIDED = 2 };

// the instantiations that run the lean step (Design): the shared-site
// acc (with or without the telemetry observer), series and trace epilogues
__host__ __device__ constexpr bool lean_step(int epi, int geo) {
  return geo == SHARED && (epi == ACC || epi == SERIES || epi == TRACE);
}
// the most stride samples a 60-second tile touches (stride 30)
#define MAX_SAMP 3

// the scenario fold's arguments
struct Scen {
  int B, bins, n_thr, lolp_k, hist_shared, T, duration_s;
  int ramp_w[3];
  float lo, inv_w, capacity;
  int64_t n;
  const int* t;            // (T,) the block's global seconds
  const float* meter;      // (T, n) the producer's meter
  const float* pv;         // (T, n) and pv
  const int* tame;         // (n,) the producer's flags, or nullptr
  const float* thr;        // (n_thr,), ascending
  float thr_v[8];          // the first MAX_THR of them, then +inf
  // (B,) knobs: demand_scale, demand_shift_w, pv_scale, weather_bias,
  // curtail_w; horizon_s, site_index, cohort
  const float* knob_f[5];
  const int* knob_i[3];
  const int* cohort;       // (n,) chains' cohort ids; nullptr: no selector
  // (B, n) statistics: pv_sum, pv_max, meter_sum, residual_sum,
  // residual_min, residual_max; n_seconds
  float* stat_f[6];
  int* n_seconds;
  int* res_hist;           // (B, bins + 2), zeroed by the caller
  int* exceed;             // (B, n_thr + 1), zeroed
  int* chain_i;            // (SCN_CHAIN_I, B, n) risk leaves, or nullptr
  float* chain_f;          // (SCN_CHAIN_F, B, n), or nullptr
  double* part;            // (n_groups, B, SCN_LEAVES)
};

struct Args {
  int64_t n;
  int T, duration_s, stride;
  int layout;  // RBG, URBG: the draw layout (0 scan, 1 scan2, 2 trace)
  float meter_max_w, cos_tilt, albedo;
  const int* rows_i;
  const float* rows_f;
  const float *t_cc, *t_cloudy, *t_cd, *t_ws, *t_ml, *t_mc;
  const int64_t *k_scan, *k_meter;
  const float *lat, *lon, *alt, *tilt, *azi, *alb, *turb;
  // K7 fleet leaves (nullptr: the column is homogeneous)
  const float *pv_scale, *ac_limit, *dem_scale, *dem_shift;
  float *cloud_end, *total_end, *sec;
  // acc (n,)
  float *pv_sum, *pv_max, *meter_sum, *residual_sum, *residual_min,
      *residual_max;
  int* n_seconds;
  // series partials (n_ctas, T) / trace and scenario outputs (T, n)
  float *out_meter, *out_pv;
  // scenario: per chain, whether every meter and pv value of the block
  // is at most SCN_TAME in magnitude (so a masked second adds +-0)
  int* out_tame;
  // acc producer: (T, n) csi and covered flags, or nullptr
  float* out_csi;
  unsigned char* out_cov;
  Obs o;
};

__device__ __forceinline__ void load_cal(Cal& C, const int* rows_i,
                                         const float* r, int T, int s) {
  C.t = rows_i[s];
  C.h = rows_i[T + s];
  C.d = rows_i[2 * T + s];
  C.m = rows_i[3 * T + s];
  C.hf = r[HF * T + s];
  C.df = r[DF * T + s];
  C.mf = r[MF * T + s];
  C.one_m_hf = 1.0f - C.hf;
  C.one_m_df = 1.0f - C.df;
  C.one_m_mf = 1.0f - C.mf;
}

// The kernel sets (models/tables.py KernelSet): Exact calls CUDA's
// accurate libm; Table (tables.cuh, K11) the minimax polynomials and the
// Spencer day-of-year table.  A translation unit instantiates the block
// step for one of them (block_step.cu: Exact; block_step_table.cu:
// Table), so a run's set is a template argument, never a runtime branch.
struct Exact {
  static __device__ __forceinline__ float sin(float x) { return sinf(x); }
  static __device__ __forceinline__ float cos(float x) { return cosf(x); }
  static __device__ __forceinline__ float tan(float x) { return tanf(x); }
  static __device__ __forceinline__ float asin(float x) { return asinf(x); }
  static __device__ __forceinline__ float acos(float x) { return acosf(x); }
  static __device__ __forceinline__ float atan2(float y, float x) {
    return atan2f(y, x);
  }
  static __device__ __forceinline__ float exp(float x) { return expf(x); }
  static __device__ __forceinline__ float log(float x) { return logf(x); }
  static __device__ __forceinline__ float powc(float x, float p) {
    return powf(x, p);
  }
  // Spencer's factor: extraterrestrial irradiance over the solar constant
  static __device__ __forceinline__ float spencer(float doy) {
    const float b = PV_TWO_PI * (doy - 1.0f) / 365.0f;
    return 1.00011f + 0.034221f * cosf(b) + 0.00128f * sinf(b) +
           0.000719f * cosf(2.0f * b) + 7.7e-5f * sinf(2.0f * b);
  }
  // exp(T_a + T_b * 0) of the SAPM cell temperature
  static __device__ __forceinline__ float exp_t() { return EXP_T; }
};

#ifdef TMHPVSIM_TABLE_SET
struct Table {
  static __device__ __forceinline__ float sin(float x) { return tbl::sin(x); }
  static __device__ __forceinline__ float cos(float x) { return tbl::cos(x); }
  static __device__ __forceinline__ float tan(float x) { return tbl::tan(x); }
  static __device__ __forceinline__ float asin(float x) {
    return tbl::asin(x);
  }
  static __device__ __forceinline__ float acos(float x) {
    return tbl::acos(x);
  }
  static __device__ __forceinline__ float atan2(float y, float x) {
    return tbl::atan2(y, x);
  }
  static __device__ __forceinline__ float exp(float x) { return tbl::exp(x); }
  static __device__ __forceinline__ float log(float x) { return tbl::log(x); }
  static __device__ __forceinline__ float powc(float x, float p) {
    return tbl::powc(x, p);
  }
  static __device__ __forceinline__ float spencer(float doy) {
    return tbl::spencer(doy);
  }
  static __device__ __forceinline__ float exp_t() { return EXP_T_TABLE; }
};
#endif

// the physics terms of one second from its geometry (pv.second_terms)
template <class KS>
__device__ __forceinline__ void phys_terms(Phys& P, float i0, float zen,
                                           float cos_zen, float cos_app,
                                           float ama, float cos_aoi) {
  P.i0 = i0;
  P.i0h = i0 * nmaxf(cos_zen, 0.065f);
  // Kasten 1966 airmass and the DISC knc polynomial
  const float z_deg = nclampf(zen / PV_DEG, 0.0f, 93.0f);
  const float am = 1.0f / (KS::cos(z_deg * PV_DEG) +
                           0.15f * KS::powc(93.885f - z_deg, -1.253f));
  const float am2 = am * am;
  P.am = am;
  P.knc = 0.866f - 0.122f * am + 0.0121f * am * am - 0.000653f * (am * am2) +
          1.4e-5f * (am2 * am2);
  P.zen_ok = zen < PV_ZEN_MAX;
  P.rb = nmaxf(cos_aoi, 0.0f) / nmaxf(cos_app, 0.01745f);
  // SAPM spectral (airmass) and angle-of-incidence polynomials
  const float ama2 = ama * ama;
  P.f1 = MA[0] + MA[1] * ama + MA[2] * ama2 + MA[3] * (ama * ama2) +
         MA[4] * (ama2 * ama2);
  const float aoi = KS::acos(nclampf(cos_aoi, -1.0f, 1.0f)) / PV_DEG;
  const float aoi2 = aoi * aoi, aoi4 = aoi2 * aoi2;
  const float f2 = MB[0] + MB[1] * aoi + MB[2] * aoi2 + MB[3] * (aoi * aoi2) +
                   MB[4] * aoi4 + MB[5] * (aoi * aoi4);
  P.f2 = nmaxf(f2, 0.0f);
}

// shared mode: one second's terms from the host geometry rows
template <class KS>
__device__ __forceinline__ void shared_second(SharedSecond& S,
                                              const int* rows_i,
                                              const float* r, int T, int s) {
  load_cal(S.c, rows_i, r, T, s);
  const float zen = r[ZENITH * T + s];
  const float cos_aoi = r[COS_AOI * T + s];
  S.p.csi_cap = r[CSI_CAP * T + s];
  S.p.ghi_clear = r[GHI_CLEAR * T + s];
  S.p.cos_zenith = r[COS_ZENITH * T + s];
  S.p.dni_extra = r[DNI_EXTRA * T + s];
  S.p.cos_aoi = cos_aoi;
  // Spencer extraterrestrial irradiance at the DISC constant
  const float i0 = 1370.0f * KS::spencer(r[DOY * T + s]);
  phys_terms<KS>(S.p, i0, zen, KS::cos(zen), KS::cos(r[APP_ZENITH * T + s]),
             r[AIRMASS_ABS * T + s], cos_aoi);
}

// the Linke turbidity lerp at a day of year (solar.linke_turbidity)
__device__ __forceinline__ float linke(float d, const float* monthly) {
  // ext_mids = [mids[11] - 365, mids..., mids[0] + 365]; searchsorted right
  int cnt = 0;
  float em[14];
  em[0] = LINKE_MIDS[11] - 365.0f;
  for (int k = 0; k < 12; ++k) em[k + 1] = LINKE_MIDS[k];
  em[13] = LINKE_MIDS[0] + 365.0f;
  for (int k = 0; k < 14; ++k) cnt += em[k] <= d ? 1 : 0;
  const int i = min(max(cnt - 1, 0), 12);
  const float v0 = monthly[(i + 11) % 12], v1 = monthly[(i + 12) % 12];
  const float f = (d - em[i]) / (em[i + 1] - em[i]);
  return v0 * (1.0f - f) + v1 * f;
}

// x % m as jnp.remainder computes it (m > 0): the exact fmod, into [0, m)
__device__ __forceinline__ float fmod_floor(float x, float m) {
  const float r = fmodf(x, m);
  return r < 0.0f ? r + m : r;
}

// solar.sun_time_terms: the half of the PSA sun position (solar.
// sun_position_split) that depends on the second only -- the ephemeris of
// the split time up to the right ascension, the declination and the
// sidereal time -- evaluated once per second (per stride sample) for every
// chain of the CTA, with the float32 operations of the one-piece form in
// its order
template <class KS>
__device__ __forceinline__ void sun_time(TimeC& S, float day, float sec) {
  const float frac = sec / 86400.0f - 0.5f;
  const float hour_ut = sec / 3600.0f;
#define LIN(c0, c1) (((c0) + (c1) * day) + (c1) * frac)
  const float omega = LIN(2.267127827f, -9.300339267e-4f);
  const float mean_lon = LIN(4.895036035f, 1.720279602e-2f);
  const float mean_anom = LIN(6.239468336f, 1.720200135e-2f);
  const float ecl_lon = mean_lon + 3.338320972e-2f * KS::sin(mean_anom) +
                        3.497596876e-4f * KS::sin(2.0f * mean_anom) -
                        1.544353226e-4f - 8.689729360e-6f * KS::sin(omega);
  const float obliquity =
      LIN(4.090904909e-1f, -6.213605399e-9f) + 4.418094944e-5f * KS::cos(omega);
#undef LIN
  const float sin_l = KS::sin(ecl_lon);
  S.ra = fmod_floor(KS::atan2(KS::cos(obliquity) * sin_l, KS::cos(ecl_lon)),
                    PV_TWO_PI);
  const float dec = KS::asin(KS::sin(obliquity) * sin_l);
  const float gmst_h = fmod_floor(6.697096103f + 6.570984737e-2f * day,
                                  24.0f) +
                       6.570984737e-2f * frac + hour_ut;
  S.gmst_ang = gmst_h * 15.0f * PV_DEG;
  S.cos_dec = KS::cos(dec);
  S.sin_dec = KS::sin(dec);
  S.tan_dec = KS::tan(dec);
}

// site mode: one second's shared time terms (strided mode: one sample's,
// from the sample rows): the doy terms and the sun's site-independent half
template <class KS>
__device__ __forceinline__ void time_terms(TimeC& S, const float* r, int T,
                                           int s, const float* turb,
                                           int row0 = DAY2000) {
  const float doy = r[(row0 + 2) * T + s];
  const float f = KS::spencer(doy);
  S.i0 = 1370.0f * f;
  S.dni_extra = GEO_SOLAR_CONSTANT * f;
  S.tl = linke(doy, turb);
  sun_time<KS>(S, r[row0 * T + s], r[(row0 + 1) * T + s]);
}

template <class KS>
__device__ __forceinline__ SiteC site_consts(float lat_deg, float lon_deg,
                                             float alt, float tilt_deg,
                                             float az_deg, float albedo) {
  SiteC c;
  const float lat = lat_deg * PV_DEG;
  c.lon = lon_deg * PV_DEG;
  c.cos_lat = KS::cos(lat);
  c.sin_lat = KS::sin(lat);
  c.pressure = GEO_STD_PRESSURE * powf(1.0f - 2.25577e-5f * alt, 5.25588f);
  c.refr = c.pressure / 100.0f / 1010.0f * GEO_REFR_T * 1.02f;
  c.fh1 = KS::exp(-alt / 8000.0f);
  c.fh2 = KS::exp(-alt / 1250.0f);
  c.cg1 = 5.09e-5f * alt + 0.868f;
  c.cg2 = 3.92e-5f * alt + 0.0387f;
  const float tilt = tilt_deg * PV_DEG;
  c.cos_tilt = KS::cos(tilt);
  c.sin_tilt = KS::sin(tilt);
  c.saz = az_deg * PV_DEG;
  c.albedo = albedo;
  return c;
}

// solar.device_geometry for one site and second, from the second's shared
// terms: the sun's site half (solar.sun_site_position) and the rest
template <class KS>
__device__ __forceinline__ Geo geometry(const TimeC& ts, const SiteC& c) {
  Geo g;
  // the hour angle from the sidereal angle and the site's longitude
  const float lmst = ts.gmst_ang + c.lon;
  const float ha = lmst - ts.ra;
  const float cos_ha = KS::cos(ha);
  const float cos_zen = nclampf(
      c.cos_lat * cos_ha * ts.cos_dec + ts.sin_dec * c.sin_lat, -1.0f, 1.0f);
  float zenith = KS::acos(cos_zen);
  g.azimuth = fmod_floor(
      KS::atan2(-KS::sin(ha), ts.tan_dec * c.cos_lat - c.sin_lat * cos_ha),
      PV_TWO_PI);
  zenith = zenith + GEO_PARALLAX * KS::sin(zenith);
  g.zenith = zenith;
  g.cos_zenith = KS::cos(zenith);
  // refraction (apparent_elevation)
  const float e_deg = (GEO_HALF_PI - zenith) / PV_DEG;
  const float de = e_deg >= GEO_REFR_MIN
                       ? c.refr / (60.0f * KS::tan((e_deg + 10.3f /
                                                 (e_deg + 5.11f)) * PV_DEG))
                       : 0.0f;
  const float app_zen = GEO_HALF_PI - (e_deg + de) * PV_DEG;
  g.app_zen = app_zen;
  // Kasten-Young relative airmass, absolute at the site's pressure
  const float zd = nclampf(app_zen / PV_DEG, 0.0f, 90.0f);
  const float am_rel = 1.0f / (KS::cos(zd * PV_DEG) +
                               0.50572f * KS::powc(96.07995f - zd, -1.6364f));
  g.airmass_abs = am_rel * c.pressure / GEO_STD_PRESSURE;
  g.dni_extra = ts.dni_extra;
  // Ineichen clear-sky GHI
  const float cos_app = KS::cos(app_zen);
  g.cos_app = cos_app;
  const float ghi = c.cg1 * ts.dni_extra * nmaxf(cos_app, 0.0f) *
                    KS::exp(-c.cg2 * g.airmass_abs *
                         (c.fh1 + c.fh2 * (ts.tl - 1.0f)));
  g.ghi_clear = nmaxf(ghi, 0.0f);
  // clear-sky-index cap and the angle of incidence
  const float cap = 27.21f * KS::exp(-114.0f * g.cos_zenith) +
                    1.665f * KS::exp(-4.494f * g.cos_zenith) + 1.08f;
  g.csi_cap = nminf(cap, 1e6f);
  g.cos_aoi = c.cos_tilt * cos_app +
              c.sin_tilt * KS::sin(app_zen) * KS::cos(g.azimuth - c.saz);
  return g;
}

// solar.disc_dni of one chain-second from its GHI and the second's terms;
// ghi_pos: GHI > 0
template <class KS>
__device__ __forceinline__ float disc(float ghi, bool ghi_pos,
                                      const Phys& S) {
  const float kt = nclampf(ghi / S.i0h, 0.0f, 2.0f);
  const float kt2 = kt * kt;
  const float kt3 = kt2 * kt;
  const bool hi = kt > 0.6f;
  const float a = hi ? -5.743f + 21.77f * kt - 27.49f * kt2 + 11.56f * kt3
                     : 0.512f - 1.56f * kt + 2.286f * kt2 - 2.222f * kt3;
  const float b = hi ? 41.4f - 118.5f * kt + 66.05f * kt2 + 31.9f * kt3
                     : 0.37f + 0.962f * kt;
  const float c = hi ? -47.01f + 184.2f * kt - 222.0f * kt2 + 73.81f * kt3
                     : -0.28f + 0.932f * kt - 2.048f * kt2;
  const float delta_kn = a + b * KS::exp(nminf(c * S.am, 40.0f));
  const float dni = (S.knc - delta_kn) * S.i0;
  return (S.zen_ok && ghi_pos) ? nmaxf(dni, 0.0f) : 0.0f;
}

// the SAPM and Sandia steps from the plane-of-array irradiance
template <class KS>
__device__ __forceinline__ float sapm_sandia(float pdir, float pdiff,
                                             const Phys& S) {
  const float pglob = pdir + pdiff;
  // SAPM temperature, effective irradiance, DC
  const float t_cell = pglob * KS::exp_t() + 20.0f + pglob / 1000.0f * T_DELTA;
  float ee = S.f1 * (pdir * S.f2 + FD * pdiff) / 1000.0f;
  ee = nmaxf(ee, 0.0f);
  const float dt = t_cell - 25.0f;
  const float delta = N_BOLTZ * (t_cell + 273.15f) / ELEM_CHARGE;
  const bool pos = ee > 0.0f;
  const float log_ee = KS::log(pos ? ee : 1.0f);
  float i_mp = IMPO * (SC0 * ee + SC1 * (ee * ee)) * (1.0f + AIMP * dt);
  const float bvmp = BVMPO + MBVMP * (1.0f - ee);
  const float dl = delta * log_ee;
  float v_mp = VMPO + C2NS * delta * log_ee + C3NS * (dl * dl) + bvmp * dt;
  i_mp = pos ? nmaxf(i_mp, 0.0f) : 0.0f;
  v_mp = pos ? nmaxf(v_mp, 0.0f) : 0.0f;
  const float p_mp = i_mp * v_mp;
  // Sandia inverter
  const float dv = v_mp - VDCO;
  const float ia = PDCO * (1.0f + IC1 * dv);
  const float ib = PSO * (1.0f + IC2 * dv);
  const float ic = IC0 * (1.0f + IC3 * dv);
  const float a_b = fabsf(ia - ib) > 1e-12f ? ia - ib : 1e-12f;
  const float pd = p_mp - ib;
  float ac = (PACO / a_b - ic * a_b) * pd + ic * pd * pd;
  ac = nminf(ac, PACO);
  ac = p_mp < PSO ? PNT_NEG : ac;
  return nmaxf(ac, 0.0f);
}

// pv.power_from_terms for one chain-second
template <class KS>
__device__ __forceinline__ float power(float csi, const Phys& S,
                                       float cos_tilt, float albedo) {
  csi = nminf(csi, S.csi_cap);
  const float ghi = csi * S.ghi_clear;
  const float dni = disc<KS>(ghi, ghi > 0.0f, S);
  const float dhi = nmaxf(ghi - dni * S.cos_zenith, 0.0f);
  // Hay-Davies POA + isotropic ground
  const float ai = dni / S.dni_extra;
  const float sky = dhi * (ai * S.rb + (1.0f - ai) * 0.5f * (1.0f + cos_tilt));
  const float ground = ghi * albedo * 0.5f * (1.0f - cos_tilt);
  const float pdir = nmaxf(dni * S.cos_aoi, 0.0f);
  const float pdiff = nmaxf(sky, 0.0f) + ground;
  return sapm_sandia<KS>(pdir, pdiff, S);
}

// power()'s value, and power_bf's, where the second's clear-sky GHI is
// zero: ghi is then +-0 or NaN for every csi, so the plane-of-array
// irradiances are +-0 or NaN, ee is never > 0, i_mp = v_mp = p_mp = +0 and,
// with the inverter's self-consumption PSO above 0, ac is the night tare
// clipped at 0
constexpr bool NIGHT_SKIP = PSO > 0.0f;
__device__ __forceinline__ float night_ac() { return nmaxf(PNT_NEG, 0.0f); }

// K12: pv.second_terms_bf16 -- the csi-independent terms from bf16
// geometry, in the JAX graph's types (bf16.cuh); csi_cap and ghi_clear keep
// their bf16 values, the rest their float32 widening
template <class KS>
__device__ __forceinline__ void phys_terms_bf(Phys& P, float i0, b16::bf zen,
                                              b16::bf app, b16::bf ama,
                                              b16::bf cos_aoi) {
  using namespace b16;
  using X = Fns<KS, std::is_same<KS, Exact>::value>;
  P.i0 = i0;
  P.i0h = i0 * w32(vmax(X::cos(zen), K(0.065)));
  // DISC's Kasten 1966 airmass and knc
  const bf z_deg = clip(zen / K(PV_DEG), K(0.0), K(93.0));
  const auto am = K(1.0) / (X::cos(z_deg * K(PV_DEG)) +
                             K(0.15) * X::powc(K(93.885) - z_deg,
                                                K(-1.253)));
  const auto knc = K(0.866) - K(0.122) * am + K(0.0121) * am * am -
                   K(0.000653) * ipow3(am) + K(1.4e-5) * ipow4(am);
  P.am = w32(am);
  P.knc = w32(knc);
  P.zen_ok = lt(zen, K(PV_ZEN_MAX));
  // Hay-Davies beam ratio
  P.rb = w32(vmax(cos_aoi, K(0.0)) / vmax(X::cos(app), K(0.01745)));
  // SAPM spectral (airmass) and angle-of-incidence polynomials
  P.f1 = w32(K(MA[0]) + K(MA[1]) * ama + K(MA[2]) * ipow2(ama) +
             K(MA[3]) * ipow3(ama) + K(MA[4]) * ipow4(ama));
  const auto aoi = X::acos(clip(cos_aoi, K(-1.0), K(1.0))) / K(PV_DEG);
  P.f2 = w32(vmax(K(MB[0]) + K(MB[1]) * aoi + K(MB[2]) * ipow2(aoi) +
                      K(MB[3]) * ipow3(aoi) + K(MB[4]) * ipow4(aoi) +
                      K(MB[5]) * ipow5(aoi),
                  K(0.0)));
}

// K12: the geometry fields that phys_terms_bf does not take, as power_bf
// reads them: csi_cap and ghi_clear rounded, the others widened
__device__ __forceinline__ void phys_fields_bf(Phys& P, b16::bf csi_cap,
                                               b16::bf ghi_clear,
                                               b16::bf cos_zenith,
                                               b16::bf dni_extra,
                                               b16::bf cos_aoi) {
  P.csi_cap = csi_cap.v;
  P.ghi_clear = ghi_clear.v;
  P.cos_zenith = cos_zenith.r;
  P.dni_extra = dni_extra.r;
  P.cos_aoi = cos_aoi.r;
}

// K12: pv.power_from_terms_bf16 for one chain-second: csi narrowed, the
// clear-sky GHI and the ground reflection in bf16, the rest power()'s
// float32 steps.  CT / AL: the types of cos(tilt) and the albedo (python
// floats of a shared site: weak; per chain: bf16; the Table set's cos:
// float32)
template <class KS, class CT, class AL>
__device__ __forceinline__ float power_bf(float csi, const Phys& S,
                                          CT cos_tilt, AL albedo) {
  using namespace b16;
  const bf c = vmin(narrow(csi), in(S.csi_cap));
  const bf ghi = c * in(S.ghi_clear);
  const float dni = disc<KS>(ghi.r, ghi.v > 0.0f, S);
  const float dhi = nmaxf(ghi.r - dni * S.cos_zenith, 0.0f);
  const float ai = dni / S.dni_extra;
  const float sky =
      dhi * (ai * S.rb + (1.0f - ai) * 0.5f * w32(K(1.0) + cos_tilt));
  const auto ground = ghi * albedo * K(0.5) * (K(1.0) - cos_tilt);
  const float pdir = nmaxf(dni * S.cos_aoi, 0.0f);
  const float pdiff = nmaxf(sky, 0.0f) + w32(ground);
  return sapm_sandia<KS>(pdir, pdiff, S);
}

// K12, shared mode: one second's terms from the host's rows (rounded to
// bf16 by the host; doy float32)
template <class KS>
__device__ __forceinline__ void shared_second_bf(SharedSecond& S,
                                                 const int* rows_i,
                                                 const float* r, int T,
                                                 int s) {
  using b16::in;
  load_cal(S.c, rows_i, r, T, s);
  const b16::bf cos_aoi = in(r[COS_AOI * T + s]);
  phys_fields_bf(S.p, in(r[CSI_CAP * T + s]), in(r[GHI_CLEAR * T + s]),
                 in(r[COS_ZENITH * T + s]), in(r[DNI_EXTRA * T + s]),
                 cos_aoi);
  phys_terms_bf<KS>(S.p, 1370.0f * KS::spencer(r[DOY * T + s]),
                    in(r[ZENITH * T + s]), in(r[APP_ZENITH * T + s]),
                    in(r[AIRMASS_ABS * T + s]), cos_aoi);
}

// K12: a stride sample's lerped fields narrowed to bf16
__device__ __forceinline__ void narrow_geo(Geo& g) {
  using b16::rn;
  g.zenith = rn(g.zenith);
  g.cos_zenith = rn(g.cos_zenith);
  g.app_zen = rn(g.app_zen);
  g.csi_cap = rn(g.csi_cap);
  g.ghi_clear = rn(g.ghi_clear);
  g.dni_extra = rn(g.dni_extra);
  g.airmass_abs = rn(g.airmass_abs);
  g.cos_aoi = rn(g.cos_aoi);
}

// one (scenario, chain) row of the scenario fold: the seven statistics
// and the risk leaves (obs/analytics.py fold_second at level risk)
struct ScnRow {
  float pv_sum, pv_max, meter_sum, residual_sum, residual_min, residual_max;
  int n_seconds;
  int n_use = 0, lol_run = 0, lol_s = 0, lol_e = 0;
  int seen[3] = {0, 0, 0};
  float mn = FLT_MAX, mx = -FLT_MAX;
  float ramp[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  float prev[3] = {0.0f, 0.0f, 0.0f};
};

// the step (block_step_kernel, block_step_prod_kernel below)
template <class KS, class CD, class RG, int EPI, int GEO, bool TEL>
__device__ __forceinline__ void block_step_body(const Args& a) {
  // K13 and K14 draw alike; K14 derives the tile's keys its own way
  constexpr bool UR = std::is_same<RG, URBG>::value;
  constexpr bool RB = std::is_same<RG, RBG>::value || UR;
  constexpr bool PER_CHAIN = GEO != SHARED;  // geometry per chain
  // K12: bf16 physics; bf16 u / z draws but in the trace epilogue
  constexpr bool BF = std::is_same<CD, BF16>::value;
  constexpr bool BF_DRAWS = BF && EPI != TRACE;
  using X = b16::Fns<KS, std::is_same<KS, Exact>::value>;
  using Second = typename std::conditional<
      GEO == SITE, SiteSecond,
      typename std::conditional<GEO == STRIDED, StrideSecond,
                                SharedSecond>::type>::type;
  __shared__ Second tile[TILE];
  // strided: the doy terms and the sun's time half of the tile's stride
  // samples
  __shared__ TimeC samp[GEO == STRIDED ? MAX_SAMP : 1];
  __shared__ float red_m[EPI == SERIES ? WARPS : 1][TILE];
  __shared__ float red_p[EPI == SERIES ? WARPS : 1][TILE];
  // the acc statistics: acc, and the acc producer
  constexpr bool ACCUM = EPI == ACC || EPI == PROD;
  __shared__ double s_stage[TEL ? WARPS * TEL_LEAVES : 1];
  __shared__ int s_csi[TEL ? CSI_BINS : 1];
  // K12: the 128 bf16 normals
  __shared__ float s_z[BF_DRAWS ? 128 : 1];
  // K14: the tile's u, z and meter keys
  __shared__ ph::Key4 s_rk[UR ? 3 : 1];
  // the shared-site acc, series and trace steps: table pairs in
  // registers, no physics on a second without clear-sky GHI (Design)
  constexpr bool LEAN = lean_step(EPI, GEO);
  const int64_t n = a.n;
  const int T = a.T;
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const bool live = i < n;
  const int64_t ii = live ? i : 0;

  float cloud_end = a.cloud_end[ii], total_end = a.total_end[ii],
        sec = a.sec[ii];
  float pv_sum = 0.0f, pv_max = 0.0f, meter_sum = 0.0f, residual_sum = 0.0f,
        residual_min = 0.0f, residual_max = 0.0f;
  int n_seconds = 0;
  if (ACCUM) {
    pv_sum = a.pv_sum[ii];
    pv_max = a.pv_max[ii];
    meter_sum = a.meter_sum[ii];
    residual_sum = a.residual_sum[ii];
    residual_min = a.residual_min[ii];
    residual_max = a.residual_max[ii];
    n_seconds = a.n_seconds[ii];
  }
  float cos_tilt = a.cos_tilt, albedo = a.albedo;
  SiteC site;
  if (PER_CHAIN) {
    site = site_consts<KS>(a.lat[ii], a.lon[ii], a.alt[ii], a.tilt[ii],
                           a.azi[ii], a.alb[ii]);
    cos_tilt = site.cos_tilt;
    albedo = site.albedo;
  }
  // K12: cos(tilt) and the albedo in the JAX graph's types -- a shared
  // site's python floats (weak), per chain the narrowed site scalars
  using CT = decltype(X::cos(
      typename std::conditional<PER_CHAIN, b16::bf, b16::wk>::type{}));
  using AL = typename std::conditional<PER_CHAIN, b16::bf, b16::wk>::type;
  CT ct_b{};
  AL al_b{};
  if constexpr (BF) {
    if constexpr (PER_CHAIN) {
      ct_b = X::cos(b16::stored(a.tilt[ii]) * b16::K(PV_DEG));
      al_b = b16::stored(a.alb[ii]);
    } else {
      ct_b = CT{a.cos_tilt};
      al_b = b16::wk{a.albedo};
    }
  }
  if constexpr (BF_DRAWS) {
    for (int k = threadIdx.x; k < 128; k += blockDim.x) s_z[k] = Z_BF16[k];
  }
  // K7: the chain's fleet leaves, once per block
  const bool het_power = a.pv_scale != nullptr;
  const bool het_demand = a.dem_scale != nullptr;
  const float pv_scale = het_power ? a.pv_scale[ii] : 1.0f;
  const float ac_limit = het_power ? a.ac_limit[ii] : 0.0f;
  const float dem_scale = het_demand ? a.dem_scale[ii] : 1.0f;
  const float dem_shift = het_demand ? a.dem_shift[ii] : 0.0f;
  tf::Key ks{}, km0{};
  ph::Key4 rs0{}, rm0{};
  if constexpr (RB) {  // K13: the batch's first keys
    rs0 = ph::load_key(a.k_scan, 0);
    rm0 = ph::load_key(a.k_meter, 0);
  } else {
    ks = tf::load_key(a.k_scan, ii);
    km0 = tf::load_key(a.k_meter, ii);
  }
  const uint32_t g_first = (uint32_t)(a.rows_i[0] / 60);

  bool tame = true;  // the scenario producer's per-chain flag
  // K8 state
  TelField tel[4];
  int occ = 0;
  if constexpr (TEL) {
    for (int k = threadIdx.x; k < CSI_BINS; k += blockDim.x) s_csi[k] = 0;
  }

  // K6s: the geometry of the stride samples a tile touches; the upper
  // sample of one tile is the lower of the next
  const int stride = GEO == STRIDED ? a.stride : TILE;
  const int per_tile = TILE / stride;  // new samples per tile: 1 or 2
  Geo g_s[MAX_SAMP];

  // lean: the chain's table pairs at the indices last loaded (cc and
  // cloudy at h, clear_day at h + d, ml and mc at m)
  int ld_h = -1, ld_hd = -1, ld_m = -1;
  float cc0 = 0.0f, cc1 = 0.0f, cl0 = 0.0f, cl1 = 0.0f, cd0 = 0.0f,
        cd1 = 0.0f, ml0 = 0.0f, ml1 = 0.0f, mc0 = 0.0f, mc1 = 0.0f;

  for (int base = 0; base < T; base += TILE) {
    __syncthreads();
    if (threadIdx.x < TILE) {
      if constexpr (GEO == SITE) {
        load_cal(tile[threadIdx.x].c, a.rows_i, a.rows_f, T,
                 base + threadIdx.x);
        time_terms<KS>(tile[threadIdx.x].ts, a.rows_f, T,
                       base + threadIdx.x, a.turb);
      } else if constexpr (GEO == STRIDED) {
        load_cal(tile[threadIdx.x].c, a.rows_i, a.rows_f, T,
                 base + threadIdx.x);
        tile[threadIdx.x].i0 =
            1370.0f * KS::spencer(a.rows_f[TDOY * T + base + threadIdx.x]);
      } else if constexpr (BF) {
        shared_second_bf<KS>(tile[threadIdx.x], a.rows_i, a.rows_f, T,
                             base + threadIdx.x);
      } else {
        shared_second<KS>(tile[threadIdx.x], a.rows_i, a.rows_f, T,
                          base + threadIdx.x);
      }
    }
    if constexpr (GEO == STRIDED) {
      const int k = (int)threadIdx.x - TILE;
      if (k >= 0 && k <= per_tile)
        time_terms<KS>(samp[k], a.rows_f, T, base / stride + k, a.turb,
                       SAMP_DAY2000);
    }
    if constexpr (UR) {  // K14: the tile's keys, once per CTA
      if (threadIdx.x == THREADS - 1) {
        const uint32_t gk =
            a.layout == 1 ? (uint32_t)(a.rows_i[base] / 60) : g_first;
        const ph::UKey kb = ph::fold_in(ph::load_ukey(a.k_scan, 0), gk);
        s_rk[0] = ph::as_rbg(ph::fold_in(kb, 0u));
        s_rk[1] = ph::as_rbg(ph::fold_in(kb, 1u));
        s_rk[2] = ph::as_rbg(ph::fold_in(ph::load_ukey(a.k_meter, 0), gk));
      }
    }
    __syncthreads();
    // series keeps every thread in the loop for the warp reductions
    if (EPI != SERIES && !live) continue;
    // blocks are minute-aligned: the tile is global minute t / 60
    const uint32_t g = (uint32_t)(tile[0].c.t / 60);
    tf::Key ku{}, kz{}, km{};
    ph::Key4 ru{}, rz{}, rm{};
    uint64_t wb = 0;  // K13: the word of the tile's second 0
    if constexpr (RB) {
      const uint64_t gl = (uint64_t)(base / TILE);
      if constexpr (UR) {
        ru = s_rk[0];
        rz = s_rk[1];
        rm = s_rk[2];
      } else {
        const uint32_t gk = a.layout == 1 ? g : g_first;
        const ph::Key4 kb = ph::fold_in(rs0, gk);
        ru = ph::fold_in(kb, 0u);
        rz = ph::fold_in(kb, 1u);
        rm = ph::fold_in(rm0, gk);
      }
      wb = a.layout == 0   ? (gl * (uint64_t)n + (uint64_t)ii) * TILE
           : a.layout == 1 ? (uint64_t)ii * TILE
                           : ((uint64_t)ii * (T / TILE + 1) + gl) * TILE;
    } else {
      const tf::Key kg = tf::fold_in(ks, g);
      ku = tf::fold_in(kg, 0u);
      kz = tf::fold_in(kg, 1u);
      km = tf::fold_in(km0, g);
    }
    uint4 zq = make_uint4(0u, 0u, 0u, 0u), mq = zq;
    if constexpr (GEO == STRIDED) {
      // the previous tile's upper sample (selects, not an indexed load,
      // keep g_s in registers)
      if (base == 0) g_s[0] = geometry<KS>(samp[0], site);
      else g_s[0] = per_tile == 2 ? g_s[2] : g_s[1];
      g_s[1] = geometry<KS>(samp[1], site);
      if (per_tile == 2) g_s[2] = geometry<KS>(samp[2], site);
      if constexpr (BF) {  // K12: the samples narrowed
        if (base == 0) narrow_geo(g_s[0]);
        narrow_geo(g_s[1]);
        if (per_tile == 2) narrow_geo(g_s[2]);
      }
    }
    for (int s = 0; s < TILE; ++s) {
      const Cal& S = tile[s].c;
      if constexpr (LEAN) {  // the pairs of an index that changed
        if (S.h != ld_h) {
          ld_h = S.h;
          cc0 = a.t_cc[ld_h * n + ii];
          cc1 = a.t_cc[(ld_h + 1) * n + ii];
          cl0 = a.t_cloudy[ld_h * n + ii];
          cl1 = a.t_cloudy[(ld_h + 1) * n + ii];
        }
        if (S.h + S.d != ld_hd) {
          ld_hd = S.h + S.d;
          cd0 = a.t_cd[ld_hd * n + ii];
          cd1 = a.t_cd[(ld_hd + 1) * n + ii];
        }
        if (S.m != ld_m) {
          ld_m = S.m;
          ml0 = a.t_ml[ld_m * n + ii];
          ml1 = a.t_ml[(ld_m + 1) * n + ii];
          mc0 = a.t_mc[ld_m * n + ii];
          mc1 = a.t_mc[(ld_m + 1) * n + ii];
        }
      }
      // the second's z and meter words (K13: four per Philox call; the
      // tile's first word is a multiple of 4)
      uint32_t zb = 0, mb;
      if constexpr (RB) {
        if ((s & 3) == 0) {
          zq = ph::block(rz, (wb + s) >> 2);
          mq = ph::block(rm, (wb + s) >> 2);
        }
        zb = ph::pick(zq, s & 3);
        mb = ph::pick(mq, s & 3);
      } else {
        if constexpr (!LEAN) zb = tf::bits(kz, (uint32_t)s);
        mb = tf::bits(km, (uint32_t)s);
      }
      Phys local;
      if constexpr (GEO == SITE && BF) {
        using b16::stored;
        const Geo geo = geometry<KS>(tile[s].ts, site);
        const b16::bf cos_aoi = stored(geo.cos_aoi);
        phys_fields_bf(local, stored(geo.csi_cap), stored(geo.ghi_clear),
                       stored(geo.cos_zenith), stored(geo.dni_extra),
                       cos_aoi);
        phys_terms_bf<KS>(local, tile[s].ts.i0, stored(geo.zenith),
                          stored(geo.app_zen), stored(geo.airmass_abs),
                          cos_aoi);
      } else if constexpr (GEO == STRIDED && BF) {
        // solar.interp_sampled in bf16: lo * (1 - f) + hi * f, the
        // fraction rounded to bf16
        using b16::in;
        const bool upper = s >= stride;
        const b16::bf fb =
            in(b16::rn((float)(s % stride) / (float)stride));
        const b16::bf omf = b16::K(1.0) - fb;
        const Geo& lo = upper ? g_s[1] : g_s[0];
        const Geo& hi = upper ? g_s[2] : g_s[1];
#define LERP(x) (in(lo.x) * omf + in(hi.x) * fb)
        const b16::bf cos_aoi = LERP(cos_aoi);
        phys_fields_bf(local, LERP(csi_cap), LERP(ghi_clear),
                       LERP(cos_zenith), LERP(dni_extra), cos_aoi);
        phys_terms_bf<KS>(local, tile[s].i0, LERP(zenith), LERP(app_zen),
                          LERP(airmass_abs), cos_aoi);
#undef LERP
      } else if constexpr (GEO == SITE) {
        const Geo geo = geometry<KS>(tile[s].ts, site);
        local.csi_cap = geo.csi_cap;
        local.ghi_clear = geo.ghi_clear;
        local.cos_zenith = geo.cos_zenith;
        local.dni_extra = geo.dni_extra;
        local.cos_aoi = geo.cos_aoi;
        phys_terms<KS>(local, tile[s].ts.i0, geo.zenith, geo.cos_zenith,
                       geo.cos_app, geo.airmass_abs, geo.cos_aoi);
      } else if constexpr (GEO == STRIDED) {
        // solar.interp_sampled: lo * (1 - f) + hi * f, the JAX scan's
        // contraction; doy (in i0) stays the second's own
        const bool upper = s >= stride;  // stride 30: the tile's 2nd half
        const float f = (float)(s % stride) / (float)stride;
        const float omf = 1.0f - f;
#define LERP(x)                                                 \
  fmaf(upper ? g_s[1].x : g_s[0].x, omf, (upper ? g_s[2].x : g_s[1].x) * f)
        const float zen = LERP(zenith), app = LERP(app_zen);
        local.csi_cap = LERP(csi_cap);
        local.ghi_clear = LERP(ghi_clear);
        local.cos_zenith = LERP(cos_zenith);
        local.dni_extra = LERP(dni_extra);
        local.cos_aoi = LERP(cos_aoi);
        phys_terms<KS>(local, tile[s].i0, zen, KS::cos(zen), KS::cos(app),
                       LERP(airmass_abs), local.cos_aoi);
#undef LERP
      }
      const Phys* P;
      if constexpr (PER_CHAIN) {
        P = &local;
      } else {
        P = &tile[s].p;
      }
      // lean: a second without clear-sky GHI computes no power() (lit,
      // the physics); its pv is power()'s constant there.  csi feeds
      // nothing else there but the telemetry, so without it such a second
      // draws no z and computes no csi (csi_on)
      const bool lit = !LEAN || !NIGHT_SKIP || !(P->ghi_clear == 0.0f);
      const bool csi_on = TEL || lit;
      // sampler lerps (value-major tables; the lean step's registers)
      const float cc_t = LEAN ? cc0 * S.one_m_hf + cc1 * S.hf
                              : a.t_cc[S.h * n + ii] * S.one_m_hf +
                                    a.t_cc[(S.h + 1) * n + ii] * S.hf;
      float noise_sec = 0.0f;
      if (csi_on) {
        if constexpr (LEAN && !RB) zb = tf::bits(kz, (uint32_t)s);
        float z;
        if constexpr (BF_DRAWS) {  // K12: jax's 8-bit bits, the low byte
          z = s_z[(zb & 0xFFu) >> 1];
        } else {
          z = tf::normal_from_bits(zb);
        }
        noise_sec = SIGMA_SEC * (SEC_S0 + SEC_S1X8 * cc_t) * z;
      }
      // renewal: a new cycle only on redraw
      sec = sec + 1.0f;
      if (sec >= total_end) {
        const float ws_t = a.t_ws[S.d * n + ii] * S.one_m_df +
                           a.t_ws[(S.d + 1) * n + ii] * S.df;
        uint32_t ub;
        if constexpr (RB) {
          ub = ph::word(ru, wb + s);
        } else {
          ub = tf::bits(ku, (uint32_t)s);
        }
        float u;
        if constexpr (BF_DRAWS) {
          u = (float)((ub & 0xFFu) >> 1) * (1.0f / 128.0f);
        } else {
          u = tf::unit(ub);  // uniform_range(ub, 0, 1): unit(ub) is >= +0
        }
        const float cc = nclampf(cc_t, RN_CC_MIN, RN_CC_MAX);
        const float cap_m = RN_MAX_CYCLE * cc * ws_t;
        const float xmax = nmaxf(cap_m, RN_XMAX_FLOOR);
        const float pa = powf(xmax, RN_ONE_M_BETA);
        const float pd = RN_XMIN_POW - pa;
        const float cloud = powf(pa + pd * u, RN_INV_ONE_M_BETA) / ws_t;
        cloud_end = cloud;
        total_end = cloud / cc;
        sec = 1.0f;
      }
      const bool covered = sec < cloud_end;
      float csi = 0.0f, ac = night_ac();
      if (csi_on) {
        float base_v, nmin;
        if constexpr (LEAN) {
          base_v = (covered ? cd0 : cl0) *
                       (covered ? S.one_m_df : S.one_m_hf) +
                   (covered ? cd1 : cl1) * (covered ? S.df : S.hf);
          nmin = (covered ? ml0 : mc0) * S.one_m_mf +
                 (covered ? ml1 : mc1) * S.mf;
        } else if (covered) {
          const int cd = S.h + S.d;
          base_v = a.t_cd[cd * n + ii] * S.one_m_df +
                   a.t_cd[(cd + 1) * n + ii] * S.df;
          nmin = a.t_ml[S.m * n + ii] * S.one_m_mf +
                 a.t_ml[(S.m + 1) * n + ii] * S.mf;
        } else {
          base_v = a.t_cloudy[S.h * n + ii] * S.one_m_hf +
                   a.t_cloudy[(S.h + 1) * n + ii] * S.hf;
          nmin = a.t_mc[S.m * n + ii] * S.one_m_mf +
                 a.t_mc[(S.m + 1) * n + ii] * S.mf;
        }
        csi = base_v * (nmin + noise_sec);
        if (lit) {
          if constexpr (BF) {
            ac = power_bf<KS>(csi, *P, ct_b, al_b);
          } else {
            ac = power<KS>(csi, *P, cos_tilt, albedo);
          }
        }
      }
      float meter = a.meter_max_w * tf::unit(mb);
      // K7: the heterogeneous columns' transforms
      if (het_power) ac = nminf(ac * pv_scale, ac_limit);
      if (het_demand) meter = fmaf(meter, dem_scale, dem_shift);
      if (ACCUM) {
        const float residual = meter - ac;
        const bool valid = S.t < a.duration_s;
        const float vz = valid ? 1.0f : 0.0f;
        pv_sum = pv_sum + ac * vz;
        pv_max = nmaxf(pv_max, valid ? ac : -FLT_MAX);
        meter_sum = meter_sum + meter * vz;
        residual_sum = residual_sum + residual * vz;
        residual_min = nminf(residual_min, valid ? residual : FLT_MAX);
        residual_max = nmaxf(residual_max, valid ? residual : -FLT_MAX);
        n_seconds += valid ? 1 : 0;
        if constexpr (TEL) {  // K8: obs/telemetry.py fold_second
          tel[0].fold(meter, valid);
          tel[1].fold(csi, valid);
          tel[2].fold(ac, valid);
          tel[3].fold(residual, valid);
          if (a.o.tel_full) {
            if (valid && isfinite(csi))
              atomicAdd(&s_csi[(int)nclampf(csi / 0.25f, 0.0f,
                                            (float)(CSI_BINS - 1))],
                        1);
            occ += (valid && covered) ? 1 : 0;
          }
        }
        if (EPI == PROD) {  // the observer fold's inputs
          const int64_t o = (int64_t)(base + s) * n + i;
          a.out_meter[o] = meter;
          a.out_pv[o] = ac;
          if (a.out_csi != nullptr) a.out_csi[o] = csi;
          if (a.out_cov != nullptr) a.out_cov[o] = covered ? 1 : 0;
        }
      } else if (EPI == TRACE || EPI == SCEN) {
        const int64_t o = (int64_t)(base + s) * n + i;
        a.out_meter[o] = meter;
        a.out_pv[o] = ac;
        if (EPI == SCEN)
          tame = tame && fabsf(meter) <= SCN_TAME && fabsf(ac) <= SCN_TAME;
      } else {
        float m = live ? meter : 0.0f, p = live ? ac : 0.0f;
        for (int off = 16; off > 0; off >>= 1) {
          m += __shfl_xor_sync(0xffffffffu, m, off);
          p += __shfl_xor_sync(0xffffffffu, p, off);
        }
        if ((threadIdx.x & 31) == 0) {
          red_m[threadIdx.x >> 5][s] = m;
          red_p[threadIdx.x >> 5][s] = p;
        }
      }
    }
    if (EPI == SERIES) {
      __syncthreads();
      if (threadIdx.x < TILE) {
        float m = red_m[0][threadIdx.x], p = red_p[0][threadIdx.x];
        for (int w = 1; w < WARPS; ++w) {
          m = m + red_m[w][threadIdx.x];
          p = p + red_p[w][threadIdx.x];
        }
        const int64_t o = (int64_t)blockIdx.x * T + base + threadIdx.x;
        a.out_meter[o] = m;
        a.out_pv[o] = p;
      }
    }
  }
  if (live) {
    a.cloud_end[i] = cloud_end;
    a.total_end[i] = total_end;
    a.sec[i] = sec;
    if (EPI == SCEN) a.out_tame[i] = tame ? 1 : 0;
    if (ACCUM) {
      a.pv_sum[i] = pv_sum;
      a.pv_max[i] = pv_max;
      a.meter_sum[i] = meter_sum;
      a.residual_sum[i] = residual_sum;
      a.residual_min[i] = residual_min;
      a.residual_max[i] = residual_max;
      a.n_seconds[i] = n_seconds;
    }
  }
  // reduce_chainwise, first pass: the CTA's partial rows (every thread
  // takes part; a dead thread holds the identities)
  if constexpr (TEL) {
    tel_epilogue(tel, occ, a.o, n, i, live, s_stage, blockIdx.x);
    flush_hist(s_csi, a.o.csi_hist, CSI_BINS);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      // the count leaf: valid seconds x n, added in float32 per second
      float count = 0.0f;
      for (int s = 0; s < T; ++s)
        if (a.rows_i[s] < a.duration_s) count = count + (float)n;
      a.o.tel_count[0] = count;
    }
  }
}

template <class KS, class CD, class RG, int EPI, int GEO, bool TEL>
__global__ void __launch_bounds__(THREADS) block_step_kernel(const Args a) {
  block_step_body<KS, CD, RG, EPI, GEO, TEL>(a);
}

// the acc producer: at most 128 registers a thread, so 4 CTAs an SM (one
// wave of the 512 CTAs at 65536 chains); the other epilogues keep the
// compiler's own register choice
template <class KS, class CD, class RG, int GEO>
__global__ void __launch_bounds__(THREADS, 4)
    block_step_prod_kernel(const Args a) {
  block_step_body<KS, CD, RG, PROD, GEO, false>(a);
}

// reduce_chainwise, second pass, for a block's row sets in one launch (the
// observers' telemetry, analytics and cohort rows, or the scenario fold's
// rows): leaf l of a set's per-CTA partial rows combined over the rows in
// index order (sum in double, min or max by its kind); the caller rounds
// the sums to float32 once.
//
// Design.  A sum's fold is a chain of n_parts dependent double adds, so it
// cannot be split over threads without changing its bits; what can be
// spread is the loading, which one SM takes at a few tens of GB/s.  So a
// CTA takes COLLAPSE_LW leaves of a set (a 65536-chain block's telemetry,
// analytics and cohort rows: 9 CTAs; 16 scenario rows: 16) and copies
// their rows into shared memory with every thread (cp.async, 16 bytes a
// copy where the rows allow it), COLLAPSE_STAGE doubles a stage (the 512
// rows of a block in one), COLLAPSE_NST stages in flight, while warp k
// folds the chunk's leaves of kind k (a thread a leaf, so no warp
// branches on the kind) from the stages that have landed, its shared
// loads COLLAPSE_AHEAD rows ahead of the dependent operations.  fmin /
// fmax on doubles (a compare, two selects and a NaN fix-up a step) made
// the minima and maxima the longest chains; their result does not depend
// on the order (LeafFold), so they run as COLLAPSE_AHEAD shorter ones.
// Measured (PERF.md): one thread a leaf walking the rows through global
// memory waited on each load (~0.1 ms a set); 32 leaves a CTA spent
// longer loading than folding; 128-row stages cost more in their turns
// than they saved.
#define COLLAPSE_MAX_SETS 4
#define COLLAPSE_LW 8
#define COLLAPSE_THREADS 256
#define COLLAPSE_STAGE 4096
#define COLLAPSE_NST 4
#define COLLAPSE_SMEM (COLLAPSE_NST * COLLAPSE_STAGE * (int)sizeof(double))
#define COLLAPSE_AHEAD 8

// one row set: its kinds repeat with a period of at most 32 leaves (the
// cohorts' and the scenario rows' do), two bits a leaf
struct CollapseSet {
  const double* part;  // (n_parts, L), row-major
  double* out;         // (L,)
  uint64_t kinds;      // kind of leaf l: bits 2 (l % period) and up
  int n_parts, L, period;
  int cta0;            // the set's first CTA (the entry fills it in)
};

struct CollapseGroup {
  int n_sets, n_ctas;  // n_ctas: filled in by the entry
  CollapseSet set[COLLAPSE_MAX_SETS];
};

// one leaf's running fold: for a sum one double, added in index order;
// for a minimum or maximum COLLAPSE_AHEAD running ones, a row each in
// turn, combined at the end (fmin / fmax order the doubles totally, -0.0
// below +0.0, and skip NaN, an empty accumulator's value, so any order
// gives the index-order fold's bits; only the payload of a leaf whose rows
// are all NaN may differ)
template <int KIND>
struct LeafFold {
  static constexpr int B = COLLAPSE_AHEAD;
  double x = 0.0;
  double a[B];

  __device__ __forceinline__ LeafFold() {
#pragma unroll
    for (int j = 0; j < B; ++j)
      a[j] = __longlong_as_double(0x7ff8000000000000LL);
  }
  __device__ __forceinline__ void first(double y) {
    if (KIND == K_SUM) x = y;
    else a[0] = y;
  }
  // rows r .. nr - 1 of a stage (row stride lw), loads ahead of the adds
  __device__ __forceinline__ void rows(const double* v, int r, int nr,
                                      int lw) {
    const int batches = (nr - r) / B;
    if (batches > 0) {
      double y[B];
#pragma unroll
      for (int j = 0; j < B; ++j) y[j] = v[(r + j) * lw];
      for (int b = 1; b < batches; ++b) {
        double z[B];
#pragma unroll
        for (int j = 0; j < B; ++j) z[j] = v[(r + b * B + j) * lw];
        add(y);
#pragma unroll
        for (int j = 0; j < B; ++j) y[j] = z[j];
      }
      add(y);
      r += batches * B;
    }
    for (; r < nr; ++r) {
      if (KIND == K_SUM) x = x + v[r * lw];
      else a[0] = combine<KIND>(a[0], v[r * lw]);
    }
  }
  __device__ __forceinline__ void add(const double (&y)[B]) {
#pragma unroll
    for (int j = 0; j < B; ++j) {
      if (KIND == K_SUM) x = x + y[j];
      else a[j] = combine<KIND>(a[j], y[j]);
    }
  }
  __device__ __forceinline__ double value() const {
    if (KIND == K_SUM) return x;
    double v = a[0];
#pragma unroll
    for (int j = 1; j < B; ++j) v = combine<KIND>(v, a[j]);
    return v;
  }
};

__global__ void __launch_bounds__(COLLAPSE_THREADS)
    collapse_kernel(const CollapseGroup g) {
  extern __shared__ double s_rows[];
  // the CTA's set (selects: no indexed read of the parameter)
  CollapseSet q = g.set[0];
#pragma unroll
  for (int k = 1; k < COLLAPSE_MAX_SETS; ++k)
    if (k < g.n_sets && (int)blockIdx.x >= g.set[k].cta0) q = g.set[k];
  const int l0 = ((int)blockIdx.x - q.cta0) * COLLAPSE_LW;
  const int lw = min(COLLAPSE_LW, q.L - l0);
  // rows a stage holds (even, so a stage of whole rows starts 16-byte
  // aligned)
  const int rows = (COLLAPSE_STAGE / lw) & ~1;
  const int n_st = (q.n_parts + rows - 1) / rows;
  const int tid = threadIdx.x;
  const bool aligned = (reinterpret_cast<uintptr_t>(q.part) & 15) == 0;
  // 16-byte copies: a stage of whole rows is one aligned run; a chunk of
  // each row is aligned when L, l0 and lw are even
  const bool whole = lw == q.L;
  const bool pairs = aligned && (whole || ((q.L | l0 | lw) & 1) == 0);
  // stage k into slot k % COLLAPSE_NST: one commit group (empty past the
  // last stage)
  auto issue = [&](int k) {
    if (k < n_st) {
      const int r0 = k * rows;
      const int ne = min(rows, q.n_parts - r0) * lw;
      double* dst = s_rows + (k % COLLAPSE_NST) * COLLAPSE_STAGE;
      const double* src = q.part + (int64_t)r0 * q.L + l0;
      for (int e = (pairs ? 2 : 1) * tid; e < ne;
           e += (pairs ? 2 : 1) * COLLAPSE_THREADS) {
        const int r = whole ? 0 : e / lw;
        const double* from = src + (int64_t)r * q.L + (e - r * lw);
        if (pairs && e + 1 < ne)
          __pipeline_memcpy_async(dst + e, from, 2 * sizeof(double));
        else
          __pipeline_memcpy_async(dst + e, from, sizeof(double));
      }
    }
    __pipeline_commit();
  };
  for (int k = 0; k < COLLAPSE_NST - 1; ++k) issue(k);
  // warp w < 3 folds the chunk's leaves of kind w, lane j the j-th of them
  const int kind = tid >> 5, lane = tid & 31;
  int leaf = -1;
  if (kind <= K_MAX) {
    for (int l = 0, j = 0; l < lw; ++l) {
      if ((int)((q.kinds >> (2 * ((l0 + l) % q.period))) & 3u) != kind)
        continue;
      if (j++ == lane) leaf = l;
    }
  }
  LeafFold<K_SUM> f_sum;
  LeafFold<K_MIN> f_min;
  LeafFold<K_MAX> f_max;
  for (int k = 0; k < n_st; ++k) {
    // the slot of stage k - 1, freed at the end of its turn
    issue(k + COLLAPSE_NST - 1);
    __pipeline_wait_prior(COLLAPSE_NST - 1);  // this thread's copies of k
    __syncthreads();                          // and everyone's
    if (leaf >= 0) {
      const double* v = s_rows + (k % COLLAPSE_NST) * COLLAPSE_STAGE + leaf;
      const int nr = min(rows, q.n_parts - k * rows);
      const int r = k == 0 ? 1 : 0;
      // warp-uniform: every lane of the warp has this kind
      if (kind == K_SUM) {
        if (k == 0) f_sum.first(v[0]);
        f_sum.rows(v, r, nr, lw);
      } else if (kind == K_MIN) {
        if (k == 0) f_min.first(v[0]);
        f_min.rows(v, r, nr, lw);
      } else {
        if (k == 0) f_max.first(v[0]);
        f_max.rows(v, r, nr, lw);
      }
    }
    __syncthreads();
  }
  if (leaf < 0) return;
  q.out[l0 + leaf] = kind == K_SUM   ? f_sum.value()
                     : kind == K_MIN ? f_min.value()
                                     : f_max.value();
}

// the series epilogue's second pass: per second, the (n_parts, T) CTA
// partials summed over the CTAs in double, rounded once (a float running
// sum over 512 partials would drift by ~1e-6 of the total, while the
// per-CTA partials, a 32-lane butterfly and then 4 warps, err by a few
// float ULP that average out).  The order is fixed: strand j (of
// SUM_STRANDS) adds partials j, j + SUM_STRANDS, ... in index order from
// 0.0, then the strands are added 0, 1, ... from 0.0 through shared
// memory (kernels/block_step.py series_sum_plain adds in the same order).
// No atomics, so a rerun gives the same bits.
//
// Bound: bytes (4.4 MB a 65536 x 1080 block, read once).  Design: CTA
// (x, y) takes SUM_COLS seconds of array y (meter, pv) with one thread
// per (strand, second): a warp reads SUM_COLS consecutive floats of 4
// partial rows (32-byte sectors, coalesced), and ceil(T / SUM_COLS) x 2
// CTAs (270 at T = 1080) spread the reads over every SM, where one
// thread per second walking all 512 partials kept 5 SMs busy.
#define SUM_STRANDS 32
#define SUM_COLS 8
__global__ void __launch_bounds__(SUM_STRANDS* SUM_COLS)
    series_sum_kernel(int n_parts, int T, const float* __restrict__ part_m,
                      const float* __restrict__ part_p, float* meter_sum,
                      float* pv_sum) {
  __shared__ double s_strand[SUM_STRANDS][SUM_COLS];
  const int col = threadIdx.x % SUM_COLS, strand = threadIdx.x / SUM_COLS;
  const int t = blockIdx.x * SUM_COLS + col;
  const float* part = blockIdx.y ? part_p : part_m;
  double x = 0.0;
  if (t < T) {
#pragma unroll 4
    for (int c = strand; c < n_parts; c += SUM_STRANDS)
      x = x + (double)part[(int64_t)c * T + t];
  }
  s_strand[strand][col] = x;
  __syncthreads();
  if (strand == 0 && t < T) {
    double tot = 0.0;
    for (int j = 0; j < SUM_STRANDS; ++j) tot = tot + s_strand[j][col];
    (blockIdx.y ? pv_sum : meter_sum)[t] = (float)tot;
  }
}

// K10's second launch, the scenario fold (_scenario_block_core's rows,
// tmhpvsim_tpu/engine/simulation.py:1890-1933): over the producer's
// time-major (T, n) meter and pv, each (scenario row, chain) folds its
// row's transform
//   meter_i = fmaf(meter, demand_scale, demand_shift_w)  (the JAX scan
//             contracts it: tests/test_torch_serve.py),
//   pv_i    = nminf(ac * (pv_scale * weather_bias), curtail_w),
// masked by the site / cohort selectors, t < duration_s and t < horizon_s,
// in second order into the seven statistics and a risk FleetAcc
// (obs/analytics.py fold_second).
//
// Design.  CTA (group set, row), the row fastest: its threads are the 128
// chains of one chain group at a time (the step's CTA, so the per-(group,
// row) partial rows keep their bits and order), one row each.  The CTAs
// of a group set read the group's ~1.1 MB of meter and pv at about the
// same time, so the rows after the first read it from L2; each thread
// loads the next SCN_CHUNK seconds' pairs while it folds this chunk's
// (with one second in flight the loads' latency bound the fold).  Every
// (row, chain) keeps its statistics and risk leaves in registers for the
// whole block: read once, written once.  A CTA walks groups_per_cta chain
// groups (chosen by the launcher so the grid is one wave), so the row's
// sketch lives in shared memory for all of them and is flushed once (one
// atomicAdd per non-zero slot).  The exceedance slots count in registers
// against the thresholds passed by value: with ascending thresholds slot
// k's count is the used samples above threshold k - 1 less those above
// threshold k, per-thread counters reduced over the warp before one
// atomicAdd per slot (past MAX_THR thresholds, one shared atomicAdd
// per used sample into the sketch's slots: counting the default seven
// that way took the fold from 6.3 to 8.3 ms at 16 rows on an H100,
// ab_kernels.py).  The residual bins count with one shared atomicAdd
// per used sample, or in global memory when the sketch does not fit in
// shared memory.  Integer counts commute, so every count is exact and
// order-free.  Which ramp grids each second closes is worked out once per
// CTA.  A (row, chain) past its last valid second (a row past its
// horizon, a chain its selectors leave out) skips the rest of the block
// when the producer's flag shows that it would fold only identities
// (see "The tail" below): the serving paths' short horizons cost little.
// (Folding 2 or 4 rows per thread, to read each value once for them, took
// 160 and 239 registers, and so fewer warps, and was slower at 16 rows.)
//
// Bound: operations (per valid (row, chain, second) sample the transform,
// the statistics, the bin, the threshold compares, the loss run and the
// ramp grids); the meter and pv are read from device memory once.
__global__ void __launch_bounds__(THREADS)
    scenario_fold_kernel(const Scen q, int groups_per_cta) {
  __shared__ double s_stage[WARPS * SCN_LEAVES];
  extern __shared__ int s_dyn[];
  const int B = q.B, T = q.T;
  const int64_t n = q.n;
  const int b = blockIdx.x % B;
  const int n_groups = (int)((n + THREADS - 1) / THREADS);
  const int g0 = (blockIdx.x / B) * groups_per_cta;
  const int g1 = min(n_groups, g0 + groups_per_cta);
  const int nbq = q.bins + 2, neq = q.n_thr + 1;
  const bool exc_regs = q.n_thr <= MAX_THR;
  // dynamic shared memory: the sketch (when shared), then per second which
  // ramp grids it closes (bit k: window k)
  const int sk_len = q.hist_shared ? nbq + (exc_regs ? 0 : neq) : 0;
  unsigned char* const s_grid =
      reinterpret_cast<unsigned char*>(s_dyn + sk_len);
  const float ds = q.knob_f[0][b], dsh = q.knob_f[1][b];
  const float pvw = q.knob_f[2][b] * q.knob_f[3][b], cap = q.knob_f[4][b];
  const int horizon = q.knob_i[0][b], site_sel = q.knob_i[1][b];
  const int coh_sel = q.knob_i[2][b];
  const int lim = min(q.duration_s, horizon);
  // s_info: the last second closing each ramp grid (-1: none), the
  // seconds before the row's limit, and whether t ever fails to increase
  __shared__ int s_info[5];
  if (threadIdx.x < 5) s_info[threadIdx.x] = threadIdx.x < 3 ? -1 : 0;
  for (int k = threadIdx.x; k < sk_len; k += blockDim.x) s_dyn[k] = 0;
  __syncthreads();
  for (int s = threadIdx.x; s < T; s += blockDim.x) {
    const int t = q.t[s];
    int bits = 0;
    for (int k = 0; k < 3; ++k) {
      const int w = q.ramp_w[k];
      if (w == 1 || (t + 1) % w == 0) {
        bits |= 1 << k;
        atomicMax(&s_info[k], s);
      }
    }
    s_grid[s] = (unsigned char)bits;
    if (t < lim) atomicAdd(&s_info[3], 1);
    if (s > 0 && q.t[s - 1] >= t) s_info[4] = 1;
  }
  __syncthreads();
  // The tail: once a (row, chain) has no valid second left, each further
  // second only adds x * 0 to its sums and the masks' identities to the
  // rest.  That changes nothing when every value is finite after the
  // transform (the producer's flag with knobs at most SCN_TAME), no sum is
  // -0 and no extremum lies outside +-FLT_MAX; the rest of the block then
  // needs no loads: the loss run ends and each ramp grid closing in it
  // clears its seen flag.  With t increasing the valid seconds of a
  // selected chain are the first s_info[3].
  const bool early = q.tame != nullptr && !s_info[4] &&
                     fabsf(ds) <= SCN_TAME && fabsf(dsh) <= SCN_TAME &&
                     fabsf(pvw) <= SCN_TAME && !(cap < -SCN_TAME);
  int* const g_hist = q.res_hist + (int64_t)b * nbq;
  int* const g_exc = q.exceed + (int64_t)b * neq;
  // the used samples and those above each threshold, over the CTA's chains
  int used = 0, above[MAX_THR];
#pragma unroll
  for (int j = 0; j < MAX_THR; ++j) above[j] = 0;

  for (int g = g0; g < g1; ++g) {
    const int64_t i = (int64_t)g * THREADS + threadIdx.x;
    const bool live = i < n;
    ScnRow e;
    if (live) {
      const int64_t o = (int64_t)b * n + i;
      e.pv_sum = q.stat_f[0][o];
      e.pv_max = q.stat_f[1][o];
      e.meter_sum = q.stat_f[2][o];
      e.residual_sum = q.stat_f[3][o];
      e.residual_min = q.stat_f[4][o];
      e.residual_max = q.stat_f[5][o];
      e.n_seconds = q.n_seconds[o];
      const bool sel = (site_sel < 0 || i == site_sel) &&
                       (q.cohort == nullptr || coh_sel < 0 ||
                        q.cohort[i] == coh_sel);
      const float* pm = q.meter + i;
      const float* pa = q.pv + i;
      // SCN_CHUNK seconds at a time, the next chunk's loads in flight
      // while this one folds
      float mc[SCN_CHUNK], ac[SCN_CHUNK];
#pragma unroll
      for (int u = 0; u < SCN_CHUNK; ++u) {
        mc[u] = __ldg(pm + (int64_t)u * n);
        ac[u] = __ldg(pa + (int64_t)u * n);
      }
      const int s_cut =
          early && q.tame[i]
              ? (sel ? s_info[3] + SCN_CHUNK - 1 : 0) / SCN_CHUNK * SCN_CHUNK
              : T;
      int s0 = 0;
      for (; s0 < T; s0 += SCN_CHUNK) {
        if (s0 >= s_cut && __float_as_uint(e.pv_sum) != 0x80000000u &&
            __float_as_uint(e.meter_sum) != 0x80000000u &&
            __float_as_uint(e.residual_sum) != 0x80000000u &&
            e.pv_max >= -FLT_MAX && e.residual_min <= FLT_MAX &&
            e.residual_max >= -FLT_MAX)
          break;
        float mx_[SCN_CHUNK], ax_[SCN_CHUNK];
        const bool more = s0 + SCN_CHUNK < T;
#pragma unroll
        for (int u = 0; u < SCN_CHUNK; ++u) {
          const int64_t o2 = (int64_t)(s0 + SCN_CHUNK + u) * n;
          mx_[u] = more ? __ldg(pm + o2) : 0.0f;
          ax_[u] = more ? __ldg(pa + o2) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < SCN_CHUNK; ++u) {
          const int s = s0 + u;
          const float m0 = mc[u], a0 = ac[u];
          const int t = __ldg(q.t + s);
          const int grid = s_grid[s];
          const float meter = fmaf(m0, ds, dsh);
          const float pv = nminf(a0 * pvw, cap);
          const float res = meter - pv;
          const bool valid = sel && t < q.duration_s && t < horizon;
          if (!valid) {
            // an invalid second (a row past its horizon, a chain its
            // selectors leave out) folds the identities: the same
            // arithmetic as below with the mask 0, a masked sum still
            // adding x * 0 (NaN for a non-finite x, as the JAX fold's)
            e.pv_sum = e.pv_sum + pv * 0.0f;
            e.pv_max = nmaxf(e.pv_max, -FLT_MAX);
            e.meter_sum = e.meter_sum + meter * 0.0f;
            e.residual_sum = e.residual_sum + res * 0.0f;
            e.residual_min = nminf(e.residual_min, FLT_MAX);
            e.residual_max = nmaxf(e.residual_max, -FLT_MAX);
            e.mn = nminf(e.mn, FLT_MAX);
            e.mx = nmaxf(e.mx, -FLT_MAX);
            e.lol_run = 0;
            e.lol_e += q.lolp_k == 0 ? 1 : 0;
            e.lol_s += q.lolp_k <= 0 ? 1 : 0;
  #pragma unroll
            for (int k = 0; k < 3; ++k)
              if (grid >> k & 1) e.seen[k] = 0;
            continue;
          }
          e.pv_sum = e.pv_sum + pv * 1.0f;
          e.pv_max = nmaxf(e.pv_max, pv);
          e.meter_sum = e.meter_sum + meter * 1.0f;
          e.residual_sum = e.residual_sum + res * 1.0f;
          e.residual_min = nminf(e.residual_min, res);
          e.residual_max = nmaxf(e.residual_max, res);
          e.n_seconds += 1;
          const bool use = isfinite(res);
          if (use) {
            e.n_use += 1;
            float bf = (res - q.lo) * q.inv_w;
            bf = nclampf(bf, -1.0f, (float)q.bins);
            const int idx = (int)floorf(bf) + 1;
            if (q.hist_shared) atomicAdd(&s_dyn[idx], 1);
            else atomicAdd(&g_hist[idx], 1);
            if (exc_regs) {
              exc_count(q.thr_v, res, above);
            } else {
              int slot = 0;
              for (int j = 0; j < q.n_thr; ++j)
                slot += q.thr[j] < res ? 1 : 0;
              if (q.hist_shared) atomicAdd(&s_dyn[nbq + slot], 1);
              else atomicAdd(&g_exc[slot], 1);
            }
          }
          e.mn = nminf(e.mn, use ? res : FLT_MAX);
          e.mx = nmaxf(e.mx, use ? res : -FLT_MAX);
          e.lol_run = (use && res > q.capacity) ? e.lol_run + 1 : 0;
          e.lol_e += e.lol_run == q.lolp_k ? 1 : 0;
          e.lol_s += e.lol_run >= q.lolp_k ? 1 : 0;
  #pragma unroll
          for (int k = 0; k < 3; ++k) {
            if (grid >> k & 1) {
              if (use && e.seen[k] > 0)
                e.ramp[k] = nmaxf(e.ramp[k], fabsf(res - e.prev[k]));
              if (use) e.prev[k] = res;
              e.seen[k] = use ? 1 : 0;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < SCN_CHUNK; ++u) {
          mc[u] = mx_[u];
          ac[u] = ax_[u];
        }
      }
      if (s0 < T) {  // the tail, without its loads
        e.lol_run = 0;
        e.lol_e += q.lolp_k == 0 ? T - s0 : 0;
        e.lol_s += q.lolp_k <= 0 ? T - s0 : 0;
        for (int k = 0; k < 3; ++k)
          if (s_info[k] >= s0) e.seen[k] = 0;
      }
      q.stat_f[0][o] = e.pv_sum;
      q.stat_f[1][o] = e.pv_max;
      q.stat_f[2][o] = e.meter_sum;
      q.stat_f[3][o] = e.residual_sum;
      q.stat_f[4][o] = e.residual_min;
      q.stat_f[5][o] = e.residual_max;
      q.n_seconds[o] = e.n_seconds;
      if (q.chain_i != nullptr) {
        const int64_t plane = (int64_t)B * n;
        int* ci = q.chain_i + o;
        float* cf = q.chain_f + o;
        ci[0] = e.n_use;
        ci[plane] = e.lol_run;
        ci[2 * plane] = e.lol_s;
        ci[3 * plane] = e.lol_e;
        for (int k = 0; k < 3; ++k) ci[(4 + k) * plane] = e.seen[k];
        cf[0] = e.mn;
        cf[plane] = e.mx;
        for (int k = 0; k < 3; ++k) {
          cf[(2 + k) * plane] = e.ramp[k];
          cf[(5 + k) * plane] = e.prev[k];
        }
      }
      used += e.n_use;
    }
    // the (group, row) partial row (dead threads hold the identities)
    double v[SCN_LEAVES] = {(double)e.n_use, e.mn,      e.mx,
                            (double)e.lol_s, (double)e.lol_e,
                            e.ramp[0],       e.ramp[1], e.ramp[2]};
    const int kind[SCN_LEAVES] = {K_SUM, K_MIN, K_MAX, K_SUM,
                                  K_SUM, K_MAX, K_MAX, K_MAX};
    cta_partials(v, kind, s_stage,
                 q.part + ((int64_t)g * B + b) * SCN_LEAVES);
  }
  // the sketch, once per CTA
  if (q.hist_shared) {
    __syncthreads();
    flush_hist(s_dyn, g_hist, nbq);
    if (!exc_regs) flush_hist(s_dyn + nbq, g_exc, neq);
  }
  if (exc_regs) exc_flush(q.n_thr, used, above, g_exc);
}

// the site mode's geometry on its own (a test entry): out (9, T, n)
__global__ void geometry_kernel(int64_t n, int T, const float* rows_f,
                                const float* lat, const float* lon,
                                const float* alt, const float* tilt,
                                const float* azi, const float* alb,
                                const float* turb, float* out) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const SiteC c =
      site_consts<KSET>(lat[i], lon[i], alt[i], tilt[i], azi[i], alb[i]);
  const int64_t plane = (int64_t)T * n;
  for (int s = 0; s < T; ++s) {
    TimeC ts;
    time_terms<KSET>(ts, rows_f, T, s, turb);
    const Geo g = geometry<KSET>(ts, c);
    const float f[9] = {g.zenith,    g.cos_zenith, g.app_zen,
                        g.azimuth,   g.csi_cap,    g.ghi_clear,
                        g.dni_extra, g.airmass_abs, g.cos_aoi};
    for (int k = 0; k < 9; ++k) out[k * plane + (int64_t)s * n + i] = f[k];
  }
}

using StepFn = void (*)(const Args);

// the kernel of one instantiation
template <int EPI, int GEO, bool TEL>
static StepFn kernel_of() {
  if constexpr (EPI == PROD)
    return block_step_prod_kernel<KSET, CDTYPE, PRNG, GEO>;
  else
    return block_step_kernel<KSET, CDTYPE, PRNG, EPI, GEO, TEL>;
}

template <int EPI, int GEO, bool TEL>
static int launch_one(const Args& a, unsigned blocks, cudaStream_t st) {
  kernel_of<EPI, GEO, TEL>()<<<blocks, THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// one instantiation per (epilogue, geometry mode) and, for acc, telemetry
// on or off; geo: 0 shared, 1 site, 2 strided (a.stride 30 or 60)
template <int EPI>
static int launch(int geo, const Args& a, void* stream, int tel = 0) {
  if (a.T % TILE) return (int)cudaErrorInvalidValue;
  if (geo == STRIDED && (a.stride <= 0 || TILE % a.stride ||
                         TILE / a.stride + 1 > MAX_SAMP))
    return (int)cudaErrorInvalidValue;
  if (geo < SHARED || geo > STRIDED) return (int)cudaErrorInvalidValue;
  if (a.n <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((a.n + THREADS - 1) / THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  if constexpr (EPI == ACC) {
    if (tel)
      return geo == SHARED ? launch_one<ACC, SHARED, true>(a, blocks, st)
             : geo == SITE ? launch_one<ACC, SITE, true>(a, blocks, st)
                           : launch_one<ACC, STRIDED, true>(a, blocks, st);
  }
  return geo == SHARED ? launch_one<EPI, SHARED, false>(a, blocks, st)
         : geo == SITE ? launch_one<EPI, SITE, false>(a, blocks, st)
                       : launch_one<EPI, STRIDED, false>(a, blocks, st);
}

// an instantiation's registers and CTAs an SM (at 128 threads, no dynamic
// shared memory): out = {registers, CTAs per SM, local bytes}
template <int EPI, int GEO, bool TEL>
static int attrs_one(int* out) {
  const StepFn kernel = kernel_of<EPI, GEO, TEL>();
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel,
                                                      THREADS, 0);
  out[0] = fa.numRegs;
  out[2] = (int)fa.localSizeBytes;
  return (int)e;
}

template <int EPI>
static int attrs(int geo, int tel, int* out) {
  if constexpr (EPI == ACC) {
    if (tel)
      return geo == SHARED ? attrs_one<ACC, SHARED, true>(out)
             : geo == SITE ? attrs_one<ACC, SITE, true>(out)
                           : attrs_one<ACC, STRIDED, true>(out);
  }
  return geo == SHARED ? attrs_one<EPI, SHARED, false>(out)
         : geo == SITE ? attrs_one<EPI, SITE, false>(out)
                       : attrs_one<EPI, STRIDED, false>(out);
}


static Args common(int64_t n, int T, int stride, int layout, int duration_s,
                   float meter_max_w,
                   float cos_tilt, float albedo, const int* rows_i,
                   const float* rows_f, const float* t_cc,
                   const float* t_cloudy, const float* t_cd,
                   const float* t_ws, const float* t_ml, const float* t_mc,
                   const int64_t* k_scan, const int64_t* k_meter,
                   const float* lat, const float* lon, const float* alt,
                   const float* tilt, const float* azi, const float* alb,
                   const float* turb, const float* pv_scale,
                   const float* ac_limit, const float* dem_scale,
                   const float* dem_shift, float* cloud_end, float* total_end,
                   float* sec) {
  Args a = {};
  a.n = n;
  a.T = T;
  a.stride = stride;
  a.layout = layout;
  a.duration_s = duration_s;
  a.meter_max_w = meter_max_w;
  a.cos_tilt = cos_tilt;
  a.albedo = albedo;
  a.rows_i = rows_i;
  a.rows_f = rows_f;
  a.t_cc = t_cc;
  a.t_cloudy = t_cloudy;
  a.t_cd = t_cd;
  a.t_ws = t_ws;
  a.t_ml = t_ml;
  a.t_mc = t_mc;
  a.k_scan = k_scan;
  a.k_meter = k_meter;
  a.lat = lat;
  a.lon = lon;
  a.alt = alt;
  a.tilt = tilt;
  a.azi = azi;
  a.alb = alb;
  a.turb = turb;
  a.pv_scale = pv_scale;
  a.ac_limit = ac_limit;
  a.dem_scale = dem_scale;
  a.dem_shift = dem_shift;
  a.cloud_end = cloud_end;
  a.total_end = total_end;
  a.sec = sec;
  return a;
}

#define COMMON_PARAMS                                                        \
  int geo, int stride, int layout, int64_t n, int T, int duration_s, float meter_max_w, \
      float cos_tilt, float albedo, const int *rows_i, const float *rows_f,  \
      const float *t_cc, const float *t_cloudy, const float *t_cd,           \
      const float *t_ws, const float *t_ml, const float *t_mc,               \
      const int64_t *k_scan, const int64_t *k_meter, const float *lat,       \
      const float *lon, const float *alt, const float *tilt,                 \
      const float *azi, const float *alb, const float *turb,                 \
      const float *pv_scale, const float *ac_limit, const float *dem_scale,  \
      const float *dem_shift, float *cloud_end, float *total_end, float *sec
#define COMMON_ARGS                                                          \
  n, T, stride, layout, duration_s, meter_max_w, cos_tilt, albedo, rows_i, rows_f,  \
      t_cc,                                                                  \
      t_cloudy, t_cd, t_ws, t_ml, t_mc, k_scan, k_meter, lat, lon, alt, tilt, \
      azi, alb, turb, pv_scale, ac_limit, dem_scale, dem_shift, cloud_end,   \
      total_end, sec

// obs: the telemetry's arguments (nullptr with tel 0)
extern "C" int block_step_acc(COMMON_PARAMS, float* pv_sum, float* pv_max,
                              float* meter_sum, float* residual_sum,
                              float* residual_min, float* residual_max,
                              int* n_seconds, const Obs* obs, int tel,
                              void* stream) {
  Args a = common(COMMON_ARGS);
  a.pv_sum = pv_sum;
  a.pv_max = pv_max;
  a.meter_sum = meter_sum;
  a.residual_sum = residual_sum;
  a.residual_min = residual_min;
  a.residual_max = residual_max;
  a.n_seconds = n_seconds;
  if (obs != nullptr) a.o = *obs;
  return launch<ACC>(geo, a, stream, tel);
}

// the acc producer: the acc launch's statistics and carry, and the
// block's time-major (T, n) meter, pv, csi (nullptr: not written) and
// covered flags (uint8; nullptr: not written) for obs_fold
extern "C" int block_step_prod(COMMON_PARAMS, float* pv_sum, float* pv_max,
                               float* meter_sum, float* residual_sum,
                               float* residual_min, float* residual_max,
                               int* n_seconds, float* meter, float* pv,
                               float* csi, unsigned char* cov,
                               void* stream) {
  Args a = common(COMMON_ARGS);
  a.pv_sum = pv_sum;
  a.pv_max = pv_max;
  a.meter_sum = meter_sum;
  a.residual_sum = residual_sum;
  a.residual_min = residual_min;
  a.residual_max = residual_max;
  a.n_seconds = n_seconds;
  a.out_meter = meter;
  a.out_pv = pv;
  a.out_csi = csi;
  a.out_cov = cov;
  return launch<PROD>(geo, a, stream);
}

// an instantiation's launch shape: epi (Epilogue), geo (Geom), tel (acc
// only); out = {registers, CTAs per SM, local bytes}
extern "C" int step_attrs(int epi, int geo, int tel, int* out,
                          void* stream) {
  (void)stream;
  if (geo < SHARED || geo > STRIDED) return (int)cudaErrorInvalidValue;
  switch (epi) {
    case ACC: return attrs<ACC>(geo, tel, out);
    case SERIES: return attrs<SERIES>(geo, 0, out);
    case TRACE: return attrs<TRACE>(geo, 0, out);
    case SCEN: return attrs<SCEN>(geo, 0, out);
    case PROD: return attrs<PROD>(geo, 0, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the layout check of the wrapper's ctypes mirror of Obs
extern "C" int obs_struct_size(void* stream) {
  (void)stream;
  return (int)sizeof(Obs);
}

// K10's producer: the block's time-major (T, n) meter and pv, drawn in
// the flat scan's layout (under BF16 with the acc epilogue's bf16 draws),
// and each chain's SCN_TAME flag (n,)
extern "C" int block_step_scenario(COMMON_PARAMS, float* meter, float* pv,
                                   int* tame, void* stream) {
  Args a = common(COMMON_ARGS);
  a.out_meter = meter;
  a.out_pv = pv;
  a.out_tame = tame;
  return launch<SCEN>(geo, a, stream);
}

// K10's fold: q the rows' knobs, the producer's meter and pv, the (B, n)
// statistics (updated in place), the sketch and the partial rows; smem
// the dynamic shared bytes: the sketch when q->hist_shared, then T bytes
// of ramp flags.  One wave: as many CTAs as fit on the card at once, each
// walking groups_per_cta chain groups of its row.
extern "C" int scenario_fold(const Scen* q, int smem, void* stream) {
  if (q->B <= 0 || q->T <= 0 || q->T % SCN_CHUNK)
    return (int)cudaErrorInvalidValue;
  if (q->n <= 0) return (int)cudaGetLastError();
  auto kernel = scenario_fold_kernel;
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t n_groups = (q->n + THREADS - 1) / THREADS;
  const int64_t wave = std::max<int64_t>(1, (int64_t)sms * per_sm);
  const int64_t gpc =
      std::max<int64_t>(1, (q->B * n_groups + wave - 1) / wave);
  const int64_t blocks = q->B * ((n_groups + gpc - 1) / gpc);
  kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      *q, (int)gpc);
  return (int)cudaGetLastError();
}

// the layout check of the wrapper's ctypes mirror of Scen
extern "C" int scen_struct_size(void* stream) {
  (void)stream;
  return (int)sizeof(Scen);
}

// the grouped collapse: g's sets (their part, out, kinds, n_parts, L and
// period; n_parts >= 1, 1 <= period <= 32, L a multiple of it), one launch
extern "C" int collapse_partials(const CollapseGroup* g, void* stream) {
  if (g->n_sets < 1 || g->n_sets > COLLAPSE_MAX_SETS)
    return (int)cudaErrorInvalidValue;
  CollapseGroup a = *g;
  a.n_ctas = 0;
  for (int k = 0; k < a.n_sets; ++k) {
    CollapseSet& q = a.set[k];
    if (q.n_parts < 1 || q.L < 1 || q.period < 1 || q.period > 32 ||
        q.L % q.period)
      return (int)cudaErrorInvalidValue;
    q.cta0 = a.n_ctas;
    a.n_ctas += (q.L + COLLAPSE_LW - 1) / COLLAPSE_LW;
  }
  // above 48 KB of dynamic shared memory only after opting in, once a
  // device
  static unsigned opted = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev < 32 && !(opted & (1u << dev))) {
    e = cudaFuncSetAttribute(collapse_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             COLLAPSE_SMEM);
    if (e == cudaSuccess) opted |= 1u << dev;
  }
  if (e != cudaSuccess) return (int)e;
  collapse_kernel<<<a.n_ctas, COLLAPSE_THREADS, COLLAPSE_SMEM,
                    (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// the layout check of the wrapper's ctypes mirror of CollapseGroup
extern "C" int collapse_struct_size(void* stream) {
  (void)stream;
  return (int)sizeof(CollapseGroup);
}

extern "C" int block_step_series(COMMON_PARAMS, float* part_meter,
                                 float* part_pv, void* stream) {
  Args a = common(COMMON_ARGS);
  a.out_meter = part_meter;
  a.out_pv = part_pv;
  return launch<SERIES>(geo, a, stream);
}

extern "C" int block_step_trace(COMMON_PARAMS, float* meter, float* pv,
                                void* stream) {
  Args a = common(COMMON_ARGS);
  a.out_meter = meter;
  a.out_pv = pv;
  return launch<TRACE>(geo, a, stream);
}

extern "C" int series_sum(int n_parts, int T, const float* part_meter,
                          const float* part_pv, float* meter_sum,
                          float* pv_sum, void* stream) {
  if (T > 0) {
    const dim3 blocks((unsigned)((T + SUM_COLS - 1) / SUM_COLS), 2);
    series_sum_kernel<<<blocks, SUM_STRANDS * SUM_COLS, 0,
                        (cudaStream_t)stream>>>(n_parts, T, part_meter,
                                                part_pv, meter_sum, pv_sum);
  }
  return (int)cudaGetLastError();
}

extern "C" int device_geometry_fields(int64_t n, int T, const float* rows_f,
                                      const float* lat, const float* lon,
                                      const float* alt, const float* tilt,
                                      const float* azi, const float* alb,
                                      const float* turb, float* out,
                                      void* stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    geometry_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        n, T, rows_f, lat, lon, alt, tilt, azi, alb, turb, out);
  }
  return (int)cudaGetLastError();
}

// the NaN-keeping helpers of nanminmax.cuh on their own (a test entry):
// out (3, n) = nminf(a, b), nmaxf(a, b), nclampf(a, lo, hi)
__global__ void nan_minmax_kernel(int64_t n, const float* a, const float* b,
                                  float lo, float hi, float* out) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = nminf(a[i], b[i]);
  out[n + i] = nmaxf(a[i], b[i]);
  out[2 * n + i] = nclampf(a[i], lo, hi);
}

extern "C" int nan_minmax(int64_t n, const float* a, const float* b,
                          float lo, float hi, float* out, void* stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    nan_minmax_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        n, a, b, lo, hi, out);
  }
  return (int)cudaGetLastError();
}
