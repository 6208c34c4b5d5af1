// K3 / K4 / K6: one block, one thread per chain, looping over the block's
// seconds; a template over the epilogue (acc | series | trace) and the
// geometry mode (shared rows | per-chain site).
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
// and the pre-drawn streams of clearsky_index.scan_draws_tmajor /
// meter_block_tmajor (:278-319).  Plain versions:
// tmhpvsim_torch/kernels/block_step.py block_step_plain, series_plain,
// trace_plain, and models/solar.py device_geometry.
//
// Design.  The per-second pipeline is written once, in block_step_kernel's
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
// once for all chains; in the site mode with only the doy terms (Spencer
// at both constants, the Linke lerp), while every thread evaluates its
// own site's geometry (PSA sun position from the split time, refraction,
// Kasten-Young, Ineichen, AOI) and the physics terms from it.
//
// Epilogues.  acc folds in second order, chain by chain, as the scan adds.
// series reduces each second's meter and pv over the CTA's chains in a
// fixed order (a warp xor-butterfly, then the 4 warps in index order) into
// (n_ctas, T) partials; series_sum adds the partials over CTAs in index
// order, one thread per second, in double.  No atomics: a repeated run
// gives the same bits.  trace writes time-major (T, n) meter and pv, coalesced
// (consecutive threads are consecutive chains); the engine hands the host
// an (n, T) view.
//
// Bound: operations for acc and series (per site-second about three
// 20-round threefry hashes, XLA's erfinv and log1p polynomials, accurate
// expf and logf, plus powf x2 on a redraw; the site mode adds about 30
// accurate transcendentals of the sun position); trace adds 8 bytes per
// chain-second written, 566 MB per 65536 x 1080 block, still under the
// operation time.
#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

#include "consts.cuh"
#include "threefry.cuh"

#define TILE 60
#define THREADS 128
#define WARPS (THREADS / 32)

enum Epilogue { ACC = 0, SERIES = 1, TRACE = 2 };

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

// the site mode's shared per-second terms: split time and doy terms
struct TimeC {
  float day, sec, doy, i0, dni_extra, tl;
};

struct SharedSecond {
  Cal c;
  Phys p;
};

struct SiteSecond {
  Cal c;
  TimeC ts;
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

struct Args {
  int64_t n;
  int T, duration_s;
  float meter_max_w, cos_tilt, albedo;
  const int* rows_i;
  const float* rows_f;
  const float *t_cc, *t_cloudy, *t_cd, *t_ws, *t_ml, *t_mc;
  const int64_t *k_scan, *k_meter;
  const float *lat, *lon, *alt, *tilt, *azi, *alb, *turb;
  float *cloud_end, *total_end, *sec;
  // acc
  float *pv_sum, *pv_max, *meter_sum, *residual_sum, *residual_min,
      *residual_max;
  int* n_seconds;
  // series partials (n_ctas, T) / trace outputs (T, n)
  float *out_meter, *out_pv;
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

// Spencer's factor: extraterrestrial irradiance over the solar constant
__device__ __forceinline__ float spencer(float doy) {
  const float b = PV_TWO_PI * (doy - 1.0f) / 365.0f;
  return 1.00011f + 0.034221f * cosf(b) + 0.00128f * sinf(b) +
         0.000719f * cosf(2.0f * b) + 7.7e-5f * sinf(2.0f * b);
}

// the physics terms of one second from its geometry (pv.second_terms)
__device__ __forceinline__ void phys_terms(Phys& P, float i0, float zen,
                                           float cos_zen, float cos_app,
                                           float ama, float cos_aoi) {
  P.i0 = i0;
  P.i0h = i0 * fmaxf(cos_zen, 0.065f);
  // Kasten 1966 airmass and the DISC knc polynomial
  const float z_deg = fminf(fmaxf(zen / PV_DEG, 0.0f), 93.0f);
  const float am = 1.0f / (cosf(z_deg * PV_DEG) +
                           0.15f * powf(93.885f - z_deg, -1.253f));
  const float am2 = am * am;
  P.am = am;
  P.knc = 0.866f - 0.122f * am + 0.0121f * am * am - 0.000653f * (am * am2) +
          1.4e-5f * (am2 * am2);
  P.zen_ok = zen < PV_ZEN_MAX;
  P.rb = fmaxf(cos_aoi, 0.0f) / fmaxf(cos_app, 0.01745f);
  // SAPM spectral (airmass) and angle-of-incidence polynomials
  const float ama2 = ama * ama;
  P.f1 = MA[0] + MA[1] * ama + MA[2] * ama2 + MA[3] * (ama * ama2) +
         MA[4] * (ama2 * ama2);
  const float aoi = acosf(fminf(fmaxf(cos_aoi, -1.0f), 1.0f)) / PV_DEG;
  const float aoi2 = aoi * aoi, aoi4 = aoi2 * aoi2;
  const float f2 = MB[0] + MB[1] * aoi + MB[2] * aoi2 + MB[3] * (aoi * aoi2) +
                   MB[4] * aoi4 + MB[5] * (aoi * aoi4);
  P.f2 = fmaxf(f2, 0.0f);
}

// shared mode: one second's terms from the host geometry rows
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
  const float i0 = 1370.0f * spencer(r[DOY * T + s]);
  phys_terms(S.p, i0, zen, cosf(zen), cosf(r[APP_ZENITH * T + s]),
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

// site mode: one second's shared time terms
__device__ __forceinline__ void time_terms(TimeC& S, const float* r, int T,
                                           int s, const float* turb) {
  S.day = r[DAY2000 * T + s];
  S.sec = r[SEC_OF_DAY * T + s];
  S.doy = r[SDOY * T + s];
  const float f = spencer(S.doy);
  S.i0 = 1370.0f * f;
  S.dni_extra = GEO_SOLAR_CONSTANT * f;
  S.tl = linke(S.doy, turb);
}

__device__ __forceinline__ SiteC site_consts(float lat_deg, float lon_deg,
                                             float alt, float tilt_deg,
                                             float az_deg, float albedo) {
  SiteC c;
  const float lat = lat_deg * PV_DEG;
  c.lon = lon_deg * PV_DEG;
  c.cos_lat = cosf(lat);
  c.sin_lat = sinf(lat);
  c.pressure = GEO_STD_PRESSURE * powf(1.0f - 2.25577e-5f * alt, 5.25588f);
  c.refr = c.pressure / 100.0f / 1010.0f * GEO_REFR_T * 1.02f;
  c.fh1 = expf(-alt / 8000.0f);
  c.fh2 = expf(-alt / 1250.0f);
  c.cg1 = 5.09e-5f * alt + 0.868f;
  c.cg2 = 3.92e-5f * alt + 0.0387f;
  const float tilt = tilt_deg * PV_DEG;
  c.cos_tilt = cosf(tilt);
  c.sin_tilt = sinf(tilt);
  c.saz = az_deg * PV_DEG;
  c.albedo = albedo;
  return c;
}

// x % m as jnp.remainder computes it (m > 0): the exact fmod, into [0, m)
__device__ __forceinline__ float fmod_floor(float x, float m) {
  const float r = fmodf(x, m);
  return r < 0.0f ? r + m : r;
}

// solar.device_geometry for one site and second
__device__ __forceinline__ Geo geometry(const TimeC& ts, const SiteC& c) {
  Geo g;
  // PSA sun position from the split time (sun_position_split)
  const float frac = ts.sec / 86400.0f - 0.5f;
  const float hour_ut = ts.sec / 3600.0f;
#define LIN(c0, c1) (((c0) + (c1) * ts.day) + (c1) * frac)
  const float omega = LIN(2.267127827f, -9.300339267e-4f);
  const float mean_lon = LIN(4.895036035f, 1.720279602e-2f);
  const float mean_anom = LIN(6.239468336f, 1.720200135e-2f);
  const float ecl_lon = mean_lon + 3.338320972e-2f * sinf(mean_anom) +
                        3.497596876e-4f * sinf(2.0f * mean_anom) -
                        1.544353226e-4f - 8.689729360e-6f * sinf(omega);
  const float obliquity =
      LIN(4.090904909e-1f, -6.213605399e-9f) + 4.418094944e-5f * cosf(omega);
#undef LIN
  const float sin_l = sinf(ecl_lon);
  const float ra =
      fmod_floor(atan2f(cosf(obliquity) * sin_l, cosf(ecl_lon)), PV_TWO_PI);
  const float dec = asinf(sinf(obliquity) * sin_l);
  const float gmst_h = fmod_floor(6.697096103f + 6.570984737e-2f * ts.day,
                                  24.0f) +
                       6.570984737e-2f * frac + hour_ut;
  const float lmst = gmst_h * 15.0f * PV_DEG + c.lon;
  const float ha = lmst - ra;
  const float cos_dec = cosf(dec), sin_dec = sinf(dec);
  const float cos_ha = cosf(ha);
  const float cos_zen = fminf(
      fmaxf(c.cos_lat * cos_ha * cos_dec + sin_dec * c.sin_lat, -1.0f), 1.0f);
  float zenith = acosf(cos_zen);
  g.azimuth = fmod_floor(
      atan2f(-sinf(ha), tanf(dec) * c.cos_lat - c.sin_lat * cos_ha),
      PV_TWO_PI);
  zenith = zenith + GEO_PARALLAX * sinf(zenith);
  g.zenith = zenith;
  g.cos_zenith = cosf(zenith);
  // refraction (apparent_elevation)
  const float e_deg = (GEO_HALF_PI - zenith) / PV_DEG;
  const float de = e_deg >= GEO_REFR_MIN
                       ? c.refr / (60.0f * tanf((e_deg + 10.3f /
                                                 (e_deg + 5.11f)) * PV_DEG))
                       : 0.0f;
  const float app_zen = GEO_HALF_PI - (e_deg + de) * PV_DEG;
  g.app_zen = app_zen;
  // Kasten-Young relative airmass, absolute at the site's pressure
  const float zd = fminf(fmaxf(app_zen / PV_DEG, 0.0f), 90.0f);
  const float am_rel = 1.0f / (cosf(zd * PV_DEG) +
                               0.50572f * powf(96.07995f - zd, -1.6364f));
  g.airmass_abs = am_rel * c.pressure / GEO_STD_PRESSURE;
  g.dni_extra = ts.dni_extra;
  // Ineichen clear-sky GHI
  const float cos_app = cosf(app_zen);
  g.cos_app = cos_app;
  const float ghi = c.cg1 * ts.dni_extra * fmaxf(cos_app, 0.0f) *
                    expf(-c.cg2 * g.airmass_abs *
                         (c.fh1 + c.fh2 * (ts.tl - 1.0f)));
  g.ghi_clear = fmaxf(ghi, 0.0f);
  // clear-sky-index cap and the angle of incidence
  const float cap = 27.21f * expf(-114.0f * g.cos_zenith) +
                    1.665f * expf(-4.494f * g.cos_zenith) + 1.08f;
  g.csi_cap = fminf(cap, 1e6f);
  g.cos_aoi = c.cos_tilt * cos_app +
              c.sin_tilt * sinf(app_zen) * cosf(g.azimuth - c.saz);
  return g;
}

// pv.power_from_terms for one chain-second
__device__ __forceinline__ float power(float csi, const Phys& S,
                                       float cos_tilt, float albedo) {
  csi = fminf(csi, S.csi_cap);
  const float ghi = csi * S.ghi_clear;
  // DISC
  const float kt = fminf(fmaxf(ghi / S.i0h, 0.0f), 2.0f);
  const float kt2 = kt * kt;
  const float kt3 = kt2 * kt;
  const bool hi = kt > 0.6f;
  const float a = hi ? -5.743f + 21.77f * kt - 27.49f * kt2 + 11.56f * kt3
                     : 0.512f - 1.56f * kt + 2.286f * kt2 - 2.222f * kt3;
  const float b = hi ? 41.4f - 118.5f * kt + 66.05f * kt2 + 31.9f * kt3
                     : 0.37f + 0.962f * kt;
  const float c = hi ? -47.01f + 184.2f * kt - 222.0f * kt2 + 73.81f * kt3
                     : -0.28f + 0.932f * kt - 2.048f * kt2;
  const float delta_kn = a + b * expf(fminf(c * S.am, 40.0f));
  float dni = (S.knc - delta_kn) * S.i0;
  dni = (S.zen_ok && ghi > 0.0f) ? fmaxf(dni, 0.0f) : 0.0f;
  const float dhi = fmaxf(ghi - dni * S.cos_zenith, 0.0f);
  // Hay-Davies POA + isotropic ground
  const float ai = dni / S.dni_extra;
  const float sky = dhi * (ai * S.rb + (1.0f - ai) * 0.5f * (1.0f + cos_tilt));
  const float ground = ghi * albedo * 0.5f * (1.0f - cos_tilt);
  const float pdir = fmaxf(dni * S.cos_aoi, 0.0f);
  const float pdiff = fmaxf(sky, 0.0f) + ground;
  const float pglob = pdir + pdiff;
  // SAPM temperature, effective irradiance, DC
  const float t_cell = pglob * EXP_T + 20.0f + pglob / 1000.0f * T_DELTA;
  float ee = S.f1 * (pdir * S.f2 + FD * pdiff) / 1000.0f;
  ee = fmaxf(ee, 0.0f);
  const float dt = t_cell - 25.0f;
  const float delta = N_BOLTZ * (t_cell + 273.15f) / ELEM_CHARGE;
  const bool pos = ee > 0.0f;
  const float log_ee = logf(pos ? ee : 1.0f);
  float i_mp = IMPO * (SC0 * ee + SC1 * (ee * ee)) * (1.0f + AIMP * dt);
  const float bvmp = BVMPO + MBVMP * (1.0f - ee);
  const float dl = delta * log_ee;
  float v_mp = VMPO + C2NS * delta * log_ee + C3NS * (dl * dl) + bvmp * dt;
  i_mp = pos ? fmaxf(i_mp, 0.0f) : 0.0f;
  v_mp = pos ? fmaxf(v_mp, 0.0f) : 0.0f;
  const float p_mp = i_mp * v_mp;
  // Sandia inverter
  const float dv = v_mp - VDCO;
  const float ia = PDCO * (1.0f + IC1 * dv);
  const float ib = PSO * (1.0f + IC2 * dv);
  const float ic = IC0 * (1.0f + IC3 * dv);
  const float a_b = fabsf(ia - ib) > 1e-12f ? ia - ib : 1e-12f;
  const float pd = p_mp - ib;
  float ac = (PACO / a_b - ic * a_b) * pd + ic * pd * pd;
  ac = fminf(ac, PACO);
  ac = p_mp < PSO ? PNT_NEG : ac;
  return fmaxf(ac, 0.0f);
}

template <int EPI, bool SITE>
__global__ void __launch_bounds__(THREADS) block_step_kernel(const Args a) {
  using Second =
      typename std::conditional<SITE, SiteSecond, SharedSecond>::type;
  __shared__ Second tile[TILE];
  __shared__ float red_m[EPI == SERIES ? WARPS : 1][TILE];
  __shared__ float red_p[EPI == SERIES ? WARPS : 1][TILE];
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
  if (EPI == ACC) {
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
  if (SITE) {
    site = site_consts(a.lat[ii], a.lon[ii], a.alt[ii], a.tilt[ii],
                       a.azi[ii], a.alb[ii]);
    cos_tilt = site.cos_tilt;
    albedo = site.albedo;
  }
  const tf::Key ks = tf::load_key(a.k_scan, ii),
                km0 = tf::load_key(a.k_meter, ii);

  for (int base = 0; base < T; base += TILE) {
    __syncthreads();
    if (threadIdx.x < TILE) {
      if constexpr (SITE) {
        load_cal(tile[threadIdx.x].c, a.rows_i, a.rows_f, T,
                 base + threadIdx.x);
        time_terms(tile[threadIdx.x].ts, a.rows_f, T, base + threadIdx.x,
                   a.turb);
      } else {
        shared_second(tile[threadIdx.x], a.rows_i, a.rows_f, T,
                      base + threadIdx.x);
      }
    }
    __syncthreads();
    // series keeps every thread in the loop for the warp reductions
    if (EPI != SERIES && !live) continue;
    // blocks are minute-aligned: the tile is global minute t / 60
    const uint32_t g = (uint32_t)(tile[0].c.t / 60);
    const tf::Key kg = tf::fold_in(ks, g);
    const tf::Key ku = tf::fold_in(kg, 0u), kz = tf::fold_in(kg, 1u);
    const tf::Key km = tf::fold_in(km0, g);
    for (int s = 0; s < TILE; ++s) {
      const Cal& S = tile[s].c;
      Phys local;
      if constexpr (SITE) {
        const Geo geo = geometry(tile[s].ts, site);
        local.csi_cap = geo.csi_cap;
        local.ghi_clear = geo.ghi_clear;
        local.cos_zenith = geo.cos_zenith;
        local.dni_extra = geo.dni_extra;
        local.cos_aoi = geo.cos_aoi;
        phys_terms(local, tile[s].ts.i0, geo.zenith, geo.cos_zenith,
                   geo.cos_app, geo.airmass_abs, geo.cos_aoi);
      }
      const Phys* P;
      if constexpr (SITE) {
        P = &local;
      } else {
        P = &tile[s].p;
      }
      // sampler lerps (value-major tables)
      const float cc_t = a.t_cc[S.h * n + ii] * S.one_m_hf +
                         a.t_cc[(S.h + 1) * n + ii] * S.hf;
      const float z = tf::normal(kz, (uint32_t)s);
      const float noise_sec = SIGMA_SEC * (SEC_S0 + SEC_S1X8 * cc_t) * z;
      // renewal: a new cycle only on redraw
      sec = sec + 1.0f;
      if (sec >= total_end) {
        const float ws_t = a.t_ws[S.d * n + ii] * S.one_m_df +
                           a.t_ws[(S.d + 1) * n + ii] * S.df;
        const float u = tf::uniform(ku, (uint32_t)s);
        const float cc = fminf(fmaxf(cc_t, RN_CC_MIN), RN_CC_MAX);
        const float cap_m = RN_MAX_CYCLE * cc * ws_t;
        const float xmax = fmaxf(cap_m, RN_XMAX_FLOOR);
        const float pa = powf(xmax, RN_ONE_M_BETA);
        const float pd = RN_XMIN_POW - pa;
        const float cloud = powf(pa + pd * u, RN_INV_ONE_M_BETA) / ws_t;
        cloud_end = cloud;
        total_end = cloud / cc;
        sec = 1.0f;
      }
      const bool covered = sec < cloud_end;
      float base_v, nmin;
      if (covered) {
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
      const float csi = base_v * (nmin + noise_sec);
      const float ac = power(csi, *P, cos_tilt, albedo);
      const float meter = a.meter_max_w * tf::uniform(km, (uint32_t)s);
      if (EPI == ACC) {
        const float residual = meter - ac;
        const bool valid = S.t < a.duration_s;
        const float vz = valid ? 1.0f : 0.0f;
        pv_sum = pv_sum + ac * vz;
        pv_max = fmaxf(pv_max, valid ? ac : -FLT_MAX);
        meter_sum = meter_sum + meter * vz;
        residual_sum = residual_sum + residual * vz;
        residual_min = fminf(residual_min, valid ? residual : FLT_MAX);
        residual_max = fmaxf(residual_max, valid ? residual : -FLT_MAX);
        n_seconds += valid ? 1 : 0;
      } else if (EPI == TRACE) {
        const int64_t o = (int64_t)(base + s) * n + i;
        a.out_meter[o] = meter;
        a.out_pv[o] = ac;
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
  if (!live) return;
  a.cloud_end[i] = cloud_end;
  a.total_end[i] = total_end;
  a.sec[i] = sec;
  if (EPI == ACC) {
    a.pv_sum[i] = pv_sum;
    a.pv_max[i] = pv_max;
    a.meter_sum[i] = meter_sum;
    a.residual_sum[i] = residual_sum;
    a.residual_min[i] = residual_min;
    a.residual_max[i] = residual_max;
    a.n_seconds[i] = n_seconds;
  }
}

// the series epilogue's second pass: per second, the CTA partials summed
// in CTA index order.  The running sum is a double, rounded once: a float
// running sum over 512 partials would drift by ~1e-6 of the total, while
// the per-CTA partials (a 32-lane butterfly, then 4 warps) err by a few
// float ULP that average out over the CTAs.
__global__ void series_sum_kernel(int n_parts, int T,
                                  const float* __restrict__ part_m,
                                  const float* __restrict__ part_p,
                                  float* meter_sum, float* pv_sum) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  double m = 0.0, p = 0.0;
  for (int c = 0; c < n_parts; ++c) {
    m = m + (double)part_m[(int64_t)c * T + t];
    p = p + (double)part_p[(int64_t)c * T + t];
  }
  meter_sum[t] = (float)m;
  pv_sum[t] = (float)p;
}

// the site mode's geometry on its own (a test entry): out (9, T, n)
__global__ void geometry_kernel(int64_t n, int T, const float* rows_f,
                                const float* lat, const float* lon,
                                const float* alt, const float* tilt,
                                const float* azi, const float* alb,
                                const float* turb, float* out) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const SiteC c = site_consts(lat[i], lon[i], alt[i], tilt[i], azi[i], alb[i]);
  const int64_t plane = (int64_t)T * n;
  for (int s = 0; s < T; ++s) {
    TimeC ts;
    time_terms(ts, rows_f, T, s, turb);
    const Geo g = geometry(ts, c);
    const float f[9] = {g.zenith,    g.cos_zenith, g.app_zen,
                        g.azimuth,   g.csi_cap,    g.ghi_clear,
                        g.dni_extra, g.airmass_abs, g.cos_aoi};
    for (int k = 0; k < 9; ++k) out[k * plane + (int64_t)s * n + i] = f[k];
  }
}

template <int EPI>
static int launch(int per_site, const Args& a, void* stream) {
  if (a.T % TILE) return (int)cudaErrorInvalidValue;
  if (a.n > 0) {
    const unsigned blocks = (unsigned)((a.n + THREADS - 1) / THREADS);
    cudaStream_t st = (cudaStream_t)stream;
    if (per_site)
      block_step_kernel<EPI, true><<<blocks, THREADS, 0, st>>>(a);
    else
      block_step_kernel<EPI, false><<<blocks, THREADS, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

static Args common(int64_t n, int T, int duration_s, float meter_max_w,
                   float cos_tilt, float albedo, const int* rows_i,
                   const float* rows_f, const float* t_cc,
                   const float* t_cloudy, const float* t_cd,
                   const float* t_ws, const float* t_ml, const float* t_mc,
                   const int64_t* k_scan, const int64_t* k_meter,
                   const float* lat, const float* lon, const float* alt,
                   const float* tilt, const float* azi, const float* alb,
                   const float* turb, float* cloud_end, float* total_end,
                   float* sec) {
  Args a = {};
  a.n = n;
  a.T = T;
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
  a.cloud_end = cloud_end;
  a.total_end = total_end;
  a.sec = sec;
  return a;
}

#define COMMON_PARAMS                                                        \
  int per_site, int64_t n, int T, int duration_s, float meter_max_w,         \
      float cos_tilt, float albedo, const int *rows_i, const float *rows_f,  \
      const float *t_cc, const float *t_cloudy, const float *t_cd,           \
      const float *t_ws, const float *t_ml, const float *t_mc,               \
      const int64_t *k_scan, const int64_t *k_meter, const float *lat,       \
      const float *lon, const float *alt, const float *tilt,                 \
      const float *azi, const float *alb, const float *turb,                 \
      float *cloud_end, float *total_end, float *sec
#define COMMON_ARGS                                                          \
  n, T, duration_s, meter_max_w, cos_tilt, albedo, rows_i, rows_f, t_cc,     \
      t_cloudy, t_cd, t_ws, t_ml, t_mc, k_scan, k_meter, lat, lon, alt, tilt, \
      azi, alb, turb, cloud_end, total_end, sec

extern "C" int block_step_acc(COMMON_PARAMS, float* pv_sum, float* pv_max,
                              float* meter_sum, float* residual_sum,
                              float* residual_min, float* residual_max,
                              int* n_seconds, void* stream) {
  Args a = common(COMMON_ARGS);
  a.pv_sum = pv_sum;
  a.pv_max = pv_max;
  a.meter_sum = meter_sum;
  a.residual_sum = residual_sum;
  a.residual_min = residual_min;
  a.residual_max = residual_max;
  a.n_seconds = n_seconds;
  return launch<ACC>(per_site, a, stream);
}

extern "C" int block_step_series(COMMON_PARAMS, float* part_meter,
                                 float* part_pv, void* stream) {
  Args a = common(COMMON_ARGS);
  a.out_meter = part_meter;
  a.out_pv = part_pv;
  return launch<SERIES>(per_site, a, stream);
}

extern "C" int block_step_trace(COMMON_PARAMS, float* meter, float* pv,
                                void* stream) {
  Args a = common(COMMON_ARGS);
  a.out_meter = meter;
  a.out_pv = pv;
  return launch<TRACE>(per_site, a, stream);
}

extern "C" int series_sum(int n_parts, int T, const float* part_meter,
                          const float* part_pv, float* meter_sum,
                          float* pv_sum, void* stream) {
  if (T > 0) {
    const unsigned blocks = (unsigned)((T + 255) / 256);
    series_sum_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
        n_parts, T, part_meter, part_pv, meter_sum, pv_sum);
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
