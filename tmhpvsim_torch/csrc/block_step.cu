// K3: one reduce-mode block, one thread per chain, looping over the block's
// seconds.
//
// Replaces: Simulation._block_step_scan_acc (tmhpvsim_tpu/engine/
// simulation.py:1276), i.e. _scan_block_setup.step (:1190-1242) plus
// _make_acc_body (:1246-1272), and the pre-drawn streams of
// clearsky_index.scan_draws_tmajor / meter_block_tmajor (:278-319).  Plain
// version: tmhpvsim_torch/kernels/block_step.py block_step_plain.
//
// Design.  The renewal carry and the seven statistics stay in registers for
// the whole block; nothing per second is written to memory.  The JAX scan
// path materialises three (T, n) random streams; here each chain derives
// its per-minute keys fold_in(fold_in(k_scan, g), 0 | 1) and
// fold_in(k_meter, g) in registers and hashes counter slot s % 60 as the
// second comes.  The cycle uniform is drawn only on a renewal redraw, the
// only second that consumes it (same value as the always-drawn stream).
// The shared per-second rows (calendar indices and fractions, the
// block_geometry fields) are the same for every chain: each 60-second tile
// is staged in shared memory, and the tile's csi-independent physics terms
// (Spencer, DISC airmass and knc, the SAPM spectral and angle-of-incidence
// polynomials, the Hay-Davies beam ratio) are computed there once per
// second by the first 60 threads, instead of once per chain.  Sums fold in
// second order, chain by chain, as the scan adds them.
//
// Bound: operations.  Per site-second about three 20-round threefry hashes
// (z, meter, and u on redraw), XLA's erfinv and log1p polynomials, and
// accurate expf and logf (plus powf x2 on a redraw); it reads
// the window tables (a few floats per chain per second, mostly cached) and
// writes 10 values per chain per block.  Bytes are negligible next to the
// arithmetic.
#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

#include "consts.cuh"
#include "threefry.cuh"

#define TILE 60
#define THREADS 128

// csi-independent terms of one second, shared by every chain
struct Second {
  int t, h, d, m;
  float one_m_hf, hf, one_m_df, df, one_m_mf, mf;
  float csi_cap, ghi_clear, cos_zenith, dni_extra, cos_aoi;
  float i0, i0h, am, knc, rb, f1, f2;
  int zen_ok;
};

enum RowF { HF = 0, DF, MF, ZENITH, COS_ZENITH, APP_ZENITH, AZIMUTH, CSI_CAP,
            GHI_CLEAR, DNI_EXTRA, AIRMASS_ABS, COS_AOI, DOY };

__device__ __forceinline__ void second_terms(Second& S, const int* rows_i,
                                             const float* rows_f, int T,
                                             int s) {
  S.t = rows_i[s];
  S.h = rows_i[T + s];
  S.d = rows_i[2 * T + s];
  S.m = rows_i[3 * T + s];
  const float* r = rows_f;
  S.hf = r[HF * T + s];
  S.df = r[DF * T + s];
  S.mf = r[MF * T + s];
  S.one_m_hf = 1.0f - S.hf;
  S.one_m_df = 1.0f - S.df;
  S.one_m_mf = 1.0f - S.mf;
  const float zen = r[ZENITH * T + s];
  const float doy = r[DOY * T + s];
  const float cos_aoi = r[COS_AOI * T + s];
  S.csi_cap = r[CSI_CAP * T + s];
  S.ghi_clear = r[GHI_CLEAR * T + s];
  S.cos_zenith = r[COS_ZENITH * T + s];
  S.dni_extra = r[DNI_EXTRA * T + s];
  S.cos_aoi = cos_aoi;
  // Spencer extraterrestrial irradiance at the DISC constant
  const float b = PV_TWO_PI * (doy - 1.0f) / 365.0f;
  const float factor = 1.00011f + 0.034221f * cosf(b) + 0.00128f * sinf(b) +
                       0.000719f * cosf(2.0f * b) + 7.7e-5f * sinf(2.0f * b);
  S.i0 = 1370.0f * factor;
  S.i0h = S.i0 * fmaxf(cosf(zen), 0.065f);
  // Kasten 1966 airmass and the DISC knc polynomial
  const float z_deg = fminf(fmaxf(zen / PV_DEG, 0.0f), 93.0f);
  const float am = 1.0f / (cosf(z_deg * PV_DEG) +
                           0.15f * powf(93.885f - z_deg, -1.253f));
  const float am2 = am * am;
  S.am = am;
  S.knc = 0.866f - 0.122f * am + 0.0121f * am * am - 0.000653f * (am * am2) +
          1.4e-5f * (am2 * am2);
  S.zen_ok = zen < PV_ZEN_MAX;
  S.rb = fmaxf(cos_aoi, 0.0f) / fmaxf(cosf(r[APP_ZENITH * T + s]), 0.01745f);
  // SAPM spectral (airmass) and angle-of-incidence polynomials
  const float ama = r[AIRMASS_ABS * T + s];
  const float ama2 = ama * ama;
  S.f1 = MA[0] + MA[1] * ama + MA[2] * ama2 + MA[3] * (ama * ama2) +
         MA[4] * (ama2 * ama2);
  const float aoi = acosf(fminf(fmaxf(cos_aoi, -1.0f), 1.0f)) / PV_DEG;
  const float aoi2 = aoi * aoi, aoi4 = aoi2 * aoi2;
  const float f2 = MB[0] + MB[1] * aoi + MB[2] * aoi2 + MB[3] * (aoi * aoi2) +
                   MB[4] * aoi4 + MB[5] * (aoi * aoi4);
  S.f2 = fmaxf(f2, 0.0f);
}

// pv.power_from_terms for one chain-second
__device__ __forceinline__ float power(float csi, const Second& S,
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

__global__ void __launch_bounds__(THREADS) block_step_kernel(
    int64_t n, int T, int duration_s, float meter_max_w,
    float cos_tilt, float albedo, const int* __restrict__ rows_i,
    const float* __restrict__ rows_f, const float* __restrict__ t_cc,
    const float* __restrict__ t_cloudy, const float* __restrict__ t_cd,
    const float* __restrict__ t_ws, const float* __restrict__ t_ml,
    const float* __restrict__ t_mc, const int64_t* __restrict__ k_scan,
    const int64_t* __restrict__ k_meter, float* cloud_end_p,
    float* total_end_p, float* sec_p, float* pv_sum_p, float* pv_max_p,
    float* meter_sum_p, float* residual_sum_p, float* residual_min_p,
    float* residual_max_p, int* n_seconds_p) {
  __shared__ Second tile[TILE];
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const bool live = i < n;
  const int64_t ii = live ? i : 0;

  float cloud_end = cloud_end_p[ii], total_end = total_end_p[ii],
        sec = sec_p[ii];
  float pv_sum = pv_sum_p[ii], pv_max = pv_max_p[ii],
        meter_sum = meter_sum_p[ii], residual_sum = residual_sum_p[ii],
        residual_min = residual_min_p[ii], residual_max = residual_max_p[ii];
  int n_seconds = n_seconds_p[ii];
  const tf::Key ks = tf::load_key(k_scan, ii), km0 = tf::load_key(k_meter, ii);

  for (int base = 0; base < T; base += TILE) {
    __syncthreads();
    if (threadIdx.x < TILE)
      second_terms(tile[threadIdx.x], rows_i, rows_f, T, base + threadIdx.x);
    __syncthreads();
    if (!live) continue;
    // blocks are minute-aligned: the tile is global minute t / 60
    const uint32_t g = (uint32_t)(tile[0].t / 60);
    const tf::Key kg = tf::fold_in(ks, g);
    const tf::Key ku = tf::fold_in(kg, 0u), kz = tf::fold_in(kg, 1u);
    const tf::Key km = tf::fold_in(km0, g);
    for (int s = 0; s < TILE; ++s) {
      const Second& S = tile[s];
      // sampler lerps (value-major tables)
      const float cc_t = t_cc[S.h * n + i] * S.one_m_hf +
                         t_cc[(S.h + 1) * n + i] * S.hf;
      const float z = tf::normal(kz, (uint32_t)s);
      const float noise_sec = SIGMA_SEC * (SEC_S0 + SEC_S1X8 * cc_t) * z;
      // renewal: a new cycle only on redraw
      sec = sec + 1.0f;
      if (sec >= total_end) {
        const float ws_t = t_ws[S.d * n + i] * S.one_m_df +
                           t_ws[(S.d + 1) * n + i] * S.df;
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
        base_v = t_cd[cd * n + i] * S.one_m_df + t_cd[(cd + 1) * n + i] * S.df;
        nmin = t_ml[S.m * n + i] * S.one_m_mf + t_ml[(S.m + 1) * n + i] * S.mf;
      } else {
        base_v = t_cloudy[S.h * n + i] * S.one_m_hf +
                 t_cloudy[(S.h + 1) * n + i] * S.hf;
        nmin = t_mc[S.m * n + i] * S.one_m_mf + t_mc[(S.m + 1) * n + i] * S.mf;
      }
      const float csi = base_v * (nmin + noise_sec);
      const float ac = power(csi, S, cos_tilt, albedo);
      const float meter = meter_max_w * tf::uniform(km, (uint32_t)s);
      const float residual = meter - ac;
      const bool valid = S.t < duration_s;
      const float vz = valid ? 1.0f : 0.0f;
      pv_sum = pv_sum + ac * vz;
      pv_max = fmaxf(pv_max, valid ? ac : -FLT_MAX);
      meter_sum = meter_sum + meter * vz;
      residual_sum = residual_sum + residual * vz;
      residual_min = fminf(residual_min, valid ? residual : FLT_MAX);
      residual_max = fmaxf(residual_max, valid ? residual : -FLT_MAX);
      n_seconds += valid ? 1 : 0;
    }
  }
  if (!live) return;
  cloud_end_p[i] = cloud_end;
  total_end_p[i] = total_end;
  sec_p[i] = sec;
  pv_sum_p[i] = pv_sum;
  pv_max_p[i] = pv_max;
  meter_sum_p[i] = meter_sum;
  residual_sum_p[i] = residual_sum;
  residual_min_p[i] = residual_min;
  residual_max_p[i] = residual_max;
  n_seconds_p[i] = n_seconds;
}

extern "C" int block_step(int64_t n, int T, int duration_s,
                          float meter_max_w, float cos_tilt, float albedo,
                          const int* rows_i, const float* rows_f,
                          const float* t_cc, const float* t_cloudy,
                          const float* t_cd, const float* t_ws,
                          const float* t_ml, const float* t_mc,
                          const int64_t* k_scan, const int64_t* k_meter,
                          float* cloud_end, float* total_end, float* sec,
                          float* pv_sum, float* pv_max, float* meter_sum,
                          float* residual_sum, float* residual_min,
                          float* residual_max, int* n_seconds, void* stream) {
  if (T % TILE) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    block_step_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        n, T, duration_s, meter_max_w, cos_tilt, albedo, rows_i, rows_f,
        t_cc, t_cloudy, t_cd, t_ws, t_ml, t_mc, k_scan, k_meter, cloud_end,
        total_end, sec, pv_sum, pv_max, meter_sum, residual_sum, residual_min,
        residual_max, n_seconds);
  }
  return (int)cudaGetLastError();
}
