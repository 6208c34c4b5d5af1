// K11: the table transcendentals, float32 on the card.
//
// Replaces tmhpvsim_tpu/models/tables.py table_kernels (:354): the cephes
// minimax polynomials with Cody-Waite argument reduction (sin, cos, tan,
// atan2), the Hastings arccos (arcsin = pi/2 - arccos), expf by an
// exponent-field 2^k, logf by frexp and an atanh series, pow with a
// constant exponent as exp(p * log(x)), and the Spencer factor as one
// gather from a 366-entry day-of-year table.  Plain version:
// tmhpvsim_torch/models/tables.py (TABLE); the coefficients and the
// table come from it through consts.cuh (TB_*, SPENCER_LUT), as exact
// float32 literals.
//
// Rounding.  The kernels build with -fmad=false, so every multiply and
// add rounds on its own unless written fmaf; the fmaf steps are the ones
// float32 XLA contracts on the CPU (each single-use multiply feeding an
// add), the plain version writes them rng.fma, and the two agree bit for
// bit.  rintf rounds half to even as jnp.round and torch.round do; sqrtf
// and the divisions are IEEE.  A NaN passes the clamps as it does through
// torch.clamp.
//
// Bound: operations.  Per call, counted from the code below (a fmaf 2,
// every other step 1; kernels/tables.py OPS): exp 28, log 40, sin 31,
// cos 32, tan 33, arccos 25, arcsin 26, atan2 35, powc 69; the Spencer
// factor is one constant-cache load, uniform over a CTA (the doy of a
// second is the same for every chain).
#pragma once
#include <cfloat>

#include "nanminmax.cuh"

namespace tbl {


template <int N>
__device__ __forceinline__ float horner(const float (&c)[N], float x) {
  float p = fmaf(c[0], x, c[1]);
#pragma unroll
  for (int k = 2; k < N; ++k) p = fmaf(p, x, c[k]);
  return p;
}

// 2^k for an integral k in [-126, 127], by building the exponent field
__device__ __forceinline__ float exp2i(float k) {
  return __int_as_float(((int)k + 127) << 23);
}

__device__ __forceinline__ float exp(float x) {
  x = nclampf(x, -87.0f, 88.0f);
  const float kf = rintf(x * TB_LOG2E);
  const float r = fmaf(-kf, TB_LN2_LO, fmaf(-kf, TB_LN2_HI, x));
  float p = horner(TB_EXP_P, r);
  p = fmaf(p * r, r, r) + 1.0f;
  return p * exp2i(kf);
}

// jnp.frexp: x = m * 2^e, m in [0.5, 1); subnormals normalised first;
// 0, inf and nan give (x, 0)
__device__ __forceinline__ float frexp_m(float x, int& e) {
  const bool sub = fabsf(x) < FLT_MIN;
  const int x1 = __float_as_int(sub ? x * 8388608.0f : x);
  e = (sub ? -23 : 0) + ((x1 >> 23) & 0xFF) - 126;
  float m = __int_as_float((x1 & ~(0xFF << 23)) | (126 << 23));
  if (isinf(x) || isnan(x) || x == 0.0f) {
    m = x;
    e = 0;
  }
  return m;
}

__device__ __forceinline__ float log(float x) {
  int e;
  float m = frexp_m(x, e);
  const bool lo = m < TB_SQRT_HALF;
  m = lo ? m + m : m;
  const float ef = (float)(lo ? e - 1 : e);
  const float f = m - 1.0f;
  const float s = f / (f + 2.0f);
  const float z = s * s;
  const float w = horner(TB_LOG_W, z);
  return fmaf(ef, TB_LN2_LO, fmaf(s, fmaf(z * 2.0f, w, 2.0f), ef * TB_LN2_HI));
}

// the quadrant reduction: x = q * pi/2 + r, |r| <= pi/4
__device__ __forceinline__ float reduce(float x, int& q) {
  const float nf = rintf(x * TB_TWO_OVER_PI);
  q = (int)nf & 3;
  return fmaf(-nf, TB_PI2_LO, fmaf(-nf, TB_PI2_MID, fmaf(-nf, TB_PI2_HI, x)));
}

__device__ __forceinline__ float sin_poly(float r, float z) {
  return fmaf(horner(TB_SIN_W, z) * z, r, r);
}

__device__ __forceinline__ float cos_poly(float z) {
  return fmaf(horner(TB_COS_W, z) * z, z, -(z * 0.5f)) + 1.0f;
}

__device__ __forceinline__ float sin(float x) {
  int q;
  const float r = reduce(x, q), z = r * r;
  const float v = (q & 1) == 0 ? sin_poly(r, z) : cos_poly(z);
  return q >= 2 ? -v : v;
}

__device__ __forceinline__ float cos(float x) {
  int q;
  const float r = reduce(x, q), z = r * r;
  const float v = (q & 1) == 0 ? cos_poly(z) : sin_poly(r, z);
  return ((q + 1) & 3) >= 2 ? -v : v;
}

__device__ __forceinline__ float tan(float x) {
  int q;
  const float r = reduce(x, q), z = r * r;
  const float sp = sin_poly(r, z), cp = cos_poly(z);
  const bool even = (q & 1) == 0;
  return (even ? sp : cp) / (even ? cp : -sp);
}

__device__ __forceinline__ float acos(float x) {
  x = nclampf(x, -1.0f, 1.0f);
  const float a = fabsf(x);
  const float v = sqrtf(1.0f - a) * horner(TB_ACOS_P, a);
  return x < 0.0f ? TB_PI - v : v;
}

__device__ __forceinline__ float asin(float x) { return TB_HALF_PI - acos(x); }

__device__ __forceinline__ float atan2(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float mx = nmaxf(ax, ay), mn = nminf(ax, ay);
  const float t = mn / nmaxf(mx, TB_ATAN_TINY);
  const bool big = t > TB_TAN_PI8;
  const float u = big ? (t - 1.0f) / (t + 1.0f) : t;
  const float z = u * u;
  float a = fmaf(horner(TB_ATAN_W, z) * z, u, u);
  a = big ? a + TB_QUARTER_PI : a;
  a = ay > ax ? TB_HALF_PI - a : a;
  a = x < 0.0f ? TB_PI - a : a;
  a = y < 0.0f ? -a : a;
  return mx == 0.0f ? a * 0.0f : a;
}

// x^p for positive x and a constant p
__device__ __forceinline__ float powc(float x, float p) {
  return exp(log(x) * p);
}

// the Spencer factor at the integral day of year
__device__ __forceinline__ float spencer(float doy) {
  return SPENCER_LUT[min(max((int)doy - 1, 0), 365)];
}

}  // namespace tbl
