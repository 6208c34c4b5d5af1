// K1: threefry2x32 as jax.random computes it (jax_threefry_partitionable),
// as __device__ functions that K2 and K3 inline.
//
// Replaces: the XLA-lowered jax.random threefry2x32 hashing of the JAX
// package (split / fold_in / bits / uniform / normal / gamma / t at
// models/clearsky_index.py, models/markov_hourly.py, models/distributions.py,
// models/renewal.py and engine/simulation.py).  Plain version:
// tmhpvsim_torch/rng.py, which these functions follow operation for
// operation.
//
// Bound: integer operations.  One hash is 20 rounds of add / rotate / xor
// plus 5 key injections (~125 int32 operations) and reads nothing but its
// two key words and its counter; there is no memory traffic to speak of.
// Rotations compile to one funnel shift each.
//
// Floating point: the library is built with -fmad=false and IEEE division
// and square root, so every float operation rounds once, in the order the
// plain torch version performs it; fmaf marks the multiply-adds that XLA's
// CPU code contracts.  log and log1p are XLA's CPU polynomials (xla_log,
// xla_log1p), so the draws are jax's on the CPU bit for bit; powf (the
// gamma boost, a < 1) is CUDA's accurate version.  The constants come from
// tmhpvsim_torch/rng.py through the generated consts.cuh.
#pragma once
#include <stdint.h>

#include "consts.cuh"

namespace tf {

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32 block function: (k0, k1) keyed hash of (x0, x1).
__device__ __forceinline__ void hash(Key k, uint32_t x0, uint32_t x1,
                                     uint32_t& y0, uint32_t& y1) {
  const uint32_t ks0 = k.k0, ks1 = k.k1, ks2 = k.k0 ^ k.k1 ^ 0x1BD11BDAu;
#define TF_ROUND(r) { x0 += x1; x1 = rotl(x1, r) ^ x0; }
  x0 += ks0; x1 += ks1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += ks1; x1 += ks2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += ks2; x1 += ks0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += ks0; x1 += ks1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += ks1; x1 += ks2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += ks2; x1 += ks0 + 5u;
#undef TF_ROUND
  y0 = x0; y1 = x1;
}

// split(key, n)[i] and fold_in(key, i): both hash the counter (0, i).
__device__ __forceinline__ Key split_at(Key k, uint32_t i) {
  Key o;
  hash(k, 0u, i, o.k0, o.k1);
  return o;
}
__device__ __forceinline__ Key fold_in(Key k, uint32_t d) {
  return split_at(k, d);
}

// 32-bit random_bits(key, shape) at flattened draw index i.
__device__ __forceinline__ uint32_t bits(Key k, uint32_t i) {
  uint32_t y0, y1;
  hash(k, 0u, i, y0, y1);
  return y0 ^ y1;
}

// [0, 1) from 32 bits: mantissa trick.
__device__ __forceinline__ float unit(uint32_t b) {
  return __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ float uniform_range(uint32_t b, float lo, float hi) {
  float range = hi - lo;
  return fmaxf(lo, unit(b) * range + lo);
}

__device__ __forceinline__ float uniform(Key k, uint32_t i) {
  return uniform_range(bits(k, i), 0.0f, 1.0f);
}

#define TF_INF __int_as_float(0x7F800000)
#define TF_TINY 1.17549435e-38f

// XLA's CPU float32 log: Cephes logf on the mantissa, multiply-adds fused;
// subnormal inputs count as zero.  Plain version: rng.xla_log.
__device__ __forceinline__ float xla_log(float x) {
  const float xc = x > TF_TINY ? x : TF_TINY;
  const int bits = __float_as_int(xc);
  const float m = __int_as_float((bits & 0x007FFFFF) | 0x3F000000);
  float e = (float)((bits >> 23) - 127) + 1.0f;
  const bool low = m < LOG_SQRTHF;
  e = e - (low ? 1.0f : 0.0f);
  const float xm = (m - 1.0f) + (low ? m : 0.0f);
  const float x2 = xm * xm, x3 = x2 * xm;
  float y = fmaf(fmaf(xm, LOG_P[0], LOG_P[1]), xm, LOG_P[2]);
  const float y1 = fmaf(fmaf(xm, LOG_P[3], LOG_P[4]), xm, LOG_P[5]);
  const float y2 = fmaf(fmaf(xm, LOG_P[6], LOG_P[7]), xm, LOG_P[8]);
  y = fmaf(fmaf(y, x3, y1), x3, y2);
  y = fmaf(y, x3, LOG_Q1 * e);
  float r = fmaf(LOG_Q2, e, fmaf(-x2, 0.5f, xm) + y);
  if (fabsf(x) < TF_TINY) r = -TF_INF;
  if (x == TF_INF) r = x;
  if (x < 0.0f || x != x) r = __int_as_float(0x7FC00000);
  return r;
}

// XLA's CPU float32 log1p: rational approximation below sqrt(2) - 1.
__device__ __forceinline__ float xla_log1p(float x) {
  if (!(fabsf(x) < LOG1P_SMALL)) return xla_log(x + 1.0f);
  const float x2 = x * x;
  float q = x + LOG1P_Q[1];
#pragma unroll
  for (int i = 2; i < 7; ++i) q = fmaf(q, x, LOG1P_Q[i]);
  float p = LOG1P_P[0];
#pragma unroll
  for (int i = 1; i < 7; ++i) p = fmaf(p, x, LOG1P_P[i]);
  return x + fmaf(x2, -0.5f, (x * x2) * (p / q));
}

// XLA's float32 erf_inv (the chlo decomposition, multiply-adds fused).
// The two polynomials are branches, not a select per coefficient: w >= 5
// (|x| > 0.9966) is rare, and each multiply-add then reads its constant
// directly.
__device__ __forceinline__ float erfinv(float x) {
  const float w = -xla_log1p(x * -x);
  float p;
  if (w < 5.0f) {
    const float ww = w - 2.5f;
    p = ERFINV_LT5[0];
#pragma unroll
    for (int i = 1; i < 9; ++i) p = fmaf(p, ww, ERFINV_LT5[i]);
  } else {
    const float ww = sqrtf(w) - 3.0f;
    p = ERFINV_GE5[0];
#pragma unroll
    for (int i = 1; i < 9; ++i) p = fmaf(p, ww, ERFINV_GE5[i]);
  }
  return fabsf(x) == 1.0f ? x * TF_INF : p * x;
}

// nextafter(-1, 0) in float32
#define TF_NORMAL_LO (-0.99999994f)
#define TF_SQRT2 1.41421354f

__device__ __forceinline__ float normal_from_bits(uint32_t b) {
  return TF_SQRT2 * erfinv(uniform_range(b, TF_NORMAL_LO, 1.0f));
}

__device__ __forceinline__ float normal(Key k, uint32_t i) {
  return normal_from_bits(bits(k, i));
}

// uniform(key, (), minval=finfo(float32).tiny, maxval=1)
__device__ __forceinline__ float uniform_tiny(Key k) {
  return uniform_range(bits(k, 0u), 1.17549435e-38f, 1.0f);
}

// jax.random.gamma(key, alpha, (), float32): Marsaglia-Tsang with jax's key
// splits (jax._src.random._gamma_one), one draw per key; K is tf::Key or
// (philox.cuh) ph::Key4 or ph::UKey, whose split_at / normal / uniform
// overloads are found by argument-dependent lookup: jax draws a non-
// threefry gamma per key, its lax.map over the keys never batched.
// gamma_from takes the key after _gamma_impl's entry split(key, 1)[0],
// which jax makes under vmap over the flattened keys: per key for
// threefry and rbg (gamma), batched for unsafe_rbg (its callers pass
// ph::split_batched).  Both loops carry
// an iteration cap that only guards the card against a fault: a draw
// accepts with probability > 0.9 per outer iteration and the inner redraw
// repeats with probability < 0.01, so no sample ever reaches the caps.
template <class K>
__device__ inline float gamma_from(K key, float alpha) {
  const bool boost = alpha >= 1.0f;
  const float a = boost ? alpha : alpha + 1.0f;
  const float third = 0.333333343f;  // float32(1/3)
  const float d = a - third;
  const float c = third * (1.0f / sqrtf(d));  // XLA: third * rsqrt(d)
  K subkey = split_at(key, 1u);
  key = split_at(key, 0u);
  float X = 0.0f, V = 1.0f, U = 2.0f;
  for (int outer = 0; outer < 1000 &&
       (U >= fmaf(-0.0331f, X * X, 1.0f)) &&
       (xla_log(U) >= fmaf(X, 0.5f, d * ((1.0f - V) + xla_log(V))));
       ++outer) {
    K nkey = split_at(key, 0u);
    K xk = split_at(key, 1u);
    K uk = split_at(key, 2u);
    key = nkey;
    float x = 0.0f, v = -1.0f;
    for (int inner = 0; inner < 1000 && v <= 0.0f; ++inner) {
      K sub = split_at(xk, 1u);
      xk = split_at(xk, 0u);
      x = normal(sub, 0u);
      v = fmaf(x, c, 1.0f);
    }
    X = x * x;
    V = (v * v) * v;
    U = uniform(uk, 0u);
  }
  float boost_f = 1.0f;
  if (!boost) {
    float samples = 1.0f - uniform(subkey, 0u);
    boost_f = powf(samples, 1.0f / alpha);
  }
  return (d * V) * boost_f;
}

template <class K>
__device__ inline float gamma(K key, float alpha) {
  return gamma_from(split_at(key, 0u), alpha);  // split(key, 1)[0]
}

// jax.random.t(key, df, (), float32)
__device__ __forceinline__ float student_t(Key key, float df) {
  Key kn = split_at(key, 0u), kg = split_at(key, 1u);
  float n = normal(kn, 0u);
  float half_df = df / 2.0f;
  float g = gamma(kg, half_df);
  return n * sqrtf(half_df / g);
}

__device__ __forceinline__ Key load_key(const int64_t* p, int64_t i) {
  Key k;
  k.k0 = (uint32_t)p[2 * i];
  k.k1 = (uint32_t)p[2 * i + 1];
  return k;
}

}  // namespace tf
