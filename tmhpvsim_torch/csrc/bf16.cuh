// K12: the bfloat16 arithmetic of compute_dtype='bf16', as XLA runs the
// JAX package's graph on the CPU (plain version: tmhpvsim_torch/models/
// bf16.py, which documents the rules this header follows).
//
//   bf  a bf16 value: v, a float bf16 represents exactly, and r, the
//       unrounded float32 result it was rounded from;
//   wk  a weakly typed value (a python float, or a weak float32 array of
//       the JAX graph): float32 against float32, rounded to bf16 against
//       bf16.
//
// A bf16 operation computes in float32 from its operands' bf16 values and
// rounds once, to nearest even (__float2bfloat16_rn).  A bf16 operand of a
// float32 operation contributes r: XLA's algebraic simplifier cancels the
// rounding and the widening under its default xla_allow_excess_precision.
// The operators below resolve each result's type as JAX's promotion does
// (bf16 with bf16 or weak: bf16; anything with float32: float32; weak with
// weak: weak), so the physics is written once, as the JAX source reads, and
// the kernel set decides the rest: Exact's functions keep a bf16 argument's
// type, Table's compute and return float32 (their JAX versions upcast).
// The library is built with -fmad=false, so nothing fuses across a
// rounding.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "nanminmax.cuh"

namespace b16 {

__device__ __forceinline__ float rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct bf {
  float v, r;
};
struct wk {
  float v;
};

// a bf16 operation's result from its float32 value
__device__ __forceinline__ bf mk(float r) { return bf{rn(r), r}; }
// a bf16 buffer's value (already rounded)
__device__ __forceinline__ bf in(float x) { return bf{x, x}; }
// astype(bfloat16) inside the graph
__device__ __forceinline__ bf narrow(float x) { return bf{rn(x), x}; }
// a float32 array narrowed into a bf16 buffer (the engine's narrowed
// geometry: a float32 operation reads it rounded)
__device__ __forceinline__ bf stored(float x) { return in(rn(x)); }
// a python float: its float32 value, converted from the double as JAX
// converts it (write the constant as a double literal)
__device__ __forceinline__ wk K(double c) { return wk{(float)c}; }

// x.astype(float32)
__device__ __forceinline__ float w32(bf a) { return a.r; }
__device__ __forceinline__ float w32(wk a) { return a.v; }
__device__ __forceinline__ float w32(float a) { return a; }

#define B16_BINOP(op)                                                      \
  __device__ __forceinline__ bf operator op(bf a, bf b) {                  \
    return mk(a.v op b.v);                                                 \
  }                                                                        \
  __device__ __forceinline__ bf operator op(bf a, wk b) {                  \
    return mk(a.v op rn(b.v));                                             \
  }                                                                        \
  __device__ __forceinline__ bf operator op(wk a, bf b) {                  \
    return mk(rn(a.v) op b.v);                                             \
  }                                                                        \
  __device__ __forceinline__ float operator op(bf a, float b) {            \
    return a.r op b;                                                       \
  }                                                                        \
  __device__ __forceinline__ float operator op(float a, bf b) {            \
    return a op b.r;                                                       \
  }                                                                        \
  __device__ __forceinline__ float operator op(wk a, float b) {            \
    return a.v op b;                                                       \
  }                                                                        \
  __device__ __forceinline__ float operator op(float a, wk b) {            \
    return a op b.v;                                                       \
  }                                                                        \
  __device__ __forceinline__ wk operator op(wk a, wk b) {                  \
    return wk{a.v op b.v};                                                 \
  }
B16_BINOP(+)
B16_BINOP(-)
B16_BINOP(*)
B16_BINOP(/)
#undef B16_BINOP

// maximum / minimum: of bf16 operands, exact (no rounding to cancel);
// NaN-keeping, as jnp.maximum / jnp.minimum (nanminmax.cuh)
__device__ __forceinline__ bf vmax(bf a, bf b) {
  const float m = nmaxf(a.v, b.v);
  return bf{m, m};
}
__device__ __forceinline__ bf vmax(bf a, wk b) { return vmax(a, in(rn(b.v))); }
__device__ __forceinline__ float vmax(float a, wk b) { return nmaxf(a, b.v); }
__device__ __forceinline__ bf vmin(bf a, bf b) {
  const float m = nminf(a.v, b.v);
  return bf{m, m};
}
// jnp.clip: the bounds take the operand's type
__device__ __forceinline__ bf clip(bf x, wk lo, wk hi) {
  const float c = nclampf(x.v, rn(lo.v), rn(hi.v));
  return bf{c, c};
}
__device__ __forceinline__ bool lt(bf a, wk b) { return a.v < rn(b.v); }

// integer_pow as jax multiplies it
template <class T>
__device__ __forceinline__ T ipow2(T x) {
  return x * x;
}
template <class T>
__device__ __forceinline__ T ipow3(T x) {
  return x * (x * x);
}
template <class T>
__device__ __forceinline__ T ipow4(T x) {
  const T x2 = x * x;
  return x2 * x2;
}
template <class T>
__device__ __forceinline__ T ipow5(T x) {
  const T x2 = x * x;
  return x * (x2 * x2);
}

// the kernel set's functions on the graph's types (KS: block_step.cuh's
// Exact or Table)
template <class KS, bool EXACT>
struct Fns;

template <class KS>
struct Fns<KS, true> {
  static __device__ __forceinline__ bf cos(bf x) { return mk(KS::cos(x.v)); }
  static __device__ __forceinline__ wk cos(wk x) { return wk{KS::cos(x.v)}; }
  // XLA's bf16 arccos is its decomposition, every step rounded
  static __device__ __forceinline__ bf acos(bf x) {
    const bf s = (K(1.0) - x) * (x + K(1.0));
    return mk(atan2f(rn(sqrtf(s.v)), x.v));
  }
  // jnp.power with the exponent in the base's dtype
  static __device__ __forceinline__ bf powc(bf x, wk p) {
    return mk(KS::powc(x.v, rn(p.v)));
  }
};

template <class KS>
struct Fns<KS, false> {
  static __device__ __forceinline__ float cos(bf x) { return KS::cos(x.r); }
  static __device__ __forceinline__ float cos(wk x) { return KS::cos(x.v); }
  static __device__ __forceinline__ float acos(bf x) { return KS::acos(x.r); }
  static __device__ __forceinline__ float powc(bf x, wk p) {
    return KS::powc(x.r, p.v);
  }
};

}  // namespace b16
