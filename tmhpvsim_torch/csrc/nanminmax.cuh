// NaN-keeping float32 minimum, maximum and clamp, for every kernel.
//
// jnp.minimum, jnp.maximum and jnp.clip return NaN when an operand is NaN,
// and so do the plain versions' torch.minimum, torch.maximum and
// torch.clamp (clamp_min, clamp_max).  CUDA's fminf / fmaxf return the
// other operand instead, so a NaN meter or knob would vanish from an
// extremum or a clamp in a kernel while it stays in the reference.
//
// PTX min.NaN.f32 / max.NaN.f32 (sm_80 and later) return NaN when either
// operand is NaN and are otherwise min.f32 / max.f32, the instruction that
// fminf / fmaxf compile to: one instruction each, as before.  torch's CUDA
// minimum, maximum and clamp test for a NaN operand first and otherwise
// call ::min / ::max, which are fminf / fmaxf, so on operands that are not
// NaN both give the same bits, -0.0 against +0.0 included (min.f32 and
// max.f32 order -0.0 below +0.0: the minimum is -0.0 and the maximum +0.0
// in either operand order).  The one difference is the payload of a NaN
// result: PTX gives the canonical NaN, torch the NaN operand, so a check
// that expects NaNs compares them NaN-aware, not bit for bit.
//
// nclampf(x, lo, hi) is nminf(nmaxf(x, lo), hi): jnp.clip and torch.clamp
// in the order both evaluate it.
#pragma once
#include <cuda_runtime.h>

__device__ __forceinline__ float nminf(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float nmaxf(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float nclampf(float x, float lo, float hi) {
  return nminf(nmaxf(x, lo), hi);
}
