// K11 on its own: one table transcendental (tables.cuh) over a float32
// array, elementwise, one thread per element.  A check entry: the block
// step inlines the same device functions (block_step_table.cu); this one
// lets a caller hold each function against its plain version
// (tmhpvsim_torch/models/tables.py) on many arguments.
//
// Bound: operations (tables.cuh gives each function's count); the
// Spencer gather is bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "consts.cuh"
#include "tables.cuh"

// the functions, in kernels/tables.py FUNCS order
enum Fn { F_SIN = 0, F_COS, F_TAN, F_ASIN, F_ACOS, F_ATAN2, F_EXP, F_LOG,
          F_POWC, F_SPENCER, N_FN };

template <int FN>
__global__ void table_kernel(int64_t n, const float* __restrict__ x,
                             const float* __restrict__ y, float p,
                             float* __restrict__ out) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = x[i];
  float r;
  if constexpr (FN == F_SIN) r = tbl::sin(v);
  else if constexpr (FN == F_COS) r = tbl::cos(v);
  else if constexpr (FN == F_TAN) r = tbl::tan(v);
  else if constexpr (FN == F_ASIN) r = tbl::asin(v);
  else if constexpr (FN == F_ACOS) r = tbl::acos(v);
  else if constexpr (FN == F_ATAN2) r = tbl::atan2(v, y[i]);
  else if constexpr (FN == F_EXP) r = tbl::exp(v);
  else if constexpr (FN == F_LOG) r = tbl::log(v);
  else if constexpr (FN == F_POWC) r = tbl::powc(v, p);
  else r = tbl::spencer(v);
  out[i] = r;
}

// out[i] = fn(x[i]) (atan2: fn(x[i], y[i]); powc: fn(x[i], p))
extern "C" int table_eval(int fn, int64_t n, const float* x, const float* y,
                          float p, float* out, void* stream) {
  if (fn < 0 || fn >= N_FN) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((n + 255) / 256);
  cudaStream_t st = (cudaStream_t)stream;
  switch (fn) {
    case F_SIN: table_kernel<F_SIN><<<blocks, 256, 0, st>>>(n, x, y, p, out); break;
    case F_COS: table_kernel<F_COS><<<blocks, 256, 0, st>>>(n, x, y, p, out); break;
    case F_TAN: table_kernel<F_TAN><<<blocks, 256, 0, st>>>(n, x, y, p, out); break;
    case F_ASIN: table_kernel<F_ASIN><<<blocks, 256, 0, st>>>(n, x, y, p, out); break;
    case F_ACOS: table_kernel<F_ACOS><<<blocks, 256, 0, st>>>(n, x, y, p, out); break;
    case F_ATAN2: table_kernel<F_ATAN2><<<blocks, 256, 0, st>>>(n, x, y, p, out); break;
    case F_EXP: table_kernel<F_EXP><<<blocks, 256, 0, st>>>(n, x, y, p, out); break;
    case F_LOG: table_kernel<F_LOG><<<blocks, 256, 0, st>>>(n, x, y, p, out); break;
    case F_POWC: table_kernel<F_POWC><<<blocks, 256, 0, st>>>(n, x, y, p, out); break;
    default: table_kernel<F_SPENCER><<<blocks, 256, 0, st>>>(n, x, y, p, out); break;
  }
  return (int)cudaGetLastError();
}
