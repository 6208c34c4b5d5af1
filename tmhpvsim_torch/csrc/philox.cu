// K13 standalone: philox_fill, one thread per output element.
//
// The 32-bit words, uniforms or normals of rbg keys (csrc/philox.cuh),
// either per key (each key row its own stream, words word0 + j) or as jax
// draws a vmapped batch (every element from the FIRST key, flat word
// word0 + element index).  The engine launches it where the JAX package
// draws outside the per-block kernels (init_state's renewal uniforms).
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

enum Op { OP_BITS = 0, OP_UNIFORM = 1, OP_NORMAL = 2 };

__global__ void philox_fill_kernel(int op, const int64_t* __restrict__ keys,
                                   int64_t total, int count, int per_key,
                                   int64_t word0, void* out) {
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = per_key ? idx / count : 0;
    const uint64_t w = (uint64_t)word0 + (uint64_t)(per_key ? idx % count
                                                            : idx);
    const uint32_t b = ph::word(ph::load_key(keys, row), w);
    switch (op) {
      case OP_BITS:
        ((int64_t*)out)[idx] = b;
        break;
      case OP_UNIFORM:
        ((float*)out)[idx] = tf::uniform_range(b, 0.0f, 1.0f);
        break;
      default:
        ((float*)out)[idx] = tf::normal_from_bits(b);
        break;
    }
  }
}

extern "C" int philox_fill(int op, const int64_t* keys, int64_t m, int count,
                           int per_key, int64_t word0, void* out,
                           void* stream) {
  const int64_t total = m * (int64_t)count;
  if (total > 0) {
    const int threads = 256;
    int64_t blocks = (total + threads - 1) / threads;
    if (blocks > 65535 * 8) blocks = 65535 * 8;
    philox_fill_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(op, keys, total, count,
                                                 per_key, word0, out);
  }
  return (int)cudaGetLastError();
}
