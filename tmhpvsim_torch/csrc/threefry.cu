// K1 standalone: threefry_fill, one thread per output element.
//
// Computes split / fold_in / 32-bit bits / uniform / normal of a batch of
// keys into a caller-allocated buffer.  The engine launches it where the
// JAX package derives keys outside the per-block kernels (init_state:
// split(root, n_chains_total), the per-chain 5-way split, the renewal
// init split and uniforms).  See threefry.cuh for what it replaces and
// what bounds it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

enum Op { OP_SPLIT = 0, OP_FOLD_IN = 1, OP_BITS = 2, OP_UNIFORM = 3,
          OP_NORMAL = 4 };

__global__ void threefry_fill_kernel(int op, const int64_t* __restrict__ keys,
                                     const int64_t* __restrict__ data,
                                     int64_t m, int count, void* out) {
  const int64_t total = op == OP_FOLD_IN ? m : m * (int64_t)count;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = op == OP_FOLD_IN ? idx : idx / count;
    const uint32_t j = op == OP_FOLD_IN ? (uint32_t)data[idx]
                                        : (uint32_t)(idx % count);
    const tf::Key k = tf::load_key(keys, i);
    switch (op) {
      case OP_SPLIT:
      case OP_FOLD_IN: {
        tf::Key o = tf::split_at(k, j);
        int64_t* o64 = (int64_t*)out;
        o64[2 * idx] = o.k0;
        o64[2 * idx + 1] = o.k1;
        break;
      }
      case OP_BITS:
        ((int64_t*)out)[idx] = tf::bits(k, j);
        break;
      case OP_UNIFORM:
        ((float*)out)[idx] = tf::uniform(k, j);
        break;
      case OP_NORMAL:
        ((float*)out)[idx] = tf::normal(k, j);
        break;
    }
  }
}

extern "C" int threefry_fill(int op, const int64_t* keys, const int64_t* data,
                             int64_t m, int count, void* out, void* stream) {
  const int64_t total = op == OP_FOLD_IN ? m : m * (int64_t)count;
  if (total > 0) {
    const int threads = 256;
    int64_t blocks = (total + threads - 1) / threads;
    if (blocks > 65535 * 8) blocks = 65535 * 8;
    threefry_fill_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(op, keys, data, m, count,
                                                   out);
  }
  return (int)cudaGetLastError();
}
