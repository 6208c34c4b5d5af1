// K13 standalone: philox_fill, one thread per output element; K14
// standalone: philox_derive, unsafe_rbg split and fold_in, one thread per
// output key.
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

// K14: unsafe_rbg split (op 0: out (m, num) keys; batched: every row from
// keys[0] at member row's offset, else each key's own rows) and fold_in
// (op 1: out[r] = keys[r] ^ row 10 pos[r] + 9 of the seed of data[0]).
// The engine launches it where the JAX package derives keys outside the
// per-block kernels (init_state: split(root, n_chains_total), the chains'
// 5-way split, the renewal split).  Replaces: jax.random.split /
// fold_in of unsafe_rbg keys (XLA RngBitGenerator draws,
// tmhpvsim_tpu/engine/simulation.py:333-334, :510, :546).
__global__ void philox_derive_kernel(int op, const int64_t* __restrict__ keys,
                                     int64_t m, int num, int batched,
                                     const int64_t* __restrict__ data,
                                     const int64_t* __restrict__ pos,
                                     int64_t* __restrict__ out) {
  const int64_t total = op == 0 ? m * (int64_t)num : m;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    ph::UKey o;
    if (op == 0) {
      const int64_t r = idx / num;
      const uint32_t i = (uint32_t)(idx % num);
      o = batched ? ph::split_batched(ph::load_ukey(keys, 0), (uint64_t)r,
                                      (uint32_t)num, i)
                  : ph::split_at(ph::load_ukey(keys, r), i);
    } else {
      o = ph::load_ukey(keys, idx) ^
          ph::fold_row((uint32_t)data[0], (uint64_t)pos[idx]);
    }
    out[4 * idx] = o.w0;
    out[4 * idx + 1] = o.w1;
    out[4 * idx + 2] = o.w2;
    out[4 * idx + 3] = o.w3;
  }
}

extern "C" int philox_derive(int op, const int64_t* keys, int64_t m, int num,
                             int batched, const int64_t* data,
                             const int64_t* pos, int64_t* out, void* stream) {
  const int64_t total = op == 0 ? m * (int64_t)num : m;
  if (total > 0) {
    const int threads = 256;
    int64_t blocks = (total + threads - 1) / threads;
    if (blocks > 65535 * 8) blocks = 65535 * 8;
    philox_derive_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(op, keys, m, num, batched,
                                                   data, pos, out);
  }
  return (int)cudaGetLastError();
}
