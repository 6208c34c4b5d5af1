// K15: the metersim producer's block of demand values, one launch per
// block.
//
// Replaces: block_vals of the JAX package's device meter producer
// (tmhpvsim_tpu/apps/metersim.py:84-86), i.e. models/clearsky_index.py:
// 256-275 minute_grouped_keys + meter_block for one root key: second s of
// the block is max_w * uniform(fold_in(root, g0 + g), (60,))[i] with
// g0 = sec0 / 60 and (g, i) = divmod(sec0 - 60 g0 + s, 60), the minute
// index counted from the run's start.  Plain version:
// tmhpvsim_torch/models/clearsky_index.py meter_block.
//
// Keys: jax makes the minute keys under a vmap over the minutes and draws
// the uniforms under a vmap over those keys.  threefry2x32 hashes each
// key and counter on its own.  Under rbg and unsafe_rbg the batched draw
// takes the whole (n_groups, 60) table from the FIRST minute key's stream
// (word 60 g + i), so only fold_in(root, g0) is needed; under unsafe_rbg
// that first key of the batched fold is root ^ row 9 of the seed of g0
// (philox.cuh fold_row with p = 0).
//
// Design: one thread per output second, each recomputing its minute's
// key (threefry: two hashes a thread).  What bounds it: a 600-second
// block is about 1200 threefry hashes (~100k int32 operations) and 2.4 KB
// of stores, nanoseconds of work on an H100, so one launch costs its
// launch latency; the design goal is one launch per block, not speed.
//
// Floating point: -fmad=false (kernels/build.py); the uniform is the
// mantissa trick and one float32 multiply by max_w, as the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "threefry.cuh"

enum Impl { IMPL_THREEFRY = 0, IMPL_RBG = 1, IMPL_URBG = 2 };

template <int IMPL>
__global__ void meter_block_kernel(const int64_t* __restrict__ key,
                                   uint32_t g0, uint32_t off0, int n,
                                   float max_w, float* __restrict__ out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  const uint32_t off = off0 + (uint32_t)s;  // flat index into (G, 60)
  uint32_t b;
  if (IMPL == IMPL_THREEFRY) {
    const tf::Key k = tf::fold_in(tf::load_key(key, 0), g0 + off / 60u);
    b = tf::bits(k, off % 60u);
  } else if (IMPL == IMPL_RBG) {
    const ph::Key4 k0 = ph::fold_in(ph::load_key(key, 0), g0);
    b = ph::word(k0, (uint64_t)off);
  } else {
    const ph::UKey k0 = ph::load_ukey(key, 0) ^ ph::fold_row(g0, 0ull);
    b = ph::word(k0, (uint64_t)off);
  }
  out[s] = max_w * tf::uniform_range(b, 0.0f, 1.0f);
}

extern "C" int meter_block(int impl, const int64_t* key, uint32_t g0,
                           uint32_t off0, int n, float max_w, float* out,
                           void* stream) {
  if (n > 0) {
    const int threads = 128;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    cudaStream_t st = (cudaStream_t)stream;
    switch (impl) {
      case IMPL_THREEFRY:
        meter_block_kernel<IMPL_THREEFRY><<<blocks, threads, 0, st>>>(
            key, g0, off0, n, max_w, out);
        break;
      case IMPL_RBG:
        meter_block_kernel<IMPL_RBG><<<blocks, threads, 0, st>>>(
            key, g0, off0, n, max_w, out);
        break;
      case IMPL_URBG:
        meter_block_kernel<IMPL_URBG><<<blocks, threads, 0, st>>>(
            key, g0, off0, n, max_w, out);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
