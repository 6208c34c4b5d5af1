// K13: the Philox4x32-10 bits of prng_impl='rbg' keys, as jax draws them on
// the CPU, as __device__ functions that K2 and the block step inline.
//
// Replaces: XLA's RngBitGenerator (algorithm DEFAULT, which XLA's CPU and
// GPU backends expand to Philox4x32-10) behind jax.random.key(seed,
// impl='rbg') (tmhpvsim_tpu/engine/simulation.py:333) at every draw site
// of the JAX package.  Plain version: tmhpvsim_torch/rng.py
// (philox4x32_10, rbg_words, rbg_bits_batched, rbg_bits_per_key).
//
// Layout (read off jax on the CPU): an rbg key is four 32-bit words
// [w0, w1, w2, w3]; its stream's word 4q + j is output word j of
// philox4x32_10(counter = (w2, w3, w0, w1) + q as one 128-bit add, key =
// (w0, w1)); 8- and 16-bit draws take the low bits of the same word.
// split and fold_in hash each 2-word half with threefry (K1's code).
// Under vmap jax draws a whole batch from its first key, so a batched
// draw of chain c is word c (or its offset in a wider block) of ONE key's
// stream: the callers pass that key and the word index.
//
// K14: prng_impl='unsafe_rbg' keys (UKey below) are rbg key data with the
// same bits, but split and fold_in are Philox rows themselves
// (jax/_src/prng.py _unsafe_rbg_split / _unsafe_rbg_fold_in):
// split(k, n)[i] is counter value 10 i of k's stream (the four words of
// row 10 i of a (10 n, 4) draw), fold_in(k, d) is k ^ counter value 9 of
// the stream of _rbg_seed(d) = [0, d, 0, d].  Under vmap these draws take
// their batch's first key too: member p of a batched split(., n) is
// counter 10 (p n + i) of the first key, datum p of a batched fold_in is
// counter 10 p + 9 of the first datum's seed (split_batched / fold_row).
// The gamma's entry split is batched over its keys (threefry.cuh
// gamma_from takes the entered key), its loop per key (UKey's overloads).
// Plain version: tmhpvsim_torch/rng.py (_urbg_split, urbg_fold_rows).
//
// Bound: integer operations.  One Philox call is 10 rounds of two 32-bit
// multiplies (hi and lo halves) and four xors, plus the key bumps, for
// four words; there is no memory traffic beyond the key.
#pragma once
#include <stdint.h>

#include "threefry.cuh"

namespace ph {

struct Key4 {
  uint32_t w0, w1, w2, w3;
};

__device__ __forceinline__ Key4 load_key(const int64_t* p, int64_t i) {
  Key4 k;
  k.w0 = (uint32_t)p[4 * i];
  k.w1 = (uint32_t)p[4 * i + 1];
  k.w2 = (uint32_t)p[4 * i + 2];
  k.w3 = (uint32_t)p[4 * i + 3];
  return k;
}

// split(key, n)[i] and fold_in(key, i): threefry on each half
__device__ __forceinline__ Key4 split_at(Key4 k, uint32_t i) {
  tf::Key a = {k.w0, k.w1}, b = {k.w2, k.w3};
  a = tf::split_at(a, i);
  b = tf::split_at(b, i);
  Key4 o = {a.k0, a.k1, b.k0, b.k1};
  return o;
}
__device__ __forceinline__ Key4 fold_in(Key4 k, uint32_t d) {
  return split_at(k, d);
}

#define PH_M0 0xD2511F53u
#define PH_M1 0xCD9E8D57u
#define PH_W0 0x9E3779B9u
#define PH_W1 0xBB67AE85u

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(PH_M0, c.x), lo0 = PH_M0 * c.x;
    const uint32_t hi1 = __umulhi(PH_M1, c.z), lo1 = PH_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += PH_W0;
    k1 += PH_W1;
  }
  return c;
}

// the four words of counter value q of the key's stream
__device__ __forceinline__ uint4 block(Key4 k, uint64_t q) {
  const uint64_t lo = ((uint64_t)k.w3 << 32 | k.w2) + q;
  const uint64_t hi = ((uint64_t)k.w1 << 32 | k.w0) + (lo < q ? 1u : 0u);
  return philox4x32_10(make_uint4((uint32_t)lo, (uint32_t)(lo >> 32),
                                  (uint32_t)hi, (uint32_t)(hi >> 32)),
                       k.w0, k.w1);
}

__device__ __forceinline__ uint32_t pick(uint4 v, uint32_t j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// word w of the key's stream
__device__ __forceinline__ uint32_t word(Key4 k, uint64_t w) {
  return pick(block(k, w >> 2), (uint32_t)(w & 3));
}

// the unbatched draws of one key (word i of its own stream): what jax's
// gamma, mapped serially over its keys, draws
__device__ __forceinline__ uint32_t bits(Key4 k, uint32_t i) {
  return word(k, i);
}
__device__ __forceinline__ float uniform(Key4 k, uint32_t i) {
  return tf::uniform_range(bits(k, i), 0.0f, 1.0f);
}
__device__ __forceinline__ float normal(Key4 k, uint32_t i) {
  return tf::normal_from_bits(bits(k, i));
}

// ---------------------------------------------------------------- K14
// an unsafe_rbg key: the same four words, its own split / fold_in
struct UKey {
  uint32_t w0, w1, w2, w3;
};

__device__ __forceinline__ Key4 as_rbg(UKey k) {
  Key4 o = {k.w0, k.w1, k.w2, k.w3};
  return o;
}
__device__ __forceinline__ UKey as_urbg(uint4 v) {
  UKey o = {v.x, v.y, v.z, v.w};
  return o;
}
__device__ __forceinline__ UKey load_ukey(const int64_t* p, int64_t i) {
  const Key4 k = load_key(p, i);
  UKey o = {k.w0, k.w1, k.w2, k.w3};
  return o;
}
__device__ __forceinline__ UKey operator^(UKey k, uint4 v) {
  UKey o = {k.w0 ^ v.x, k.w1 ^ v.y, k.w2 ^ v.z, k.w3 ^ v.w};
  return o;
}

// counter value q of the key's stream, as a key
__device__ __forceinline__ UKey row(UKey k, uint64_t q) {
  return as_urbg(block(as_rbg(k), q));
}
// split(key, n)[i], unbatched (per key)
__device__ __forceinline__ UKey split_at(UKey k, uint32_t i) {
  return row(k, 10ull * i);
}
// member p of a batched split(., n): from the batch's first key k0
__device__ __forceinline__ UKey split_batched(UKey k0, uint64_t p,
                                              uint32_t n, uint32_t i) {
  return row(k0, 10ull * (p * n + i));
}
// the row fold_in XORs in: datum p of a batch whose first datum is d0
// (p = 0 for an unbatched datum)
__device__ __forceinline__ uint4 fold_row(uint32_t d0, uint64_t p) {
  const Key4 seed = {0u, d0, 0u, d0};
  return block(seed, 10ull * p + 9ull);
}
__device__ __forceinline__ UKey fold_in(UKey k, uint32_t d) {
  return k ^ fold_row(d, 0ull);
}

__device__ __forceinline__ uint32_t word(UKey k, uint64_t w) {
  return word(as_rbg(k), w);
}
// the unbatched draws of one key, as gamma's serial loop draws them
__device__ __forceinline__ float uniform(UKey k, uint32_t i) {
  return tf::uniform_range(word(k, i), 0.0f, 1.0f);
}
__device__ __forceinline__ float normal(UKey k, uint32_t i) {
  return tf::normal_from_bits(word(k, i));
}

}  // namespace ph
