// K13: the block step (block_step.cuh) under prng_impl='rbg' (Philox
// draws, philox.cuh) for the Exact kernel set.
// Its own library, so it builds beside the threefry ones.
#define KSET Exact
#define PRNG RBG
#include "block_step.cuh"
