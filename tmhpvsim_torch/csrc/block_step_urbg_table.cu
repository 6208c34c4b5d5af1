// K14: the block step (block_step.cuh) under prng_impl='unsafe_rbg' (Philox
// draws and key derivations, philox.cuh) for the Table kernel set.
// Its own library, so it builds beside the threefry and rbg ones.
#define TMHPVSIM_TABLE_SET
#define KSET Table
#define PRNG URBG
#include "block_step.cuh"
