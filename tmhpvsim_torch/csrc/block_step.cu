// The block step (block_step.cuh) for the Exact kernel set: CUDA's
// accurate libm in every transcendental (Plan.kernel_impl='exact').
#define KSET Exact
#include "block_step.cuh"
