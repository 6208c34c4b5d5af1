// K12: the block step (block_step.cuh) under compute_dtype='bf16' for the
// Exact kernel set.  Its own library, so it builds beside the float32 ones.
#define KSET Exact
#define CDTYPE BF16
#include "block_step.cuh"
