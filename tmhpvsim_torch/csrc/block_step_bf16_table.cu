// K12: the block step (block_step.cuh) under compute_dtype='bf16' for the
// Table kernel set (K11, tables.cuh).  Its own library, so it builds beside
// the float32 ones.
#define TMHPVSIM_TABLE_SET
#define KSET Table
#define CDTYPE BF16
#include "block_step.cuh"
