// The block step (block_step.cuh) for the Table kernel set (K11,
// tables.cuh; Plan.kernel_impl='table').  Its own library, so the two
// sets build in parallel.
#define TMHPVSIM_TABLE_SET
#define KSET Table
#include "block_step.cuh"
