"""Engine of the torch port: trace, reduce and ensemble runs, their
checkpoints (``checkpoint``) and chain slabs (``slab``)."""

from tmhpvsim_torch.engine.simulation import (  # noqa: F401
    REDUCE_STATS, BlockResult, Simulation, write_csv)
