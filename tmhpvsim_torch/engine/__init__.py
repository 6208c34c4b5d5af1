"""Engine of the torch port: trace, reduce and ensemble runs."""

from tmhpvsim_torch.engine.simulation import (  # noqa: F401
    REDUCE_STATS, BlockResult, Simulation, write_csv)
