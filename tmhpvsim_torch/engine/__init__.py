"""Reduce-mode engine of the torch port."""

from tmhpvsim_torch.engine.simulation import REDUCE_STATS, Simulation  # noqa: F401
