"""Chain-sharded runs over ``torch.distributed`` (one process per card):
``ShardedSimulation`` and the collectives of parallel/distributed.py."""

from tmhpvsim_torch.parallel.mesh import ShardedSimulation  # noqa: F401

__all__ = ["ShardedSimulation"]
