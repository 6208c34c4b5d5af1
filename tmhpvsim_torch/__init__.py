"""tmhpvsim_torch: the PyTorch / CUDA port of tmhpvsim_tpu.

Trace, reduce and ensemble output of a float32, threefry2x32 run, for a
shared site, a per-chain ``SiteGrid`` or a heterogeneous ``FleetParams``
fleet, with reduce-mode telemetry and fleet-risk analytics, on an NVIDIA
Hopper card through hand-written kernels (K1 threefry, K2 sampler windows
with the K7 regime gather, and the per-second block step: K3 reduce fold,
K4 ensemble series and trace, K6 per-chain site geometry, K7 fleet
transforms, K8 telemetry, K9 analytics, K10 the scenario fold behind
scenario serving, ``tmhpvsim_torch.serve``), and the reference's
streaming deployment (``metersim`` with K15, the metersim producer's
block, ``fanoutbroker`` and ``pvsim --backend asyncio``,
``tmhpvsim_torch.apps`` and ``tmhpvsim_torch.runtime``), and
chain-sharded runs over ``torch.distributed``, one process per card
(``tmhpvsim_torch.parallel.ShardedSimulation``, ``pvsim --sharded``),
preemption-safe checkpoints in the JAX package's format
(``tmhpvsim_torch.engine.checkpoint``, ``pvsim --checkpoint``) and chain
slabs (``tmhpvsim_torch.engine.slab``); every kernel has a plain torch
version that runs on CPU tensors.
Imports torch and numpy, never jax and never tmhpvsim_tpu.
"""

from tmhpvsim_torch.config import (  # noqa: F401
    ModelOptions, SimConfig, Site, SiteGrid)

__all__ = ["ModelOptions", "SimConfig", "Site", "SiteGrid"]
