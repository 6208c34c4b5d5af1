"""tmhpvsim_torch: the PyTorch / CUDA port of tmhpvsim_tpu.

Trace, reduce and ensemble output of a float32, threefry2x32 run, for a
shared site or a per-chain ``SiteGrid``, on an NVIDIA Hopper card through
hand-written kernels (K1 threefry, K2 sampler windows, and the per-second
block step: K3 reduce fold, K4 ensemble series and trace, K6 per-chain
site geometry); every kernel has a plain torch version that runs on CPU
tensors.  Imports torch and numpy, never jax and never tmhpvsim_tpu.
"""

from tmhpvsim_torch.config import (  # noqa: F401
    ModelOptions, SimConfig, Site, SiteGrid)

__all__ = ["ModelOptions", "SimConfig", "Site", "SiteGrid"]
