"""tmhpvsim_torch: the PyTorch / CUDA port of tmhpvsim_tpu.

Reduce mode of a shared-site, float32, threefry2x32 run on an NVIDIA
Hopper card, through three hand-written kernels (K1 threefry, K2 sampler
windows, K3 the fused per-second step); every kernel has a plain torch
version that runs on CPU tensors.  Imports torch and numpy, never jax and
never tmhpvsim_tpu.
"""

from tmhpvsim_torch.config import ModelOptions, SimConfig, Site  # noqa: F401

__all__ = ["ModelOptions", "SimConfig", "Site"]
