"""Hand-written CUDA kernels of the port and their plain torch versions.

K1 threefry (kernels/threefry.py), K2 sampler windows (kernels/windows.py),
K3 the fused per-second block step (kernels/block_step.py).  Each wrapper
runs its plain version on CPU tensors and its kernel on CUDA tensors, and
counts its launches.
"""

from tmhpvsim_torch.kernels.block_step import K3
from tmhpvsim_torch.kernels.threefry import K1
from tmhpvsim_torch.kernels.windows import K2

#: every kernel's launch counter, in path order
COUNTERS = (K1, K2, K3)


def reset_counts() -> None:
    """Set every launch counter to 0."""
    for c in COUNTERS:
        c.launches = 0
