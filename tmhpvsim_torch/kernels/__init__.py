"""Hand-written CUDA kernels of the port and their plain torch versions.

K1 threefry (kernels/threefry.py), K2 sampler windows (kernels/windows.py),
and the fused per-second block step (kernels/block_step.py): K3 (the
reduce fold), K4 (the ensemble series with its cross-CTA sum, and the
trace) and K6 (per-chain site geometry), one template over epilogue and
geometry mode.  Each wrapper runs its plain version on CPU tensors and its
kernel on CUDA tensors, and counts its launches.
"""

from tmhpvsim_torch.kernels import block_step as _block_step
from tmhpvsim_torch.kernels.threefry import K1
from tmhpvsim_torch.kernels.windows import K2

#: every kernel's launch counter, in path order
COUNTERS = (K1, K2) + _block_step.COUNTERS


def reset_counts() -> None:
    """Set every launch counter to 0."""
    for c in COUNTERS:
        c.launches = 0


def counts() -> dict:
    """``{kernel name: launches}`` of every counter."""
    return {c.name: c.launches for c in COUNTERS}
