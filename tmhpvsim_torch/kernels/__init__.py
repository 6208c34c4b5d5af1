"""Hand-written CUDA kernels of the port and their plain torch versions.

K1 threefry and K13 Philox (kernels/threefry.py: the bits of
``prng_impl='rbg'`` keys), K2 sampler windows (kernels/windows.py, with
K7's weather-regime gather and K13's window draws), and the fused
per-second block step
(kernels/block_step.py): K3 (the reduce fold), K4 (the ensemble series
with its cross-CTA sum, and the trace), K6 (per-chain site geometry), K7
(fleet transforms), K8 (telemetry) and K9 (fleet analytics) with their
chainwise collapse, K10 (the scenario fold of scenario serving) and K6s
(strided site geometry), one template over kernel set, compute dtype
(K12), key implementation (K13), epilogue, geometry mode and observers,
whose Table instantiations inline K11 (the
table transcendentals, also on their own in kernels/tables.py); and the
K4 merges of the wide formulation (kernels/wide.py: the statistics fold
with the wide observer folds, and the per-second series).  Each
wrapper runs its plain version on CPU tensors and its kernel on CUDA
tensors, and counts its launches.
"""

from tmhpvsim_torch.kernels import block_step as _block_step
from tmhpvsim_torch.kernels import tables as _tables
from tmhpvsim_torch.kernels import wide as _wide
from tmhpvsim_torch.kernels.threefry import K1, K13
from tmhpvsim_torch.kernels.windows import K2, K2_RBG, K7_REGIME

#: every kernel's launch counter, in path order
COUNTERS = (K1, K13, K2, K2_RBG, K7_REGIME) + _block_step.COUNTERS \
    + _tables.COUNTERS + _wide.COUNTERS


def reset_counts() -> None:
    """Set every launch counter to 0."""
    for c in COUNTERS:
        c.launches = 0


def counts() -> dict:
    """``{kernel name: launches}`` of every counter."""
    return {c.name: c.launches for c in COUNTERS}
