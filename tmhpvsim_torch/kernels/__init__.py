"""Hand-written CUDA kernels of the port and their plain torch versions.

K1 threefry, K13 Philox and K14 (kernels/threefry.py: the bits of
``prng_impl='rbg'`` and ``'unsafe_rbg'`` keys, and unsafe_rbg's Philox key
derivations), K2 sampler windows (kernels/windows.py, with K7's
weather-regime gather and K13's and K14's windows), and the fused
per-second block step
(kernels/block_step.py): K3 (the reduce fold), K4 (the ensemble series
with its cross-CTA sum, and the trace), K6 (per-chain site geometry), K7
(fleet transforms), K8 (telemetry; with K9 on, in the observer fold)
and K9 (fleet analytics: the acc producer, then the observer fold of
csrc/wide_fold.cu) with their chainwise collapse, K10 (the scenario fold
of scenario serving) and K6s
(strided site geometry), one template over kernel set, compute dtype
(K12), key implementation (K13, K14), epilogue, geometry mode and observers,
whose Table instantiations inline K11 (the
table transcendentals, also on their own in kernels/tables.py); and the
K4 merges of the wide formulation (kernels/wide.py: the statistics fold
with the wide observer folds, and the per-second series); and K15, the
metersim producer's block of demand values (kernels/meter.py).  Each
wrapper runs its plain version on CPU tensors and its kernel on CUDA
tensors, and counts its launches.
"""

from tmhpvsim_torch.kernels import block_step as _block_step
from tmhpvsim_torch.kernels import meter as _meter
from tmhpvsim_torch.kernels import tables as _tables
from tmhpvsim_torch.kernels import wide as _wide
from tmhpvsim_torch.kernels.threefry import K1, K13, K14
from tmhpvsim_torch.kernels.windows import K2, K2_RBG, K2_URBG, K7_REGIME

#: every kernel's launch counter, in path order
COUNTERS = (K1, K13, K14, K2, K2_RBG, K2_URBG, K7_REGIME) \
    + _block_step.COUNTERS \
    + _tables.COUNTERS + _wide.COUNTERS + (_meter.K15,)


def reset_counts() -> None:
    """Set every launch counter to 0."""
    for c in COUNTERS:
        c.launches = 0


def counts() -> dict:
    """``{kernel name: launches}`` of every counter."""
    return {c.name: c.launches for c in COUNTERS}
