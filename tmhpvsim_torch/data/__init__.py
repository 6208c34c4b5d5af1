"""Vendored numeric data for the torch port.

``SAPM_MODULE`` / ``SANDIA_INVERTER`` default to the vendored nominal
coefficient sets (parameters.py) and are replaced wholesale at import time
by exact SAM database rows when the ``TMHPVSIM_SAM_MODULES`` /
``TMHPVSIM_SAM_INVERTERS`` variables point at the library CSVs (data/sam.py),
as the JAX package's data/__init__.py does.  The kernels read these
coefficients from the generated ``consts.cuh``, whose digest keys the build
cache (kernels/build.py), so an override reaches the card too.
"""

from tmhpvsim_torch.data.parameters import (  # noqa: F401
    LINKE_TURBIDITY_MONTHLY_MUNICH,
    MARKOV_STEP_BINS,
    MARKOV_STEP_PARAMS,
    MARKOV_STEP_PARAMS_REGIMES,
    SANDIA_INVERTER,
    SAPM_MODULE,
)
from tmhpvsim_torch.data.sam import env_overrides as _env_overrides

# A bad override file must fail loudly at import, never half-load: silently
# continuing on nominal coefficients would simulate other hardware than
# the JAX package does under the same variables.
_sam_module, _sam_inverter = _env_overrides()
if _sam_module is not None:
    SAPM_MODULE = _sam_module
if _sam_inverter is not None:
    SANDIA_INVERTER = _sam_inverter
del _sam_module, _sam_inverter
