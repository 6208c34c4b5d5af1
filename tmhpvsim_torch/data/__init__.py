"""Vendored numeric data for the torch port (no file or environment IO)."""

from tmhpvsim_torch.data.parameters import (  # noqa: F401
    LINKE_TURBIDITY_MONTHLY_MUNICH,
    MARKOV_STEP_BINS,
    MARKOV_STEP_PARAMS,
    MARKOV_STEP_PARAMS_REGIMES,
    SANDIA_INVERTER,
    SAPM_MODULE,
)
