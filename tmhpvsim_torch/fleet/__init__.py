"""Heterogeneous fleets: per-site parameters on the chain axis."""

from tmhpvsim_torch.fleet.params import (  # noqa: F401
    COLUMN_RANGES, NO_AC_LIMIT, N_REGIMES, FleetParams, check_range,
    slice_fleet)
