"""Configuration of a port run (own copy of tmhpvsim_tpu/config.py).

``Site``, ``ModelOptions`` and ``SimConfig`` carry the JAX package's field
names and defaults, so the same keyword arguments describe the same run in
both packages.  The port implements one slice of that space — a shared
site, float32, threefry2x32, exact transcendentals, the scan formulation,
reduce mode — and every field outside it raises ``NotImplementedError``
when it is set to anything but its default (or a value that means the same
run).  Nothing is silently ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from tmhpvsim_torch.data import LINKE_TURBIDITY_MONTHLY_MUNICH


@dataclasses.dataclass(frozen=True)
class Site:
    """A PV plant site; defaults are the reference's Munich rooftop
    (Hanwha 250 W module + ABB micro-inverter, tilt = latitude, south)."""

    latitude: float = 48.12
    longitude: float = 11.60
    altitude: float = 34.0
    surface_tilt: float = 48.12
    surface_azimuth: float = 180.0     # south
    albedo: float = 0.25
    timezone: str = "Europe/Berlin"
    linke_turbidity_monthly: tuple = LINKE_TURBIDITY_MONTHLY_MUNICH


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """Behavioural switches of the stochastic model (see the JAX package's
    ``ModelOptions`` for what each one reproduces).  The port runs the
    defaults only."""

    persistent_cloud_chain: bool = True
    swap_covered_branches: bool = False
    advance_cloudy_hour: bool = True
    max_binary_cloudcover: float = 0.95

    def __post_init__(self):
        if dataclasses.astuple(self) != (True, False, True, 0.95):
            raise NotImplementedError(
                "the torch port runs the default ModelOptions only "
                f"(got {self})")


#: SimConfig fields the port accepts beyond their defaults: field -> the
#: values that select this slice ('auto' knobs resolve to these on a GPU).
_SLICE_VALUES = {
    "output": ("trace", "reduce"),
    "block_impl": ("auto", "scan"),
    "compute_dtype": ("auto", "f32"),
    "kernel_impl": ("auto", "exact"),
    "rng_batch": ("auto", "scan"),
    "geom_stride": (0, 1),
    "blocks_per_dispatch": (0, 1),
}

#: fields whose every value belongs to the slice
_FREE_FIELDS = frozenset({
    "start", "duration_s", "n_chains", "seed", "n_chains_total",
    "chain_offset", "site", "options", "meter_max_w", "block_s",
})


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """One simulation run: the time grid, the batch and the output mode.

    Same fields and defaults as ``tmhpvsim_tpu.config.SimConfig``.
    """

    start: str = "2019-09-05 12:00:00"   # naive local wall time at `site.timezone`
    duration_s: int = 86_400             # simulated seconds (1 Hz grid)
    n_chains: int = 1                    # independent stochastic realisations
    seed: int = 0
    #: chains [chain_offset, chain_offset + n_chains) of a notional
    #: n_chains_total-chain run (keys from split(seed key, total) sliced)
    n_chains_total: Optional[int] = None
    chain_offset: int = 0
    site: Site = dataclasses.field(default_factory=Site)
    site_grid: Optional[object] = None
    fleet: Optional[object] = None
    options: ModelOptions = dataclasses.field(default_factory=ModelOptions)
    #: meter demand upper bound [W]; demand is uniform on [0, meter_max_w)
    meter_max_w: float = 9000.0
    #: seconds per block; a multiple of 60 so blocks span whole minutes
    block_s: int = 8640
    output: str = "trace"
    dtype: str = "float32"
    block_impl: str = "auto"
    scan_unroll: int = 8
    stats_fusion: str = "auto"
    blocks_per_dispatch: int = 0
    tune: str = "off"
    prng_impl: str = "threefry2x32"
    compute_dtype: str = "auto"
    kernel_impl: str = "auto"
    rng_batch: str = "auto"
    geom_stride: int = 0
    output_overlap: str = "auto"
    telemetry: str = "off"
    telemetry_strict: bool = False
    analytics: str = "off"
    analytics_bins: int = 2048
    analytics_capacity_w: Optional[float] = None
    analytics_lolp_k: int = 60
    analytics_thresholds: Optional[tuple] = None
    pod_obs: str = "off"
    pod_straggler_factor: float = 2.0
    phase_obs: str = "off"
    trace: Optional[str] = None
    serve_batch_sizes: tuple = ()
    mesh_scenario: int = 0
    checkpoint_keep: int = 3
    checkpoint_async: str = "off"
    preempt_grace_s: float = 0.0

    def __post_init__(self):
        for f in dataclasses.fields(self):
            if f.name in _FREE_FIELDS:
                continue
            value = getattr(self, f.name)
            allowed = _SLICE_VALUES.get(f.name)
            if allowed is not None:
                ok = value in allowed
            else:
                default = (f.default_factory() if f.default is
                           dataclasses.MISSING else f.default)
                ok = value == default
            if not ok:
                raise NotImplementedError(
                    f"SimConfig.{f.name}={value!r} is outside the torch "
                    "port's slice (shared site, float32, threefry2x32, "
                    "exact kernels, scan formulation, reduce mode)")
        if self.block_s % 60 != 0:
            raise ValueError("block_s must be a multiple of 60 (minute grid)")
