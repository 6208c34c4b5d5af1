"""Configuration of a port run (own copy of tmhpvsim_tpu/config.py).

``Site``, ``SiteGrid``, ``ModelOptions`` and ``SimConfig`` carry the JAX
package's field names and defaults, so the same keyword arguments describe
the same run in both packages.  The port implements one slice of that
space — a shared site, a per-chain ``SiteGrid`` or a heterogeneous
``FleetParams`` fleet, float32, threefry2x32, exact or table
transcendentals (``kernel_impl``), per-second or strided solar geometry
(``geom_stride``), the wide, scan and scan2 formulations with either
reduce topology (``block_impl``, ``stats_fusion``), any ``scan_unroll``,
``rng_batch`` and ``blocks_per_dispatch``, trace / reduce / ensemble
output with reduce-mode telemetry and fleet analytics, and the
checkpoint options — and every field outside it raises
``NotImplementedError`` when it is set to anything but its default (or a
value that means the same run).  Nothing is silently ignored.
"""

from __future__ import annotations

import csv
import dataclasses
import math
import numbers
from typing import Optional

import numpy as np

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


#: columns SiteGrid.from_csv reads (others in the file are ignored)
_SITE_CSV_COLUMNS = frozenset({
    "latitude", "longitude", "altitude", "surface_tilt",
    "surface_azimuth", "albedo",
})

#: valid ranges of the geometry columns, inclusive: a CSV row outside them
#: is a data-entry error, refused by line
_SITE_CSV_RANGES = {
    "latitude": (-90.0, 90.0),
    "longitude": (-180.0, 180.0),
    "altitude": (-430.0, 9000.0),
    "surface_tilt": (0.0, 90.0),
    "surface_azimuth": (0.0, 360.0),
    "albedo": (0.0, 1.0),
}


def _check_csv_range(path, line_num, name, value) -> None:
    lo, hi = _SITE_CSV_RANGES[name]
    if not (math.isfinite(value) and lo <= value <= hi):
        raise ValueError(
            f"{path} line {line_num}: {name}={value!r} outside "
            f"[{lo:g}, {hi:g}]")


@dataclasses.dataclass(frozen=True)
class SiteGrid:
    """Per-chain site parameters of a multi-site run: chain i simulates
    site i, with its solar geometry evaluated on the device from the
    float32-safe split time (models/solar.py ``device_geometry``).  Each
    field is a length-n sequence; the timezone (and so the calendar of the
    stochastic model) and the turbidity climatology are shared."""

    latitude: tuple
    longitude: tuple
    altitude: tuple
    surface_tilt: tuple
    surface_azimuth: tuple
    albedo: tuple = None
    timezone: str = "Europe/Berlin"
    linke_turbidity_monthly: tuple = LINKE_TURBIDITY_MONTHLY_MUNICH

    def __post_init__(self):
        n = len(self.latitude)
        for f in ("longitude", "altitude", "surface_tilt",
                  "surface_azimuth"):
            if len(getattr(self, f)) != n:
                raise ValueError(f"SiteGrid.{f} must have length {n}")
        if self.albedo is None:
            object.__setattr__(self, "albedo", (0.25,) * n)
        elif len(self.albedo) != n:
            raise ValueError(f"SiteGrid.albedo must have length {n}")

    def __len__(self):
        return len(self.latitude)

    @classmethod
    def from_csv(cls, path: str, **kw):
        """A site list from a CSV with header.  Required columns
        ``latitude``, ``longitude``; optional ``altitude`` (default 100 m),
        ``surface_tilt`` (default: the site's latitude), ``surface_azimuth``
        (default 180 = south), ``albedo`` (default 0.25).  Other columns
        are ignored; a bad or out-of-range value is refused with its line
        number."""
        rows = []
        with open(path, newline="") as f:
            reader = csv.DictReader(f)
            cols = set(reader.fieldnames or ()) & _SITE_CSV_COLUMNS
            missing = {"latitude", "longitude"} - cols
            if missing:
                raise ValueError(
                    f"{path}: missing required column(s) {sorted(missing)}")
            for row in reader:
                vals = {}
                for k in cols:
                    v = row.get(k)
                    if v is None or v == "":  # ragged row / blank cell
                        continue
                    try:
                        vals[k] = float(v)
                    except ValueError:
                        raise ValueError(
                            f"{path} line {reader.line_num}: bad value "
                            f"{v!r} for {k}") from None
                    _check_csv_range(path, reader.line_num, k, vals[k])
                if "latitude" not in vals or "longitude" not in vals:
                    raise ValueError(
                        f"{path} line {reader.line_num}: latitude and "
                        "longitude are required in every row")
                rows.append(vals)
        if not rows:
            raise ValueError(f"{path}: no data rows")

        def col(name, default=None):
            return tuple(r.get(name, r["latitude"] if default == "latitude"
                               else default) for r in rows)

        return cls(latitude=col("latitude"), longitude=col("longitude"),
                   altitude=col("altitude", 100.0),
                   surface_tilt=col("surface_tilt", "latitude"),
                   surface_azimuth=col("surface_azimuth", 180.0),
                   albedo=col("albedo", 0.25), **kw)

    @classmethod
    def regular(cls, lat_range, lon_range, n_lat: int, n_lon: int,
                altitude: float = 100.0, tilt=None, azimuth: float = 180.0,
                **kw):
        """A regular n_lat x n_lon lat/lon mesh; tilt defaults to the
        latitude."""
        lats = np.linspace(*lat_range, n_lat)
        lons = np.linspace(*lon_range, n_lon)
        glat, glon = np.meshgrid(lats, lons, indexing="ij")
        glat, glon = glat.ravel(), glon.ravel()
        tilts = glat if tilt is None else np.full_like(glat, tilt)
        n = glat.size
        return cls(latitude=tuple(glat), longitude=tuple(glon),
                   altitude=(altitude,) * n, surface_tilt=tuple(tilts),
                   surface_azimuth=(azimuth,) * n, **kw)


#: SiteGrid's per-site fields, in the order the engine carries them
SITE_FIELDS = ("latitude", "longitude", "altitude", "surface_tilt",
               "surface_azimuth", "albedo")


def slice_grid(grid: Optional[SiteGrid], off: int, n: int
               ) -> Optional[SiteGrid]:
    """``grid`` restricted to sites [off, off+n); None passes through."""
    if grid is None:
        return None
    return dataclasses.replace(grid, **{
        f: tuple(getattr(grid, f)[off:off + n]) for f in SITE_FIELDS})


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
    "output": ("trace", "reduce", "ensemble"),
    "output_overlap": ("auto", "off"),
    "prng_impl": ("threefry2x32", "rbg", "unsafe_rbg"),
}

#: fields whose every value belongs to the slice (``telemetry``,
#: ``analytics`` and ``fleet`` are checked on their own below; the plan's
#: fields by ``resolve_plan``, with the JAX package's errors)
_FREE_FIELDS = frozenset({
    "start", "duration_s", "n_chains", "seed", "n_chains_total",
    "chain_offset", "site", "site_grid", "fleet", "options", "meter_max_w",
    "block_s", "telemetry", "analytics", "analytics_bins",
    "analytics_capacity_w", "analytics_lolp_k", "analytics_thresholds",
    "serve_batch_sizes", "kernel_impl", "geom_stride", "block_impl",
    "scan_unroll", "stats_fusion", "blocks_per_dispatch", "rng_batch",
    "compute_dtype", "telemetry_strict", "checkpoint_keep",
    "checkpoint_async", "preempt_grace_s",
})

#: valid values of SimConfig.telemetry / --telemetry (obs/telemetry.py)
TELEMETRY_LEVELS = ("off", "light", "full")
#: valid values of SimConfig.analytics / --analytics (obs/analytics.py)
ANALYTICS_LEVELS = ("off", "risk", "full")


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
    site_grid: Optional[SiteGrid] = None
    #: heterogeneous fleet (tmhpvsim_torch.fleet.FleetParams): chain i is
    #: fleet row i (overrides n_chains); a non-uniform geometry derives
    #: site_grid, a uniform one runs on the shared-site path
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
    #: in-graph numerics telemetry, reduce mode only: 'off', 'light'
    #: (NaN / non-finite counters and moments per field) or 'full'
    #: (light + csi histogram + cloud occupancy)
    telemetry: str = "off"
    telemetry_strict: bool = False
    #: fleet-risk analytics, reduce mode only: 'off', 'risk' (residual
    #: sketch, exceedance, LOLP, ramps, per-cohort group-by) or 'full'
    #: (risk + per-cloud-regime sums)
    analytics: str = "off"
    #: interior bins of the residual sketch
    analytics_bins: int = 2048
    #: loss-of-load capacity [W]; None -> 0.8 * meter_max_w
    analytics_capacity_w: Optional[float] = None
    #: consecutive loss seconds before a run counts as loss of load
    analytics_lolp_k: int = 60
    #: exceedance thresholds [W], ascending; None -> 1/8..7/8 of
    #: meter_max_w
    analytics_thresholds: Optional[tuple] = None
    pod_obs: str = "off"
    pod_straggler_factor: float = 2.0
    phase_obs: str = "off"
    trace: Optional[str] = None
    serve_batch_sizes: tuple = ()
    mesh_scenario: int = 0
    #: checkpoint generations kept on disk (engine/checkpoint.py); not
    #: part of the checkpoint's config echo
    checkpoint_keep: int = 3
    #: 'on' writes checkpoints on a writer thread (the run pays the
    #: device-to-host copy only); 'off' saves synchronously
    checkpoint_async: str = "off"
    #: > 0: a SIGTERM finishes the block in flight, drains one final
    #: snapshot and exits cleanly (apps/pvsim.py); 0 keeps SIGTERM's
    #: default
    preempt_grace_s: float = 0.0

    def __post_init__(self):
        if self.site_grid is not None and \
                not isinstance(self.site_grid, SiteGrid):
            raise NotImplementedError(
                "SimConfig.site_grid must be tmhpvsim_torch.config.SiteGrid "
                f"(got {type(self.site_grid).__name__})")
        if self.fleet is not None:
            from tmhpvsim_torch.fleet import FleetParams

            if not isinstance(self.fleet, FleetParams):
                raise NotImplementedError(
                    "SimConfig.fleet must be tmhpvsim_torch.fleet."
                    f"FleetParams (got {type(self.fleet).__name__})")
        if self.telemetry not in TELEMETRY_LEVELS:
            raise ValueError(f"telemetry must be 'off', 'light' or 'full', "
                             f"got {self.telemetry!r}")
        if self.analytics not in ANALYTICS_LEVELS:
            raise ValueError(f"analytics must be 'off', 'risk' or 'full', "
                             f"got {self.analytics!r}")
        if not _is_int(self.checkpoint_keep) or self.checkpoint_keep < 1:
            raise ValueError(f"checkpoint_keep must be >= 1, got "
                             f"{self.checkpoint_keep!r}")
        if self.checkpoint_async not in ("off", "on"):
            raise ValueError(f"checkpoint_async must be 'off' or 'on', got "
                             f"{self.checkpoint_async!r}")
        if not self.preempt_grace_s >= 0:
            raise ValueError(f"preempt_grace_s must be >= 0, got "
                             f"{self.preempt_grace_s!r}")
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
                    "port's slice: it computes in float32 or bf16 with "
                    "threefry2x32, rbg or unsafe_rbg keys under the static "
                    "plan, with no autotuner, 2-D mesh, pod or phase "
                    "observers or profiler trace")
        if self.block_s % 60 != 0:
            raise ValueError("block_s must be a multiple of 60 (minute grid)")


@dataclasses.dataclass(frozen=True)
class Plan:
    """The resolved plan of a run: the ``Plan`` fields of the JAX package
    that the port implements.

    Two precision levers: ``kernel_impl`` 'exact' or 'table'
    (models/tables.py) and ``geom_stride`` 1, 30 or 60 (models/solar.py
    ``STRIDES``).  The formulation: ``block_impl`` 'wide' (the trace
    launch, then the wide fold or series kernel, kernels/wide.py), 'scan'
    or 'scan2', and the reduce topology ``stats_fusion`` of the wide
    formulation ('split': the trace and the fold; 'fused': the block
    step's acc epilogue, producer, statistics and merge in one launch).
    The compute dtype ``compute_dtype``: 'f32', or 'bf16' (K12: the
    per-second draws, the geometry and the PV physics in bfloat16, every
    accumulator and the carry in float32), and ``telemetry``, the
    telemetry level the run folds: bf16 never runs unwatched, so 'off'
    escalates to 'light' under it (the drift sentinel then checks every
    block).  Three dispatch knobs that give the same bits: ``scan_unroll``,
    ``rng_batch`` ('scan' or 'block') and ``blocks_per_dispatch`` (blocks
    whose inputs go to the card in one copy and whose launches are
    enqueued back to back).  ``prng_impl`` echoes the config's key
    implementation: under 'rbg' each batched draw takes its batch's first
    key (tmhpvsim_torch/rng.py), so the formulation and ``rng_batch``
    choose which values a chain draws (``clearsky_index.DRAW_LAYOUTS``),
    as they do in the JAX package; under 'unsafe_rbg' the key derivations
    are batched draws as well.

    'auto' resolves as the JAX package resolves it on an accelerator,
    whatever the device: ``block_impl`` 'scan', ``stats_fusion`` 'fused',
    ``rng_batch`` 'scan', ``blocks_per_dispatch`` 0 to 1.  The CPU path
    runs the card's kernels' plain versions, so the tests cover what the
    card runs.  'scan' and 'scan2' and every ``scan_unroll`` and
    ``rng_batch`` run the port's one scan kernel, which draws each
    minute's random tile in registers (what scan2 and the block hoist are
    for on the TPU): they give the default run's bits."""

    kernel_impl: str = "exact"
    geom_stride: int = 1
    block_impl: str = "scan"
    stats_fusion: str = "fused"
    scan_unroll: int = 8
    blocks_per_dispatch: int = 1
    rng_batch: str = "scan"
    compute_dtype: str = "f32"
    telemetry: str = "off"
    prng_impl: str = "threefry2x32"
    #: chains of each sequential slab (engine/slab.py); ``slab_chains >=
    #: n_chains`` (what ``resolve_plan`` sets) runs the batch in one piece
    slab_chains: int = 0


def escalate_telemetry(level: str, compute_dtype: str) -> str:
    """bf16 never runs unwatched: a telemetry level of 'off' becomes
    'light' when the compute dtype is bf16 (the JAX package's
    ``_escalate_telemetry``)."""
    if compute_dtype == "bf16" and level == "off":
        return "light"
    return level


def _is_int(v) -> bool:
    return isinstance(v, numbers.Integral) and not isinstance(v, bool)


def resolve_plan(config: SimConfig) -> Plan:
    """``config``'s plan resolved as the JAX package resolves it without
    the autotuner on an accelerator: 'auto' is the exact set, float32,
    the scan formulation, the fused topology and per-minute draws, a stride
    of 0 is 1 and 0 blocks per dispatch is 1; the telemetry level escalates
    under bf16.  Raises ``ValueError`` with the JAX package's messages for
    a value outside the choices or a stride that does not divide
    ``block_s``."""
    cd = config.compute_dtype
    if cd == "auto":
        cd = "f32"
    elif cd not in ("f32", "bf16"):
        raise ValueError(
            f"compute_dtype must be 'auto', 'f32' or 'bf16', got {cd!r}")
    ki = config.kernel_impl
    if ki == "auto":
        ki = "exact"
    elif ki not in ("exact", "table"):
        raise ValueError(
            f"kernel_impl must be 'auto', 'exact' or 'table', got {ki!r}")
    gs = int(config.geom_stride)
    if gs == 0:
        gs = 1
    elif gs not in (1, 30, 60):
        raise ValueError(
            f"geom_stride must be 0 (auto), 1, 30 or 60, got {gs!r}")
    if gs > 1 and config.block_s % gs:
        raise ValueError(f"geom_stride {gs} must divide block_s "
                         f"{config.block_s}")
    impl = config.block_impl
    if impl == "auto":
        impl = "scan"
    elif impl not in ("wide", "scan", "scan2"):
        raise ValueError(
            f"block_impl must be 'auto', 'wide', 'scan' or 'scan2', "
            f"got {impl!r}")
    fusion = config.stats_fusion
    if fusion == "auto":
        fusion = "fused"
    elif fusion not in ("fused", "split"):
        raise ValueError(
            f"stats_fusion must be 'auto', 'fused' or 'split', "
            f"got {fusion!r}")
    rb = config.rng_batch
    if rb == "auto":
        rb = "scan"
    elif rb not in ("scan", "block"):
        raise ValueError(
            f"rng_batch must be 'auto', 'scan' or 'block', got {rb!r}")
    unroll = config.scan_unroll
    if not _is_int(unroll) or unroll < 1:
        raise ValueError(f"scan_unroll must be an int >= 1, got {unroll!r}")
    k = config.blocks_per_dispatch
    if not _is_int(k) or k < 0:
        raise ValueError(
            f"blocks_per_dispatch must be an int >= 0 (0 = auto), got {k!r}")
    return Plan(kernel_impl=ki, geom_stride=gs, block_impl=impl,
                stats_fusion=fusion, scan_unroll=int(unroll),
                blocks_per_dispatch=max(1, int(k)), rng_batch=rb,
                compute_dtype=cd,
                telemetry=escalate_telemetry(config.telemetry, cd),
                prng_impl=config.prng_impl, slab_chains=int(config.n_chains))
