"""Per-site fleet parameters on the chain axis (own copy of the JAX
package's fleet/params.py, numpy only).

``SiteGrid`` made the geometry per chain; :class:`FleetParams` makes the
rest per chain too: one row per installation, chain i simulates row i,
and each heterogeneous column rides the simulation as a ``state["fleet"]``
leaf of shape (n_chains,), like ``state["site"]``.

Broadcast rules (the port keeps the JAX package's):

* a column left at its neutral value (capacity scale 1, no AC limit,
  regime 0, demand scale 1 / shift 0) contributes no state leaf and no
  per-second transform, so the run is the no-fleet run bit for bit;
* a heterogeneous column becomes one (n_chains,) leaf that the block
  step reads once per block.

Per-second transforms (kernels/block_step.py, csrc/block_step.cu):

* demand:  ``meter_i = meter_i * demand_scale_i + demand_shift_w_i``
  (one rounding: the JAX scan contracts it into a multiply-add);
* power:   ``pv_i    = min(pv_i * dc_capacity_scale_i, ac_limit_w_i)``
* weather: the hourly Markov step draws from the table
  ``weather_regime_i`` selects (data/parameters.py
  ``MARKOV_STEP_PARAMS_REGIMES``; regime 0 is the Munich fit).

``cohort`` is a small-integer site-class tag for the per-cohort group-by
of obs/analytics.py; it never changes the simulated physics.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional

import numpy as np

from tmhpvsim_torch.config import Site, SiteGrid
from tmhpvsim_torch.data import (LINKE_TURBIDITY_MONTHLY_MUNICH,
                                 MARKOV_STEP_PARAMS_REGIMES)

#: validation ranges, shared with ``SiteGrid.from_csv``: column ->
#: (lo, hi), inclusive.  Out-of-range rows are configuration errors a
#: fleet build must refuse by line, never propagate into the geometry
#: chain as NaN/garbage.
COLUMN_RANGES = {
    "latitude": (-90.0, 90.0),
    "longitude": (-180.0, 180.0),
    "altitude": (-430.0, 9000.0),       # Dead Sea shore .. above Everest BC
    "surface_tilt": (0.0, 90.0),
    "surface_azimuth": (0.0, 360.0),
    "albedo": (0.0, 1.0),
    "dc_capacity_scale": (0.0, 1e6),
    "ac_limit_w": (0.0, float("inf")),
    "demand_scale": (0.0, 1e6),
    "demand_shift_w": (-1e9, 1e9),
}

#: number of vendored weather-regime step tables
N_REGIMES = len(MARKOV_STEP_PARAMS_REGIMES)

#: columns ``FleetParams.from_csv`` reads beyond the SiteGrid geometry set
_FLEET_CSV_COLUMNS = frozenset(COLUMN_RANGES) | {"weather_regime", "cohort"}

#: the no-AC-limit sentinel (encodes as the compute dtype's finfo.max on
#: device, so ``min(pv, limit)`` is the identity for unlimited rows)
NO_AC_LIMIT = float("inf")


def check_range(name: str, value: float, *, where: str = "") -> None:
    """Raise ValueError when ``value`` falls outside ``name``'s range
    (or is non-finite for a bounded column); ``where`` prefixes the
    message (e.g. ``"fleet.csv line 7: "``)."""
    rng = COLUMN_RANGES.get(name)
    if rng is None:
        return
    lo, hi = rng
    ok = lo <= value <= hi if np.isfinite(value) else (
        name == "ac_limit_w" and value > 0)
    if not ok:
        raise ValueError(
            f"{where}{name}={value!r} outside [{lo:g}, {hi:g}]")


@dataclasses.dataclass(frozen=True)
class FleetParams:
    """One row per installation; every per-site field is a length-n
    sequence.  Geometry columns mirror ``SiteGrid``; the electrical /
    stochastic columns default to their neutral values (see module
    docstring for what "neutral" buys).  The timezone and turbidity
    climatology are shared across the fleet, like ``SiteGrid``.
    """

    latitude: tuple
    longitude: tuple
    altitude: tuple = None
    surface_tilt: tuple = None
    surface_azimuth: tuple = None
    albedo: tuple = None
    #: DC nameplate relative to the reference module string (1.0 = the
    #: vendored 250 W class)
    dc_capacity_scale: tuple = None
    #: inverter AC clip [W]; ``inf`` = no clip (the neutral value)
    ac_limit_w: tuple = None
    #: index into data/parameters.py MARKOV_STEP_PARAMS_REGIMES
    weather_regime: tuple = None
    #: demand profile affine map applied to the uniform meter draw
    demand_scale: tuple = None
    demand_shift_w: tuple = None
    #: site-class tag for the group-by analytics
    cohort: tuple = None
    timezone: str = "Europe/Berlin"
    linke_turbidity_monthly: tuple = LINKE_TURBIDITY_MONTHLY_MUNICH
    #: cohort-id space of the NOTIONAL fleet: set by ``slice_fleet`` so a
    #: chain slab containing only low-numbered cohorts
    #: still folds into full-width (n_cohorts,) accumulator leaves —
    #: slab merges need equal shapes.  None = ``max(cohort) + 1``.
    n_cohorts_hint: Optional[int] = None

    def __post_init__(self):
        n = len(self.latitude)
        if n == 0:
            raise ValueError("FleetParams needs at least one site")
        defaults = {
            "altitude": 100.0,
            "surface_tilt": None,        # -> latitude (tilt-equals-latitude)
            "surface_azimuth": 180.0,
            "albedo": 0.25,
            "dc_capacity_scale": 1.0,
            "ac_limit_w": NO_AC_LIMIT,
            "weather_regime": 0,
            "demand_scale": 1.0,
            "demand_shift_w": 0.0,
            "cohort": 0,
        }
        for f, dflt in defaults.items():
            v = getattr(self, f)
            if v is None:
                if f == "surface_tilt":
                    v = tuple(self.latitude)
                else:
                    v = (dflt,) * n
                object.__setattr__(self, f, v)
            elif len(v) != n:
                raise ValueError(f"FleetParams.{f} must have length {n}")
        for i, (r, c) in enumerate(zip(self.weather_regime, self.cohort)):
            if not 0 <= int(r) < N_REGIMES:
                raise ValueError(
                    f"FleetParams.weather_regime[{i}]={r!r} outside "
                    f"[0, {N_REGIMES})")
            if int(c) < 0:
                raise ValueError(
                    f"FleetParams.cohort[{i}]={c!r} must be >= 0")
        for name in COLUMN_RANGES:
            for i, v in enumerate(getattr(self, name)):
                check_range(name, float(v),
                            where=f"FleetParams.{name}[{i}]: ")

    def __len__(self):
        return len(self.latitude)

    # -- derived views ---------------------------------------------------

    @property
    def n_cohorts(self) -> int:
        """Cohort-id space size: ``max(cohort) + 1`` (dense small ints),
        or the notional fleet's width when this is a slice."""
        n = int(max(self.cohort)) + 1
        return max(n, self.n_cohorts_hint or 0)

    @property
    def het_demand(self) -> bool:
        """Any row's demand transform differs from the identity."""
        return any(s != 1.0 for s in self.demand_scale) or \
            any(s != 0.0 for s in self.demand_shift_w)

    @property
    def het_power(self) -> bool:
        """Any row's power transform differs from the identity."""
        return any(s != 1.0 for s in self.dc_capacity_scale) or \
            any(np.isfinite(v) for v in self.ac_limit_w)

    @property
    def het_regime(self) -> bool:
        """Any row draws from a non-default weather-regime table."""
        return any(int(r) != 0 for r in self.weather_regime)

    @property
    def uniform_geometry(self) -> bool:
        """Every site shares one geometry row — the fleet lowers onto
        the scalar ``Site`` path instead of a per-chain grid."""
        return all(
            len(set(getattr(self, f))) == 1
            for f in ("latitude", "longitude", "altitude", "surface_tilt",
                      "surface_azimuth", "albedo")
        )

    def site_grid(self) -> SiteGrid:
        """The geometry columns as a ``SiteGrid`` (the engine derives
        this when the fleet's geometry is non-uniform)."""
        return SiteGrid(
            latitude=tuple(self.latitude),
            longitude=tuple(self.longitude),
            altitude=tuple(self.altitude),
            surface_tilt=tuple(self.surface_tilt),
            surface_azimuth=tuple(self.surface_azimuth),
            albedo=tuple(self.albedo),
            timezone=self.timezone,
            linke_turbidity_monthly=self.linke_turbidity_monthly,
        )

    def uniform_site(self) -> Site:
        """Row 0 as a scalar ``Site`` (valid when ``uniform_geometry``)."""
        return Site(
            latitude=float(self.latitude[0]),
            longitude=float(self.longitude[0]),
            altitude=float(self.altitude[0]),
            surface_tilt=float(self.surface_tilt[0]),
            surface_azimuth=float(self.surface_azimuth[0]),
            albedo=float(self.albedo[0]),
            timezone=self.timezone,
            linke_turbidity_monthly=self.linke_turbidity_monthly,
        )

    def digest(self) -> str:
        """Stable content hash of every parameter row — the fleet's
        identity (the JAX package keys checkpoints and plans by it).
        Two fleets with equal rows digest equal regardless of how they
        were built (CSV, synthetic, literal)."""
        doc = {f.name: getattr(self, f.name)
               for f in dataclasses.fields(self)}
        blob = json.dumps(doc, sort_keys=True, separators=(",", ":"),
                          default=float)
        return hashlib.sha256(blob.encode()).hexdigest()

    # -- constructors ----------------------------------------------------

    @classmethod
    def from_site_grid(cls, grid: SiteGrid, **kw) -> "FleetParams":
        """A fleet with the grid's geometry and neutral electrical /
        stochastic columns (override any via ``kw``)."""
        return cls(
            latitude=tuple(grid.latitude),
            longitude=tuple(grid.longitude),
            altitude=tuple(grid.altitude),
            surface_tilt=tuple(grid.surface_tilt),
            surface_azimuth=tuple(grid.surface_azimuth),
            albedo=tuple(grid.albedo),
            timezone=grid.timezone,
            linke_turbidity_monthly=grid.linke_turbidity_monthly,
            **kw,
        )

    @classmethod
    def from_csv(cls, path: str, **kw) -> "FleetParams":
        """A fleet from an asset-register CSV with header.  Required
        columns ``latitude``, ``longitude``; every other per-site column
        is optional with its neutral default (``surface_tilt`` defaults
        to the row's latitude; blank ``ac_limit_w`` cells mean no clip).
        Extra columns are ignored.  Out-of-range and unparsable values
        are refused with the offending CSV line number."""
        import csv as _csv

        rows = []
        with open(path, newline="") as f:
            reader = _csv.DictReader(f)
            cols = set(reader.fieldnames or ()) & _FLEET_CSV_COLUMNS
            missing = {"latitude", "longitude"} - cols
            if missing:
                raise ValueError(
                    f"{path}: missing required column(s) {sorted(missing)}")
            for row in reader:
                vals = {}
                for k in cols:
                    v = row.get(k)
                    if v is None or v == "":   # ragged row / blank cell
                        continue
                    try:
                        vals[k] = int(v) if k in ("weather_regime",
                                                  "cohort") else float(v)
                    except ValueError:
                        raise ValueError(
                            f"{path} line {reader.line_num}: bad value "
                            f"{v!r} for {k}") from None
                    if k == "weather_regime" and \
                            not 0 <= vals[k] < N_REGIMES:
                        raise ValueError(
                            f"{path} line {reader.line_num}: "
                            f"weather_regime={vals[k]} outside "
                            f"[0, {N_REGIMES})")
                    if k == "cohort" and vals[k] < 0:
                        raise ValueError(
                            f"{path} line {reader.line_num}: "
                            f"cohort={vals[k]} must be >= 0")
                    check_range(k, float(vals[k]),
                                where=f"{path} line {reader.line_num}: ")
                if "latitude" not in vals or "longitude" not in vals:
                    raise ValueError(
                        f"{path} line {reader.line_num}: latitude and "
                        "longitude are required in every row")
                rows.append(vals)
        if not rows:
            raise ValueError(f"{path}: no data rows")

        def col(name, default=None):
            return tuple(
                r.get(name, r["latitude"] if default == "latitude"
                      else default) for r in rows)

        return cls(
            latitude=col("latitude"),
            longitude=col("longitude"),
            altitude=col("altitude", 100.0),
            surface_tilt=col("surface_tilt", "latitude"),
            surface_azimuth=col("surface_azimuth", 180.0),
            albedo=col("albedo", 0.25),
            dc_capacity_scale=col("dc_capacity_scale", 1.0),
            ac_limit_w=col("ac_limit_w", NO_AC_LIMIT),
            weather_regime=col("weather_regime", 0),
            demand_scale=col("demand_scale", 1.0),
            demand_shift_w=col("demand_shift_w", 0.0),
            cohort=col("cohort", 0),
            **kw,
        )

    @classmethod
    def synthetic(cls, n: int, seed: int = 0, *,
                  n_cohorts: int = 3, **kw) -> "FleetParams":
        """A seeded national-fleet sampler for bench/test use: ``n``
        rooftop installations over a Germany-like bounding box, capacity
        log-normal around the reference class, ~30 % inverter-clipped,
        regimes banded north (maritime) / south (continental-dry) with
        the temperate default in between, demand profiles scattered
        around the reference meter.  Same (n, seed) -> same fleet,
        bit-for-bit (numpy Generator with a fixed bit stream)."""
        if n < 1:
            raise ValueError(f"synthetic fleet needs n >= 1, got {n}")
        rng = np.random.default_rng((seed, 0xF1EE7))
        lat = rng.uniform(47.3, 55.0, n)
        lon = rng.uniform(6.0, 15.0, n)
        alt = np.clip(rng.gamma(2.0, 150.0, n), 0.0, 2500.0)
        tilt = np.clip(lat + rng.normal(0.0, 8.0, n), 5.0, 75.0)
        azi = np.clip(rng.normal(180.0, 35.0, n), 90.0, 270.0)
        albedo = np.clip(rng.normal(0.25, 0.05, n), 0.1, 0.6)
        cap = np.clip(rng.lognormal(0.0, 0.4, n), 0.2, 6.0)
        # ~30 % of sites clip: limit at 70-95 % of scaled nameplate
        # (250 W reference class), the rest unlimited
        clip = rng.uniform(size=n) < 0.3
        limit = np.where(clip,
                         cap * 250.0 * rng.uniform(0.7, 0.95, n),
                         np.inf)
        # regime bands: north of 53.5N maritime, south of 48.5N
        # continental-dry, temperate (regime 0) in between
        regime = np.where(lat > 53.5, 1, np.where(lat < 48.5, 2, 0))
        dem_scale = np.clip(rng.lognormal(0.0, 0.3, n), 0.2, 5.0)
        dem_shift = rng.normal(0.0, 200.0, n)
        cohort = rng.integers(0, max(1, n_cohorts), n)
        return cls(
            latitude=tuple(round(v, 5) for v in lat),
            longitude=tuple(round(v, 5) for v in lon),
            altitude=tuple(round(v, 1) for v in alt),
            surface_tilt=tuple(round(v, 2) for v in tilt),
            surface_azimuth=tuple(round(v, 2) for v in azi),
            albedo=tuple(round(v, 3) for v in albedo),
            dc_capacity_scale=tuple(round(v, 4) for v in cap),
            ac_limit_w=tuple(float(v) if np.isfinite(v) else NO_AC_LIMIT
                             for v in np.round(limit, 1)),
            weather_regime=tuple(int(v) for v in regime),
            demand_scale=tuple(round(v, 4) for v in dem_scale),
            demand_shift_w=tuple(round(v, 1) for v in dem_shift),
            cohort=tuple(int(v) for v in cohort),
            **kw,
        )


def slice_fleet(fleet: Optional[FleetParams], off: int, n: int
                ) -> Optional[FleetParams]:
    """``fleet`` restricted to sites [off, off+n) — the rows a chain
    slab of those chains simulates; the slicing
    twin of ``config.slice_grid``.  None passes through."""
    if fleet is None:
        return None
    per_site = ("latitude", "longitude", "altitude", "surface_tilt",
                "surface_azimuth", "albedo", "dc_capacity_scale",
                "ac_limit_w", "weather_regime", "demand_scale",
                "demand_shift_w", "cohort")
    return dataclasses.replace(
        fleet, n_cohorts_hint=fleet.n_cohorts,
        **{f: tuple(getattr(fleet, f)[off:off + n])
           for f in per_site})
