"""K3, K4, K6, K6s and K11: the fused per-second step of one block, with
four epilogues, three geometry modes and two kernel sets.

Replaces, in tmhpvsim_tpu/engine/simulation.py:

* K3 ``_block_step_scan_acc`` (:1276): ``_scan_block_setup.step``
  (:1190-1242) plus ``_make_acc_body`` (:1246-1272) — the fold of the
  seven ``REDUCE_STATS`` (the ``acc`` epilogue);
* K4 ``_block_step_scan_series`` (:1692, same values as ``:1667``) — the
  per-second cross-chain sums of meter and pv (the ``series`` epilogue);
* K4 ``_block_step`` (:844-956) — every chain's per-second meter and pv
  (the ``trace`` epilogue);
* K6 ``solar.device_geometry`` (models/solar.py:434-486, from the scan
  step at :1204-1213) — per-chain solar geometry of a site grid (the
  ``site`` geometry mode; the shared mode reads the block's host-computed
  rows instead);
* K6s the strided site geometry (``geom_stride`` 30 / 60): the sample-grid
  ``device_geometry`` (:1144-1166, the wide step :868-900) and
  ``solar.interp_sampled`` (models/solar.py:587) per second (the
  ``strided`` geometry mode, ``SiteGeometry.stride``);
* K11 the table transcendentals (models/tables.py:354,
  ``kernel_impl='table'``): the same step with the table kernel set, its
  own library (csrc/block_step_table.cu), selected by ``kernels=``;
* K7 the per-site transforms of a heterogeneous fleet (:1228-1238), in
  every epilogue (``FleetLeaves``);
* K8 the TelemetryAcc fold of ``_block_step_scan_acc_tel`` (:1298-1337)
  and K9 the FleetAcc fold of ``_block_step_scan_acc_fleet`` (:1394-1481;
  both at once :1436, :1524), each with its ``reduce_chainwise`` collapse
  (``block_step_obs``; obs/telemetry.py, obs/analytics.py);
* K10 the scenario fold of ``_block_step_scan_scenario`` /
  ``_scenario_block_core`` (:1834, :1871-1937): each scenario row's
  transform of the step's meter and pv, its selectors and horizon, the
  seven statistics per (scenario, chain) and a ``risk`` FleetAcc per
  scenario with its ``reduce_chainwise`` (``block_step_scenario``);
* K12 the same step under ``compute_dtype='bf16'`` (:1129-1132, :713-733,
  :765, :830-842, :911-912, :1218): the acc and series epilogues draw the
  per-second u / z in bf16 (the trace epilogue, the JAX ``_block_step``,
  draws them in float32), the geometry reaches the physics in bf16 (the
  shared rows rounded on the host, the per-chain and strided geometry
  narrowed after its float32 evaluation, the stride lerp in bf16) and the
  csi handed to ``pv.power_from_csi`` is rounded to bf16, whose chain then
  runs with the JAX graph's types (models/bf16.py); the carry, the meter
  and every accumulator stay float32 (``compute_dtype=``; its own
  libraries csrc/block_step_bf16.cu and block_step_bf16_table.cu); the
  scenario epilogue too (K12 in K10, the JAX ``ScenarioEngine`` under
  bf16: ``_scan_block_setup``'s step in the compute dtype, :1887);
* K13 the same step under ``prng_impl='rbg'`` (engine/simulation.py:333):
  every draw from Philox4x32-10 (csrc/philox.cuh) at the offsets of the
  JAX formulation it stands for (``layout=``, models/clearsky_index.py
  ``DRAW_LAYOUTS``: the flat scan's ``scan_draws_tmajor`` :1130, the
  nested scan's per-minute draws :1622-1636, the trace step's
  minute-grouped draws :844-956), each batched draw from its batch's
  first key as jax's batching rule has it; its own four libraries
  (csrc/block_step_rbg*.cu), chosen by the keys' width.

Every epilogue shares one pre-fold body: for every chain and second the
table lerps, the renewal step (a new cycle from ``cycle_from_u`` on
redraw), the csi composition, ``pv.power_from_csi`` and the meter, fed by
``scan_draws_tmajor`` / ``meter_block_tmajor`` (models/clearsky_index.py
:278-319).  ``block_step_plain``, ``series_plain``, ``trace_plain``,
``block_step_obs_plain`` and ``scenario_plain`` are that body
(``_body_plain``) plus their epilogue, so they cannot drift apart; the
CUDA kernel (csrc/block_step.cuh) is one template over the kernel set,
the epilogue, the geometry mode and the observers.

Each wrapper runs its plain version on CPU tensors and launches the
kernel on CUDA tensors; every (epilogue, geometry, kernel set)
instantiation counts its launches (``STEP``).  The kernels
update ``carry`` (and ``acc``) in place (one chain per thread, each
reading and writing only its own entries); the plain versions return new
tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from tmhpvsim_torch import rng
from tmhpvsim_torch.config import SITE_FIELDS
from tmhpvsim_torch.data import SANDIA_INVERTER, SAPM_MODULE
from tmhpvsim_torch.kernels import build
from tmhpvsim_torch.models import clearsky_index as ci
from tmhpvsim_torch.models import distributions as dist
from tmhpvsim_torch.models import bf16 as mx
from tmhpvsim_torch.models import pv, renewal, solar
from tmhpvsim_torch.models.tables import KERNEL_IMPLS, get_kernels
from tmhpvsim_torch.obs import analytics as flt
from tmhpvsim_torch.obs import telemetry as tel

#: the geometry modes (csrc/block_step.cuh ``Geom``)
GEOMS = ("shared", "site", "strided")
_EPI_BASE = (("acc", "block_step"), ("series", "block_step_series"),
             ("trace", "block_step_trace"))


def _counters(suffix: str) -> dict:
    """One launch counter per (epilogue, geometry mode, kernel set) of a
    compute dtype and key implementation, named
    ``{base}[_{geometry}][_{set}]{suffix}``; the scenario epilogue counts
    per kernel set."""
    out = {(epi, geo, ks): build.LaunchCounter(
        base + ("" if geo == "shared" else "_" + geo)
        + ("" if ks == "exact" else "_" + ks) + suffix)
        for epi, base in _EPI_BASE for geo in GEOMS for ks in KERNEL_IMPLS}
    for ks in KERNEL_IMPLS:
        scen = build.LaunchCounter("block_step_scenario"
                                   + ("" if ks == "exact" else "_" + ks)
                                   + suffix)
        for geo in GEOMS:
            out["scen", geo, ks] = scen
    return out


#: the block-step instantiations' launch counters, by (epilogue, geometry
#: mode, kernel set)
STEP = _counters("")
#: K12's instantiations (compute_dtype 'bf16'), the scenario epilogue's
#: ("K12 in K10") included
STEP_BF16 = _counters("_bf16")
#: K13's instantiations (prng_impl 'rbg'), float32 and bf16
STEP_RBG = _counters("_rbg")
STEP_RBG_BF16 = _counters("_rbg_bf16")
#: the counters of each (rbg keys, compute dtype)
_STEPS = {(False, "f32"): STEP, (False, "bf16"): STEP_BF16,
          (True, "f32"): STEP_RBG, (True, "bf16"): STEP_RBG_BF16}
#: K3: the acc epilogue, shared site, exact set
K3 = STEP["acc", "shared", "exact"]
#: the values of ``compute_dtype=`` (Plan.compute_dtype)
COMPUTE_DTYPES = ("f32", "bf16")
K4_SUM = build.LaunchCounter("series_sum")
#: block-step launches (any epilogue) that apply fleet transforms
K7_FLEET = build.LaunchCounter("block_step_fleet")
#: acc launches of the observer instantiations: telemetry only, analytics
#: only, both
K8 = build.LaunchCounter("block_step_tel")
K9 = build.LaunchCounter("block_step_analytics")
K89 = build.LaunchCounter("block_step_tel_analytics")
#: the second pass of reduce_chainwise (per-CTA partials over CTAs)
COLLAPSE = build.LaunchCounter("chainwise_collapse")
#: every counter of this module: the instantiations in (epilogue,
#: geometry, kernel set) order, then the rest
COUNTERS = tuple(dict.fromkeys(
    [*STEP.values(), *STEP_BF16.values(), *STEP_RBG.values(),
     *STEP_RBG_BF16.values()])) + (K4_SUM, K7_FLEET, K8, K9, K89, COLLAPSE)

#: per-second integer rows: global second, rebased hour / day / minute index
ROWS_I = ("t", "h", "d", "m")
#: per-second float rows of the shared mode: calendar fractions, then
#: block_geometry's fields
ROWS_F = ("hf", "df", "mf", "zenith", "cos_zenith", "apparent_zenith",
          "azimuth", "csi_cap", "ghi_clear", "dni_extra", "airmass_abs",
          "cos_aoi", "doy")
#: the shared rows the host rounds to bf16 under compute_dtype='bf16' (the
#: geometry fields but ``doy``, as the JAX host casts them)
BF16_ROWS = slice(ROWS_F.index("zenith"), ROWS_F.index("doy"))
#: per-second float rows of the site mode: calendar fractions, then the
#: float32-safe split time (the geometry is per chain, on the device)
ROWS_F_SITE = ("hf", "df", "mf", "day2000", "sec_of_day", "doy")
#: per-second float rows of the strided mode: calendar fractions, the
#: second's doy, then the stride samples' split time and doy (``T //
#: stride + 1`` entries, padded to ``T``)
ROWS_F_STRIDE = ("hf", "df", "mf", "doy", "s_day2000", "s_sec_of_day",
                 "s_doy")
#: the geometry fields the site mode derives per chain and second (the
#: order of ``device_geometry_fields``' output)
GEOM_FIELDS = ("zenith", "cos_zenith", "apparent_zenith", "azimuth",
               "csi_cap", "ghi_clear", "dni_extra", "airmass_abs",
               "cos_aoi")
CARRY = ("cloud_end", "total_end", "sec")
ACC_F = ("pv_sum", "pv_max", "meter_sum", "residual_sum", "residual_min",
         "residual_max")

#: threads per CTA of the block-step kernel (one chain per thread)
THREADS = 128
#: the analytics' shared-memory histograms may take this many bytes per
#: CTA (beyond, they count with global atomics)
SMEM_MAX = 96 * 1024
#: the scenario epilogue's stage: one 60-second tile of every chain's
#: meter and pv, in dynamic shared memory (its histograms follow when
#: they fit under ``SMEM_MAX``)
SCN_STAGE_BYTES = 60 * THREADS * 2 * 4

#: the kernel's per-chain observer leaves (``per_chain=True``), in row order
TEL_CHAIN_I = tuple(f"{k}_{f}" for f in tel.TELEMETRY_FIELDS
                    for k in ("nan", "nf")) + ("occ_cov",)
TEL_CHAIN_F = tuple(f"{k}_{f}" for f in tel.TELEMETRY_FIELDS
                    for k in ("min", "max", "sum", "sumsq"))
FLT_CHAIN_I = ("lol_seconds", "lol_events", "lol_run", "seen_ramp_1s",
               "seen_ramp_60s", "seen_ramp_3600s", "cov_count", "n_use")
FLT_CHAIN_F = ("min_res", "max_res", "max_ramp_1s", "max_ramp_60s",
               "max_ramp_3600s", "prev_ramp_1s", "prev_ramp_60s",
               "prev_ramp_3600s", "cohort_sum_meter", "cohort_sum_pv",
               "cohort_sum_residual", "cov_sum_meter", "cov_sum_pv",
               "cov_sum_residual")
#: collapse kinds of the per-CTA partial rows: 0 sum, 1 min, 2 max
TEL_KINDS = (0, 0, 1, 2, 0, 0) * 4 + (0,)
FLT_KINDS = (0, 1, 2, 0, 0, 2, 2, 2, 0, 0, 0, 0, 0, 0, 0)
COH_KINDS = (0, 0, 0, 0, 1, 2)
#: the kernel's per-CTA partial rows and the kinds of one row (the cohort
#: row repeats ``COH_KINDS`` per cohort)
PART_KINDS = {"tel_part": TEL_KINDS, "flt_part": FLT_KINDS,
              "coh_part": COH_KINDS}
#: the scenario epilogue's per-(scenario, chain) risk leaves, kept between
#: its tiles, in row order
SCN_CHAIN_I = ("n_use", "lol_run", "lol_seconds", "lol_events",
               "seen_ramp_1s", "seen_ramp_60s", "seen_ramp_3600s")
SCN_CHAIN_F = ("min_res", "max_res", "max_ramp_1s", "max_ramp_60s",
               "max_ramp_3600s", "prev_ramp_1s", "prev_ramp_60s",
               "prev_ramp_3600s")
#: the kinds of its per-(CTA, scenario) partial row: count, min_res,
#: max_res, lol_seconds, lol_events and the three max_ramp leaves
SCN_KINDS = (0, 1, 2, 0, 0, 2, 2, 2)
#: the scenario knob leaves (``serve.schema.encode_batch``), float32 then
#: int32
SCEN_F = ("demand_scale", "demand_shift_w", "pv_scale", "weather_bias",
          "curtail_w")
SCEN_I = ("horizon_s", "site_index", "cohort")

_BIG = float(np.finfo(np.float32).max)


@dataclasses.dataclass
class SiteGeometry:
    """The per-chain inputs of the site-geometry modes: ``site`` maps each
    ``config.SITE_FIELDS`` entry to an ``(n,)`` float32 tensor,
    ``turbidity`` is the grid's ``(12,)`` monthly Linke climatology;
    ``stride`` > 1 selects the strided mode (K6s; the rows are then
    ``strided_rows``)."""

    site: dict
    turbidity: torch.Tensor
    stride: int = 1

    @property
    def mode(self) -> str:
        return "site" if self.stride <= 1 else "strided"


@dataclasses.dataclass
class FleetLeaves:
    """K7's per-chain inputs: ``(n,)`` float32 tensors of the fleet's
    heterogeneous columns (``None`` for a homogeneous one; the power pair
    and the demand pair go together)."""

    pv_scale: torch.Tensor | None = None
    ac_limit_w: torch.Tensor | None = None
    demand_scale: torch.Tensor | None = None
    demand_shift_w: torch.Tensor | None = None

    def __post_init__(self):
        for a, b in (("pv_scale", "ac_limit_w"),
                     ("demand_scale", "demand_shift_w")):
            if (getattr(self, a) is None) != (getattr(self, b) is None):
                raise ValueError(f"FleetLeaves: {a} and {b} go together")

    def tensors(self):
        return [self.pv_scale, self.ac_limit_w, self.demand_scale,
                self.demand_shift_w]


@dataclasses.dataclass
class Observers:
    """The reduce-mode observers of one acc block: the telemetry level,
    the analytics level with its sketch ``params``, the chains' ``cohort``
    ids (``(n,)`` int32) when ``n_cohorts`` >= 2; ``per_chain`` also
    returns every per-chain leaf and, on the card, the per-CTA partial
    rows under ``partials`` (for checks)."""

    telemetry: str = "off"
    analytics: str = "off"
    params: flt.FleetParams | None = None
    cohort: torch.Tensor | None = None
    n_cohorts: int = 0
    per_chain: bool = False

    def __post_init__(self):
        if self.telemetry not in tel.TELEMETRY_LEVELS:
            raise ValueError(f"Observers: telemetry {self.telemetry!r}")
        if self.analytics not in flt.ANALYTICS_LEVELS:
            raise ValueError(f"Observers: analytics {self.analytics!r}")
        if self.analytics != "off" and self.params is None:
            raise ValueError("Observers: analytics needs params")
        if (self.n_cohorts >= 2) != (self.cohort is not None):
            raise ValueError("Observers: cohort ids go with n_cohorts >= 2")
        if self.cohort is not None and self.cohort.numel() and not (
                int(self.cohort.min()) >= 0
                and int(self.cohort.max()) < self.n_cohorts):
            # the kernel indexes its cohort histograms with these ids
            raise ValueError(f"Observers: cohort ids outside "
                             f"[0, {self.n_cohorts})")


def kernel_constants() -> dict:
    """The constants csrc/block_step.cu reads, from the models."""
    m, inv = SAPM_MODULE, SANDIA_INVERTER
    one_m_beta = 1.0 - dist.CLOUD_LENGTH_BETA
    return {
        "SIGMA_SEC": ci.SIGMA_SEC_FACTOR,
        "SEC_S0": ci.NOISE_CLEAR[0], "SEC_S1X8": ci.NOISE_CLEAR[1] * 8.0,
        "RN_MAX_CYCLE": float(renewal.MAX_CYCLE_S),
        "RN_CC_MIN": 1e-3, "RN_CC_MAX": renewal.MAX_CLOUDCOVER,
        "RN_XMAX_FLOOR": 2.0 * dist.CLOUD_LENGTH_XMIN_M,
        "RN_ONE_M_BETA": one_m_beta,
        "RN_XMIN_POW": dist.CLOUD_LENGTH_XMIN_M ** one_m_beta,
        "RN_INV_ONE_M_BETA": 1.0 / one_m_beta,
        "PV_TWO_PI": pv.TWO_PI, "PV_DEG": pv.DEG,
        "PV_ZEN_MAX": 87.0 * pv.DEG,
        "EXP_T": math.exp(m["T_a"] + m["T_b"] * 0.0),
        "EXP_T_TABLE": pv.cell_temp_factor(m, get_kernels("table")),
        "T_DELTA": m["T_deltaT"], "FD": m["FD"],
        "N_BOLTZ": m["N"] * pv.BOLTZMANN, "ELEM_CHARGE": pv.ELEM_CHARGE,
        "IMPO": m["Impo"], "SC0": m["C0"], "SC1": m["C1"],
        "AIMP": m["Aimp"], "BVMPO": m["Bvmpo"], "MBVMP": m["Mbvmp"],
        "VMPO": m["Vmpo"], "C2NS": m["C2"] * m["Cells_in_Series"],
        "C3NS": m["C3"] * m["Cells_in_Series"],
        "MA": [m["A0"], m["A1"], m["A2"], m["A3"], m["A4"]],
        "MB": [m["B0"], m["B1"], m["B2"], m["B3"], m["B4"], m["B5"]],
        "PACO": inv["Paco"], "VDCO": inv["Vdco"], "PDCO": inv["Pdco"],
        "PSO": inv["Pso"], "IC0": inv["C0"], "IC1": inv["C1"],
        "IC2": inv["C2"], "IC3": inv["C3"], "PNT_NEG": -abs(inv["Pnt"]),
        # site geometry (models/solar.py, python constants as float32)
        "GEO_HALF_PI": np.pi / 2.0,
        "GEO_PARALLAX": solar._PARALLAX,
        "GEO_REFR_T": 283.0 / (273.0 + 12.0),
        "GEO_REFR_MIN": -(0.26667 + 0.5667),
        "GEO_STD_PRESSURE": solar.STD_PRESSURE,
        "GEO_SOLAR_CONSTANT": solar.SOLAR_CONSTANT,
        "LINKE_MIDS": list(solar.LINKE_MIDS),
        # K12: the 128 values of a bf16 normal draw
        "Z_BF16": [float(v) for v in rng.normal_bf16_table()],
    }


def block_rows(block_idx: dict, mlo: int, geom: dict):
    """Pack one block's shared per-second inputs (numpy, from the engine's
    host_inputs) into the ``(4, T)`` int32 and ``(13, T)`` float32 rows."""
    fl = [geom[k] for k in ROWS_F[3:]]
    return _rows(block_idx, mlo, fl)


def site_rows(block_idx: dict, mlo: int, time_split: dict):
    """The site mode's rows: ``(4, T)`` int32 and ``(6, T)`` float32 (the
    calendar fractions and the split time)."""
    return _rows(block_idx, mlo, [time_split[k] for k in ROWS_F_SITE[3:]])


def strided_rows(block_idx: dict, mlo: int, doy, samples: dict):
    """The strided mode's rows: ``(4, T)`` int32 and ``(7, T)`` float32
    (the calendar fractions, the second's doy, then the ``S = T // stride
    + 1`` stride samples' ``day2000``, ``sec_of_day`` and ``doy`` from
    ``samples``, zero-padded to ``T``)."""
    T = len(doy)
    pad = []
    for k in ("day2000", "sec_of_day", "doy"):
        v = np.zeros(T, np.float32)
        v[:len(samples[k])] = samples[k]
        pad.append(v)
    return _rows(block_idx, mlo, [doy] + pad)


def _rows(block_idx, mlo, tail):
    ints = np.stack([block_idx["t"], block_idx["hour_idx"],
                     block_idx["day_idx"],
                     block_idx["min_idx"] - np.int32(mlo)]).astype(np.int32)
    fl = [block_idx["hour_frac"], block_idx["day_frac"],
          block_idx["min_frac"]] + list(tail)
    return ints, np.stack(fl).astype(np.float32)


def _geometry(rows_f, surface_tilt, albedo, site: SiteGeometry | None,
              kernels: str = "exact"):
    """The ``power_from_csi`` geometry of a block: the shared rows as
    ``(T, 1)`` columns, or every chain's device geometry ``(T, n)``; in
    the strided mode the device geometry of the ``(S, n)`` sample grid,
    lerped to ``(T, n)`` as the JAX scan does (``interp_sampled``) with
    the second's own doy."""
    if site is None:
        g = {k: rows_f[i][:, None] for i, k in enumerate(ROWS_F)}
        g["surface_tilt"] = surface_tilt
        g["albedo"] = albedo
        return g
    s = site.site
    ks = get_kernels(kernels)
    if site.stride <= 1:
        r = {k: rows_f[i][:, None] for i, k in enumerate(ROWS_F_SITE)}
        return solar.device_geometry(
            r["day2000"], r["sec_of_day"], r["doy"], s["latitude"],
            s["longitude"], s["altitude"], s["surface_tilt"],
            s["surface_azimuth"], s["albedo"], site.turbidity, ks)
    samp, gi, gf = _stride_samples(rows_f, site, kernels)
    g = solar.interp_sampled(samp, gi, gf)
    g["doy"] = rows_f[ROWS_F_STRIDE.index("doy")][:, None]
    g["surface_tilt"] = s["surface_tilt"]
    g["albedo"] = s["albedo"]
    return g


def _stride_samples(rows_f, site: SiteGeometry, kernels: str):
    """The strided mode's float32 device geometry on the ``(S, n)``
    sample grid, and each second's sample index and fraction."""
    s = site.site
    T = rows_f.shape[1]
    solar.check_stride(T, site.stride)
    S = T // site.stride + 1
    r = {k: rows_f[i][:S, None] for i, k in enumerate(ROWS_F_STRIDE)}
    samp = solar.device_geometry(
        r["s_day2000"], r["s_sec_of_day"], r["s_doy"], s["latitude"],
        s["longitude"], s["altitude"], s["surface_tilt"],
        s["surface_azimuth"], s["albedo"], site.turbidity,
        get_kernels(kernels))
    gi, gf = solar.stride_weights(T, site.stride)
    dev = rows_f.device
    return (samp, torch.from_numpy(gi).long().to(dev),
            torch.from_numpy(gf.astype(np.float32)).to(dev))


def _geometry_bf16(rows_f, surface_tilt, albedo, site: SiteGeometry | None,
                   kernels: str = "exact"):
    """:func:`_geometry` on the bf16 path, as models/bf16.py values: the
    shared rows (rounded to bf16 by the host, ``doy`` float32) with the
    site's python-float tilt and albedo; per chain the float32 device
    geometry narrowed to bf16 (tilt and albedo too, ``doy`` float32); in
    the strided mode the samples narrowed, then lerped in bf16 at the
    fraction rounded to bf16."""
    if site is None:
        g = {k: mx.bf16_input(rows_f[i][:, None])
             for i, k in enumerate(ROWS_F) if k != "doy"}
        g["doy"] = rows_f[ROWS_F.index("doy")][:, None]
        g["surface_tilt"] = surface_tilt
        g["albedo"] = albedo
        return g
    if site.stride <= 1:
        g = _geometry(rows_f, None, None, site, kernels)
        return {k: v if k == "doy" else mx.bf16_input(v)
                for k, v in g.items()}
    s = site.site
    g = solar.interp_sampled_bf16(*_stride_samples(rows_f, site, kernels))
    g["doy"] = rows_f[ROWS_F_STRIDE.index("doy")][:, None]
    g["surface_tilt"] = mx.bf16_input(s["surface_tilt"])
    g["albedo"] = mx.bf16_input(s["albedo"])
    return g


def fleet_transform_plain(meter, ac, fleet: FleetLeaves | None):
    """K7's plain version: ``ac = min(ac * pv_scale, ac_limit_w)`` and
    ``meter = meter * demand_scale + demand_shift_w`` rounded once (the
    JAX scan's contraction), for the columns the fleet makes
    heterogeneous; ``(T, n)`` or ``(n,)`` against ``(n,)`` leaves."""
    if fleet is not None and fleet.pv_scale is not None:
        ac = torch.minimum(ac * fleet.pv_scale, fleet.ac_limit_w)
    if fleet is not None and fleet.demand_scale is not None:
        meter = rng.fma(meter, fleet.demand_scale, fleet.demand_shift_w)
    return meter, ac


def _body_plain(tables, rows_i, rows_f, k_scan, k_meter, carry,
                meter_max_w, surface_tilt, albedo, site, fleet=None,
                kernels="exact", compute_dtype="f32", bf16_draws=True,
                layout="scan"):
    """The pre-fold body every epilogue shares: everything carry-
    independent over the whole block at once, the renewal compare/select
    second by second, then the fleet transforms.  Returns ``(carry,
    meter, ac, csi, covered)`` with time-major ``(T, n)`` arrays (csi
    before the cap, as the telemetry reads it).  ``compute_dtype='bf16'``
    runs K12's arithmetic: u / z drawn in bf16 when ``bf16_draws`` (the
    acc and series epilogues), the physics on bf16 geometry and csi.
    ``layout`` is the JAX formulation's draw layout
    (``clearsky_index.DRAW_LAYOUTS``), which only rbg keys tell apart."""
    T = rows_i.shape[1]
    g0 = int(rows_i[0, 0]) // 60
    bf = compute_dtype == "bf16"
    lay = layout if rng.is_rbg(k_scan) else "scan"
    u, z = ci.scan_draws_tmajor(
        k_scan, g0, T // 60,
        torch.bfloat16 if bf and bf16_draws else torch.float32, lay)
    u, z = u.float(), z.float()
    meter = ci.meter_block_tmajor(k_meter, g0, T // 60, meter_max_w, lay)
    x = {"h": rows_i[1].long(), "d": rows_i[2].long(), "m": rows_i[3].long(),
         "hf": rows_f[0][:, None], "df": rows_f[1][:, None],
         "mf": rows_f[2][:, None], "z": z}
    ins = ci.csi_inputs(tables, x)
    cloud, total = renewal.cycle_from_u(u, ins["cc_t"], ins["ws_t"])
    carry = dict(carry)
    covered = torch.empty_like(cloud, dtype=torch.bool)
    for s in range(T):
        carry, covered[s] = renewal.step_from_cycle(carry, cloud[s], total[s])
    csi = ci.compose(ins, covered)
    if bf:
        ac = pv.power_from_csi_bf16(
            csi, _geometry_bf16(rows_f, surface_tilt, albedo, site, kernels),
            SAPM_MODULE, SANDIA_INVERTER, kernels)
    else:
        ac = pv.power_from_csi(csi, _geometry(rows_f, surface_tilt, albedo,
                                              site, kernels),
                               SAPM_MODULE, SANDIA_INVERTER,
                               get_kernels(kernels))
    meter, ac = fleet_transform_plain(meter, ac, fleet)
    return carry, meter, ac, csi, covered


def stats_fold_plain(acc, t, duration_s, meter, ac, second_hook=None,
                     valid=None):
    """The statistics fold of time-major ``(T, n)`` meter and pv second by
    second (in second order, as the scan adds; ``t``: the ``(T,)`` global
    seconds); ``second_hook(s, valid, residual_s)`` runs after each
    second's fold (the observers).  ``valid``: a ``(T, n)`` mask in place
    of the duration mask ``t < duration_s`` (the scenario fold's)."""
    residual = meter - ac
    T = t.shape[0]
    if valid is None:
        valid = t < duration_s
    vz = valid.to(torch.float32)
    big = torch.tensor(_BIG, dtype=torch.float32, device=ac.device)
    acc = dict(acc)
    for s in range(T):
        ok, w = valid[s], vz[s]
        acc["pv_sum"] = acc["pv_sum"] + ac[s] * w
        acc["pv_max"] = torch.maximum(acc["pv_max"],
                                      torch.where(ok, ac[s], -big))
        acc["meter_sum"] = acc["meter_sum"] + meter[s] * w
        acc["residual_sum"] = acc["residual_sum"] + residual[s] * w
        acc["residual_min"] = torch.minimum(
            acc["residual_min"], torch.where(ok, residual[s], big))
        acc["residual_max"] = torch.maximum(
            acc["residual_max"], torch.where(ok, residual[s], -big))
        acc["n_seconds"] = acc["n_seconds"] + ok.to(torch.int32)
        if second_hook is not None:
            second_hook(s, ok, residual[s])
    return acc


def block_step_plain(tables, rows_i, rows_f, k_scan, k_meter, carry, acc,
                     duration_s: int, meter_max_w: float,
                     surface_tilt, albedo, site: SiteGeometry | None = None,
                     fleet: FleetLeaves | None = None,
                     kernels: str = "exact", compute_dtype: str = "f32",
                     layout: str = "scan"):
    """Plain torch K3 / K6 / K6s / K12 / K13 (the ``acc`` epilogue, with
    K7's transforms): the shared body, then the statistics fold.  Returns
    ``(carry, acc)``."""
    carry, meter, ac, _, _ = _body_plain(
        tables, rows_i, rows_f, k_scan, k_meter, carry, meter_max_w,
        surface_tilt, albedo, site, fleet, kernels, compute_dtype,
        layout=layout)
    return carry, stats_fold_plain(acc, rows_i[0], duration_s, meter, ac)


def block_step_obs_plain(tables, rows_i, rows_f, k_scan, k_meter, carry,
                         acc, duration_s: int, meter_max_w: float,
                         surface_tilt, albedo,
                         site: SiteGeometry | None = None,
                         fleet: FleetLeaves | None = None,
                         obs: Observers = None, kernels: str = "exact",
                         compute_dtype: str = "f32", layout: str = "scan"):
    """Plain K8 / K9: the acc epilogue with the observers' per-chain folds
    (obs/telemetry.py and obs/analytics.py ``fold_second``, zero-
    initialised for the block) beside the statistics, then their
    ``reduce_chainwise``.  Returns ``(carry, acc, out)``; ``out`` holds
    the block's collapsed ``telemetry`` and ``fleet`` deltas (None when
    off) and, with ``obs.per_chain``, the per-chain accs under
    ``telemetry_chain`` / ``fleet_chain``."""
    carry, meter, ac, csi, covered = _body_plain(
        tables, rows_i, rows_f, k_scan, k_meter, carry, meter_max_w,
        surface_tilt, albedo, site, fleet, kernels, compute_dtype,
        layout=layout)
    n, dev = ac.shape[1], ac.device
    cohorts = obs.n_cohorts if obs.n_cohorts >= 2 else 0
    st = {"ta": None if obs.telemetry == "off" else
          tel.init_acc(obs.telemetry, n, dev),
          "fa": None if obs.analytics == "off" else
          flt.init_acc(obs.analytics, n, params=obs.params,
                       cohorts=cohorts, device=dev)}
    t_rows = rows_i[0].tolist()

    def hook(s, ok, res):
        if st["ta"] is not None:
            st["ta"] = tel.fold_second(
                st["ta"], obs.telemetry, meter=meter[s], pv=ac[s],
                csi=csi[s], residual=res, covered=covered[s], valid=ok)
        if st["fa"] is not None:
            st["fa"] = flt.fold_second(
                st["fa"], obs.analytics, obs.params, meter=meter[s],
                pv=ac[s], residual=res, covered=covered[s], t=t_rows[s],
                valid=ok, cohort=obs.cohort)

    acc = stats_fold_plain(acc, rows_i[0], duration_s, meter, ac, hook)
    ta, fa = st["ta"], st["fa"]
    out = {"telemetry": None if ta is None else tel.reduce_chainwise(ta),
           "fleet": None if fa is None else
           flt.reduce_chainwise(fa, cohort=obs.cohort)}
    if obs.per_chain:
        out["telemetry_chain"], out["fleet_chain"] = ta, fa
    return carry, acc, out


def _scenario_check(scen):
    """The knob leaves of a scenario batch: ``(B,)`` float32 ``SCEN_F``
    and int32 ``SCEN_I`` tensors.  Returns ``B``."""
    B = scen["horizon_s"].shape[0]
    for k in SCEN_F + SCEN_I:
        t = scen[k]
        want = torch.float32 if k in SCEN_F else torch.int32
        if t.dtype != want or t.shape != (B,):
            raise ValueError(f"block_step_scenario: scen[{k!r}] must be a "
                             f"({B},) {want} tensor")
    return B


def scenario_transform_plain(meter, ac, scen, b):
    """Row ``b``'s transform of the step's meter and pv:
    ``meter * demand_scale + demand_shift_w`` rounded once (the JAX scan
    contracts it into a multiply-add; tests/test_torch_serve.py settles
    it), ``min(ac * (pv_scale * weather_bias), curtail_w)``, and the
    residual."""
    m = rng.fma(meter, scen["demand_scale"][b], scen["demand_shift_w"][b])
    p = torch.minimum(ac * (scen["pv_scale"][b] * scen["weather_bias"][b]),
                      scen["curtail_w"][b])
    return m, p, m - p


def scenario_valid_plain(rows_i, duration_s, scen, b, n, cohort=None):
    """Row ``b``'s ``(T, n)`` validity: the site selector (the chain's
    index against ``site_index``), the cohort selector (when ``cohort``,
    the chains' ids, is given), ``t < duration_s`` and ``t < horizon_s``."""
    dev = rows_i.device
    iota = torch.arange(n, device=dev, dtype=torch.int32)
    site = scen["site_index"][b]
    sel = (site < 0) | (iota == site)
    if cohort is not None:
        c = scen["cohort"][b]
        sel = sel & ((c < 0) | (cohort == c))
    t = rows_i[0]
    return sel[None, :] & ((t < duration_s) & (t < scen["horizon_s"][b])
                           )[:, None]


def scenario_plain(tables, rows_i, rows_f, k_scan, k_meter, carry, acc,
                   duration_s: int, meter_max_w: float, surface_tilt,
                   albedo, site: SiteGeometry | None = None,
                   fleet: FleetLeaves | None = None, scen: dict = None,
                   params: flt.FleetParams = None, cohort=None,
                   per_chain: bool = False, kernels: str = "exact",
                   compute_dtype: str = "f32"):
    """Plain K10 (under bf16 K12 in K10): the shared body (K3's step with
    K7's transforms, the flat scan's draw layout), then
    for each scenario row its transform, validity and the statistics fold
    into ``acc`` (``(B, n)`` leaves) beside a zero-initialised ``risk``
    FleetAcc (obs/analytics.py ``fold_second`` / ``reduce_chainwise``).
    Returns ``(carry, acc, delta)``: ``delta`` holds the block's collapsed
    FleetAcc of each row (``(B, ...)`` leaves) and, with ``per_chain``,
    ``chain``, each row's per-chain FleetAcc (``(B, n)`` leaves)."""
    B = _scenario_check(scen)
    carry, meter, ac, _, _ = _body_plain(
        tables, rows_i, rows_f, k_scan, k_meter, carry, meter_max_w,
        surface_tilt, albedo, site, fleet, kernels, compute_dtype)
    n, dev = ac.shape[1], ac.device
    t_rows = rows_i[0].tolist()
    out = {k: v.clone() for k, v in acc.items()}
    deltas, chains = [], []
    for b in range(B):
        m, p, r = scenario_transform_plain(meter, ac, scen, b)
        valid = scenario_valid_plain(rows_i, duration_s, scen, b, n, cohort)
        st = {"fa": flt.init_acc("risk", n, params=params, device=dev)}

        def hook(s, ok, res):
            st["fa"] = flt.fold_second(
                st["fa"], "risk", params, meter=m[s], pv=p[s], residual=res,
                covered=None, t=t_rows[s], valid=ok)

        row = stats_fold_plain({k: v[b] for k, v in acc.items()}, rows_i[0],
                               duration_s, m, p, hook, valid=valid)
        for k, v in row.items():
            out[k][b] = v
        deltas.append(flt.reduce_chainwise(st["fa"]))
        chains.append(st["fa"])
    delta = {k: torch.stack([d[k] for d in deltas]) for k in deltas[0]}
    if per_chain:
        delta["chain"] = {k: torch.stack([c[k] for c in chains])
                          for k in chains[0] if chains[0][k].shape == (n,)}
    return carry, out, delta


def series_plain(tables, rows_i, rows_f, k_scan, k_meter, carry,
                 meter_max_w: float, surface_tilt, albedo,
                 site: SiteGeometry | None = None,
                 fleet: FleetLeaves | None = None, kernels: str = "exact",
                 compute_dtype: str = "f32", layout: str = "scan"):
    """Plain K4 series: the shared body, then each second's cross-chain
    sums of meter and pv (accumulated in float64, rounded once to
    float32).  Returns ``(carry, meter_sum, pv_sum)``, each ``(T,)``;
    padding seconds are summed too (the engine trims them)."""
    carry, meter, ac, _, _ = _body_plain(
        tables, rows_i, rows_f, k_scan, k_meter, carry, meter_max_w,
        surface_tilt, albedo, site, fleet, kernels, compute_dtype,
        layout=layout)
    return (carry, meter.double().sum(1).float(),
            ac.double().sum(1).float())


def trace_plain(tables, rows_i, rows_f, k_scan, k_meter, carry,
                meter_max_w: float, surface_tilt, albedo,
                site: SiteGeometry | None = None,
                fleet: FleetLeaves | None = None, kernels: str = "exact",
                compute_dtype: str = "f32", layout: str = "trace"):
    """Plain K4 trace: the shared body's every chain-second.  Returns
    ``(carry, meter, pv)`` with time-major ``(T, n)`` arrays.  Under bf16
    the u / z draws stay float32, as in the JAX ``_block_step``."""
    return _body_plain(tables, rows_i, rows_f, k_scan, k_meter, carry,
                       meter_max_w, surface_tilt, albedo, site, fleet,
                       kernels, compute_dtype, bf16_draws=False,
                       layout=layout)[:3]


def cos_tilt(surface_tilt: float, kernels: str = "exact") -> float:
    """cos of the panel tilt as the plain version computes it (float32,
    with the kernel set's cos)."""
    return float(get_kernels(kernels).cos(
        torch.tensor(surface_tilt * pv.DEG, dtype=torch.float32)))


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
#: the arguments every block-step entry takes, before its outputs
_COMMON = ([ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float] + [_P] * 21)
#: the block-step library of each (kernel set, compute dtype, rbg keys)
_LIBRARY = {("exact", "f32", False): "block_step.cu",
            ("table", "f32", False): "block_step_table.cu",
            ("exact", "bf16", False): "block_step_bf16.cu",
            ("table", "bf16", False): "block_step_bf16_table.cu",
            ("exact", "f32", True): "block_step_rbg.cu",
            ("table", "f32", True): "block_step_rbg_table.cu",
            ("exact", "bf16", True): "block_step_rbg_bf16.cu",
            ("table", "bf16", True): "block_step_rbg_bf16_table.cu"}
#: the kernel's code of each draw layout (csrc/block_step.cuh ``Layout``)
LAYOUTS = {"scan": 0, "scan2": 1, "trace": 2}


class _Obs(ctypes.Structure):
    """ctypes mirror of csrc/block_step.cu's ``Obs``."""

    _fields_ = [("tel_full", ctypes.c_int), ("tel_part", _P),
                ("csi_hist", _P), ("tel_count", _P), ("tel_chain_i", _P),
                ("tel_chain_f", _P), ("flt_full", ctypes.c_int),
                ("bins", ctypes.c_int), ("n_thr", ctypes.c_int),
                ("lolp_k", ctypes.c_int), ("n_cohorts", ctypes.c_int),
                ("hist_shared", ctypes.c_int), ("coh_shared", ctypes.c_int),
                ("ramp_w", ctypes.c_int * 3), ("lo", ctypes.c_float),
                ("inv_w", ctypes.c_float), ("capacity", ctypes.c_float),
                ("thr", _P), ("res_hist", _P), ("exceed", _P),
                ("cohort_hist", _P), ("cohort", _P), ("flt_part", _P),
                ("coh_part", _P), ("flt_chain_i", _P), ("flt_chain_f", _P)]


class _Scen(ctypes.Structure):
    """ctypes mirror of csrc/block_step.cu's ``Scen``."""

    _fields_ = [("B", ctypes.c_int), ("bins", ctypes.c_int),
                ("n_thr", ctypes.c_int), ("lolp_k", ctypes.c_int),
                ("hist_shared", ctypes.c_int), ("ramp_w", ctypes.c_int * 3),
                ("lo", ctypes.c_float), ("inv_w", ctypes.c_float),
                ("capacity", ctypes.c_float), ("thr", _P),
                ("knob_f", _P * len(SCEN_F)), ("knob_i", _P * len(SCEN_I)),
                ("cohort", _P), ("res_hist", _P), ("exceed", _P),
                ("chain_i", _P), ("chain_f", _P), ("part", _P)]


def _check(t, dtype, dev, what):
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"block_step: {what} must be a contiguous "
                         f"{dtype} tensor on {dev}")


def _geo_mode(site: SiteGeometry | None) -> str:
    return "shared" if site is None else site.mode


def _common_args(tables, rows_i, rows_f, k_scan, k_meter, carry,
                 duration_s, meter_max_w, surface_tilt, albedo, site,
                 fleet=None, kernels="exact", layout="scan"):
    """Validate the shared inputs and return the C arguments they fill."""
    n = k_scan.shape[0]
    if layout not in LAYOUTS:
        raise ValueError(f"block_step: unknown draw layout {layout!r}")
    width = k_scan.shape[-1]
    if k_scan.shape != (n, width) or width not in (2, 4) or \
            k_meter.shape != (n, width):
        raise ValueError("block_step: k_scan and k_meter must be (n, 2) "
                         "threefry or (n, 4) rbg keys")
    T = rows_i.shape[1]
    dev = k_scan.device
    if T % 60:
        raise ValueError("block length must be a multiple of 60 seconds")
    if kernels not in KERNEL_IMPLS:
        raise ValueError(f"block_step: unknown kernel set {kernels!r}")
    geo = _geo_mode(site)
    if geo == "strided":
        solar.check_stride(T, site.stride)
    names = {"shared": ROWS_F, "site": ROWS_F_SITE,
             "strided": ROWS_F_STRIDE}[geo]
    if rows_i.shape != (len(ROWS_I), T) or rows_f.shape != (len(names), T):
        raise ValueError(f"block_step: rows must be ({len(ROWS_I)}, T) int32 "
                         f"and ({len(names)}, T) float32")
    _check(rows_i, torch.int32, dev, "rows_i")
    _check(rows_f, torch.float32, dev, "rows_f")
    for k in ("cc", "cloudy", "clear_day", "ws", "ml", "mc"):
        _check(tables[k], torch.float32, dev, f"table {k}")
        if tables[k].shape[1:] != (n,):
            raise ValueError(f"block_step: table {k} must be (w, {n})")
    for k in CARRY:
        _check(carry[k], torch.float32, dev, f"carry {k}")
    _check(k_scan, torch.int64, dev, "k_scan")
    _check(k_meter, torch.int64, dev, "k_meter")
    p = build.ptr
    if site is None:
        geo_p = [None] * 7
        ct, alb = cos_tilt(surface_tilt, kernels), albedo
    else:
        if surface_tilt is not None or albedo is not None:
            raise ValueError("block_step: the site mode takes tilt and "
                             "albedo per chain from site=")
        for k in SITE_FIELDS:
            _check(site.site[k], torch.float32, dev, f"site {k}")
            if site.site[k].shape != (n,):
                raise ValueError(f"block_step: site {k} must be ({n},)")
        _check(site.turbidity, torch.float32, dev, "turbidity")
        if site.turbidity.shape != (12,):
            raise ValueError("block_step: turbidity must be (12,)")
        geo_p = [p(site.site[k]) for k in SITE_FIELDS] + [p(site.turbidity)]
        ct, alb = 0.0, 0.0
    leaves = [None] * 4 if fleet is None else fleet.tensors()
    for t in leaves:
        if t is not None:
            _check(t, torch.float32, dev, "fleet leaf")
            if t.shape != (n,):
                raise ValueError(f"block_step: fleet leaves must be ({n},)")
    args = [GEOMS.index(geo), 1 if site is None else site.stride,
            LAYOUTS[layout], n, T,
            int(duration_s), meter_max_w, ct, alb, p(rows_i), p(rows_f),
            *(p(tables[k]) for k in ("cc", "cloudy", "clear_day", "ws", "ml",
                                     "mc")),
            p(k_scan), p(k_meter), *geo_p,
            *(None if t is None else p(t) for t in leaves)]
    return n, T, dev, args


def _library(kernels: str, compute_dtype: str, rbg: bool = False) -> str:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"block_step: compute_dtype {compute_dtype!r} "
                         f"must be one of {COMPUTE_DTYPES}")
    return _LIBRARY[kernels, compute_dtype, bool(rbg)]


def _count(epi: str, site, fleet, kernels: str, compute_dtype: str = "f32",
           rbg: bool = False):
    _STEPS[bool(rbg), compute_dtype][epi, _geo_mode(site),
                                     kernels].launches += 1
    if fleet is not None and any(t is not None for t in fleet.tensors()):
        K7_FLEET.launches += 1


_consts: dict = {}


def _const_tensor(values, dtype, dev):
    """A small constant tensor on ``dev``, made once (no copy per block)."""
    key = (tuple(values), dtype, str(dev))
    t = _consts.get(key)
    if t is None:
        t = _consts[key] = torch.tensor(list(values), dtype=dtype,
                                        device=dev)
    return t


def collapse_plain(part, kinds):
    """Plain second pass: ``(n_parts, L)`` float64 partial rows combined
    over the rows, by kind (0 sum, 1 min, 2 max); ``(L,)`` float64."""
    k = torch.as_tensor(kinds, device=part.device)
    return torch.where(k == 0, part.sum(0),
                       torch.where(k == 1, part.min(0).values,
                                   part.max(0).values))


def collapse_partials(part, kinds):
    """reduce_chainwise's second pass on the card: the ``(n_parts, L)``
    float64 per-CTA partial rows combined over the rows in index order
    (sums in float64), one thread per leaf."""
    n_parts, L = part.shape
    out = torch.empty(L, dtype=torch.float64, device=part.device)
    fn = build.entry("block_step.cu", "collapse_partials",
                     [ctypes.c_int, ctypes.c_int] + [_P] * 3)
    p = build.ptr
    rc = fn(n_parts, L, p(_const_tensor(kinds, torch.int32, part.device)),
            p(part), p(out), build.stream_ptr(part.device))
    build.check(rc, "collapse_partials")
    COLLAPSE.launches += 1
    return out


def _obs_buffers(obs: Observers, n: int, T: int, dev):
    """The observers' outputs and the kernel's ``Obs`` argument."""
    if n * T >= 2 ** 31:
        raise ValueError(f"block_step: {n} chains x {T} s passes the int32 "
                         "counts of one block")
    p = build.ptr
    n_ctas = (n + THREADS - 1) // THREADS
    o = _Obs()
    buf = {}

    def zeros(name, shape, dtype):
        buf[name] = torch.zeros(shape, dtype=dtype, device=dev)
        return p(buf[name])

    def empty(name, shape, dtype):
        buf[name] = torch.empty(shape, dtype=dtype, device=dev)
        return p(buf[name])

    smem = 0
    if obs.telemetry != "off":
        o.tel_full = int(obs.telemetry == "full")
        o.tel_part = empty("tel_part", (n_ctas, len(TEL_KINDS)),
                           torch.float64)
        o.csi_hist = zeros("csi_hist", (tel.CSI_HIST_BINS,), torch.int32)
        o.tel_count = empty("tel_count", (1,), torch.float32)
        if obs.per_chain:
            o.tel_chain_i = empty("tel_chain_i", (len(TEL_CHAIN_I), n),
                                  torch.int32)
            o.tel_chain_f = empty("tel_chain_f", (len(TEL_CHAIN_F), n),
                                  torch.float32)
    if obs.analytics != "off":
        prm = obs.params
        if len(prm.ramp_windows) != 3:
            raise ValueError("block_step: the kernel folds exactly three "
                             "ramp windows")
        nb, ne = prm.bins + 2, len(prm.thresholds) + 1
        C = obs.n_cohorts if obs.cohort is not None else 0
        hist_bytes, coh_bytes = 4 * (nb + ne), 4 * C * nb
        hist_shared = hist_bytes <= SMEM_MAX
        coh_shared = bool(C) and hist_shared and \
            hist_bytes + coh_bytes <= SMEM_MAX
        smem = hist_bytes * hist_shared + coh_bytes * coh_shared
        o.flt_full = int(obs.analytics == "full")
        o.bins, o.n_thr, o.lolp_k = prm.bins, ne - 1, prm.lolp_k
        o.n_cohorts, o.hist_shared, o.coh_shared = C, hist_shared, coh_shared
        o.ramp_w[:] = list(prm.ramp_windows)
        o.lo, o.inv_w, o.capacity = prm.lo, prm.inv_w, prm.capacity_w
        o.thr = p(_const_tensor(prm.thresholds, torch.float32, dev))
        o.res_hist = zeros("res_hist", (nb,), torch.int32)
        o.exceed = zeros("exceed", (ne,), torch.int32)
        o.flt_part = empty("flt_part", (n_ctas, len(FLT_KINDS)),
                           torch.float64)
        if C:
            _check(obs.cohort, torch.int32, dev, "cohort")
            o.cohort = p(obs.cohort)
            o.cohort_hist = zeros("cohort_hist", (C, nb), torch.int32)
            o.coh_part = empty("coh_part", (n_ctas, C * len(COH_KINDS)),
                               torch.float64)
        if obs.per_chain:
            o.flt_chain_i = empty("flt_chain_i", (len(FLT_CHAIN_I), n),
                                  torch.int32)
            o.flt_chain_f = empty("flt_chain_f", (len(FLT_CHAIN_F), n),
                                  torch.float32)
    return o, buf, smem


def _obs_outputs(obs: Observers, buf: dict, T: int) -> dict:
    """The observers' collapsed deltas (the JAX package's leaf names and
    dtypes) from the kernel's partial rows and histograms."""
    out = {"telemetry": None, "fleet": None}
    if obs.telemetry != "off":
        t = collapse_partials(buf["tel_part"], TEL_KINDS)
        count = buf["tel_count"][0]
        d = {"count": count}
        for k, f in enumerate(tel.TELEMETRY_FIELDS):
            o = 6 * k
            d[f"nan_{f}"] = t[o].to(torch.int32)
            d[f"inf_{f}"] = (t[o + 1] - t[o]).to(torch.int32)
            d[f"min_{f}"] = t[o + 2].float()
            d[f"max_{f}"] = t[o + 3].float()
            d[f"sum_{f}"] = t[o + 4].float()
            d[f"sumsq_{f}"] = t[o + 5].float()
        if obs.telemetry == "full":
            d["csi_hist"] = buf["csi_hist"].float()
            cov = t[24].float()
            d["occupancy"] = torch.stack([count - cov, cov])
        out["telemetry"] = d
        if obs.per_chain:
            out["telemetry_chain"] = {
                **dict(zip(TEL_CHAIN_I, buf["tel_chain_i"])),
                **dict(zip(TEL_CHAIN_F, buf["tel_chain_f"]))}
    if obs.analytics != "off":
        prm = obs.params
        f = collapse_partials(buf["flt_part"], FLT_KINDS)
        d = {"count": f[0].to(torch.int32), "res_hist": buf["res_hist"],
             "exceed": buf["exceed"], "min_res": f[1].float(),
             "max_res": f[2].float(), "lol_seconds": f[3].to(torch.int32),
             "lol_events": f[4].to(torch.int32)}
        for k, w in enumerate(prm.ramp_windows):
            d[f"max_ramp_{w}s"] = f[5 + k].float()
        if "coh_part" in buf:
            C = obs.n_cohorts
            c = collapse_partials(buf["coh_part"],
                                  COH_KINDS * C).view(C, len(COH_KINDS))
            d["cohort_count"] = c[:, 0].to(torch.int32)
            d["cohort_hist"] = buf["cohort_hist"]
            d["min_cohort_res"] = c[:, 4].float()
            d["max_cohort_res"] = c[:, 5].float()
            for k, name in enumerate(("meter", "pv", "residual")):
                d[f"cohort_sum_{name}"] = c[:, 1 + k].float()
        if obs.analytics == "full":
            d["regime_observed"] = _const_tensor((int(T > 0),),
                                                 torch.int32, f.device)[0]
            d["cov_count"] = f[8].to(torch.int32)
            for k, name in enumerate(("meter", "pv", "residual")):
                d[f"sum_{name}"] = f[9 + k].float()
                d[f"cov_sum_{name}"] = f[12 + k].float()
        out["fleet"] = d
        if obs.per_chain:
            out["fleet_chain"] = {
                **dict(zip(FLT_CHAIN_I, buf["flt_chain_i"])),
                **dict(zip(FLT_CHAIN_F, buf["flt_chain_f"]))}
    if obs.per_chain:
        out["partials"] = {k: buf[k] for k in PART_KINDS if k in buf}
    return out


_obs_size_checked: set = set()


def _block_step_cuda(tables, rows_i, rows_f, k_scan, k_meter, carry, acc,
                     duration_s, meter_max_w, surface_tilt, albedo, site,
                     fleet=None, obs: Observers | None = None,
                     kernels="exact", compute_dtype="f32", layout="scan"):
    n, T, dev, args = _common_args(tables, rows_i, rows_f, k_scan, k_meter,
                                   carry, duration_s, meter_max_w,
                                   surface_tilt, albedo, site, fleet, kernels,
                                   layout)
    rbg = rng.is_rbg(k_scan)
    lib = _library(kernels, compute_dtype, rbg)
    for k in ACC_F:
        _check(acc[k], torch.float32, dev, f"acc {k}")
    _check(acc["n_seconds"], torch.int32, dev, "acc n_seconds")
    fn = build.entry(lib, "block_step_acc",
                     _COMMON + [_P] * 11 + [ctypes.c_int] * 3)
    tel_on = obs is not None and obs.telemetry != "off"
    flt_on = obs is not None and obs.analytics != "off"
    o, buf, smem = (None, {}, 0)
    if tel_on or flt_on:
        if lib not in _obs_size_checked:
            size = build.entry(lib, "obs_struct_size", [])
            if size(None) != ctypes.sizeof(_Obs):
                raise RuntimeError("block_step: the Obs layout differs "
                                   "between the kernel and its wrapper")
            _obs_size_checked.add(lib)
        o, buf, smem = _obs_buffers(obs, n, T, dev)
    p = build.ptr
    rc = fn(*args, *(p(carry[k]) for k in CARRY),
            *(p(acc[k]) for k in ACC_F), p(acc["n_seconds"]),
            None if o is None else ctypes.byref(o), int(tel_on),
            int(flt_on), smem, build.stream_ptr(dev))
    build.check(rc, "block_step_acc")
    _count("acc", site, fleet, kernels, compute_dtype, rbg)
    if tel_on or flt_on:
        (K89 if tel_on and flt_on else K8 if tel_on else K9).launches += 1
    if o is None:
        return carry, acc
    return carry, acc, _obs_outputs(obs, buf, T)


_scen_size_checked: set = set()


def _scenario_cuda(tables, rows_i, rows_f, k_scan, k_meter, carry, acc,
                   duration_s, meter_max_w, surface_tilt, albedo, site=None,
                   fleet=None, scen=None, params=None, cohort=None,
                   per_chain=False, kernels="exact", compute_dtype="f32"):
    n, T, dev, args = _common_args(tables, rows_i, rows_f, k_scan, k_meter,
                                   carry, duration_s, meter_max_w,
                                   surface_tilt, albedo, site, fleet, kernels)
    rbg = rng.is_rbg(k_scan)
    lib = _library(kernels, compute_dtype, rbg)
    B = _scenario_check(scen)
    for k in SCEN_F + SCEN_I:
        _check(scen[k], scen[k].dtype, dev, f"scen {k}")
    for k in ACC_F:
        _check(acc[k], torch.float32, dev, f"acc {k}")
        if acc[k].shape != (B, n):
            raise ValueError(f"block_step_scenario: acc {k} must be "
                             f"({B}, {n})")
    _check(acc["n_seconds"], torch.int32, dev, "acc n_seconds")
    if acc["n_seconds"].shape != (B, n):
        raise ValueError(f"block_step_scenario: acc n_seconds must be "
                         f"({B}, {n})")
    if len(params.ramp_windows) != 3:
        raise ValueError("block_step_scenario: the kernel folds exactly "
                         "three ramp windows")
    if n * T >= 2 ** 31:
        raise ValueError(f"block_step_scenario: {n} chains x {T} s passes "
                         "the int32 counts of one block")
    if lib not in _scen_size_checked:
        size = build.entry(lib, "scen_struct_size", [])
        if size(None) != ctypes.sizeof(_Scen):
            raise RuntimeError("block_step_scenario: the Scen layout "
                               "differs between the kernel and its wrapper")
        _scen_size_checked.add(lib)
    nb, ne = params.bins + 2, len(params.thresholds) + 1
    n_ctas = (n + THREADS - 1) // THREADS
    hist_bytes = 4 * (nb + ne)
    stage = SCN_STAGE_BYTES
    hist_shared = stage + hist_bytes <= SMEM_MAX
    p = build.ptr
    buf = {"res_hist": torch.zeros((B, nb), dtype=torch.int32, device=dev),
           "exceed": torch.zeros((B, ne), dtype=torch.int32, device=dev),
           "chain_i": torch.empty((len(SCN_CHAIN_I), B, n),
                                  dtype=torch.int32, device=dev),
           "chain_f": torch.empty((len(SCN_CHAIN_F), B, n),
                                  dtype=torch.float32, device=dev),
           "part": torch.empty((n_ctas, B * len(SCN_KINDS)),
                               dtype=torch.float64, device=dev)}
    q = _Scen()
    q.B, q.bins, q.n_thr, q.lolp_k = B, params.bins, ne - 1, params.lolp_k
    q.hist_shared = int(hist_shared)
    q.ramp_w[:] = list(params.ramp_windows)
    q.lo, q.inv_w, q.capacity = params.lo, params.inv_w, params.capacity_w
    q.thr = p(_const_tensor(params.thresholds, torch.float32, dev))
    q.knob_f[:] = [p(scen[k]) for k in SCEN_F]
    q.knob_i[:] = [p(scen[k]) for k in SCEN_I]
    if cohort is not None:
        _check(cohort, torch.int32, dev, "cohort")
        if cohort.shape != (n,):
            raise ValueError(f"block_step_scenario: cohort must be ({n},)")
        q.cohort = p(cohort)
    for k in ("res_hist", "exceed", "chain_i", "chain_f", "part"):
        setattr(q, k, p(buf[k]))
    smem = stage + hist_bytes * hist_shared
    fn = build.entry(lib, "block_step_scenario",
                     _COMMON + [_P] * 11 + [ctypes.c_int])
    rc = fn(*args, *(p(carry[k]) for k in CARRY),
            *(p(acc[k]) for k in ACC_F), p(acc["n_seconds"]),
            ctypes.byref(q), smem, build.stream_ptr(dev))
    build.check(rc, "block_step_scenario")
    _count("scen", site, fleet, kernels, compute_dtype, rbg)
    L = len(SCN_KINDS)
    f = collapse_partials(buf["part"], SCN_KINDS * B).view(B, L)
    delta = {"count": f[:, 0].to(torch.int32), "res_hist": buf["res_hist"],
             "exceed": buf["exceed"], "min_res": f[:, 1].float(),
             "max_res": f[:, 2].float(),
             "lol_seconds": f[:, 3].to(torch.int32),
             "lol_events": f[:, 4].to(torch.int32)}
    for k, w in enumerate(params.ramp_windows):
        delta[f"max_ramp_{w}s"] = f[:, 5 + k].float()
    if per_chain:
        delta["chain"] = {**dict(zip(SCN_CHAIN_I, buf["chain_i"])),
                          **dict(zip(SCN_CHAIN_F, buf["chain_f"]))}
    return carry, acc, delta


def series_partials_cuda(tables, rows_i, rows_f, k_scan, k_meter, carry,
                         meter_max_w, surface_tilt, albedo, site=None,
                         fleet=None, kernels="exact", compute_dtype="f32",
                         layout="scan"):
    """The series kernel's first pass on the card: ``(carry, partials)``
    with ``partials[0 | 1]`` the ``(n_ctas, T)`` per-CTA sums of meter |
    pv."""
    n, T, dev, args = _common_args(tables, rows_i, rows_f, k_scan, k_meter,
                                   carry, 0, meter_max_w, surface_tilt,
                                   albedo, site, fleet, kernels, layout)
    rbg = rng.is_rbg(k_scan)
    n_ctas = (n + THREADS - 1) // THREADS
    part = torch.empty((2, n_ctas, T), dtype=torch.float32, device=dev)
    p = build.ptr
    fn = build.entry(_library(kernels, compute_dtype, rbg),
                     "block_step_series", _COMMON + [_P] * 5)
    rc = fn(*args, *(p(carry[k]) for k in CARRY), p(part[0]), p(part[1]),
            build.stream_ptr(dev))
    build.check(rc, "block_step_series")
    _count("series", site, fleet, kernels, compute_dtype, rbg)
    return carry, part


def series_sum_plain(part):
    """Plain cross-CTA sum: ``(2, n_ctas, T)`` partials -> ``(2, T)``
    (accumulated in float64, rounded once)."""
    return part.double().sum(1).float()


def series_sum(part):
    """The series epilogue's second pass: the per-CTA partials summed over
    CTAs, ``(2, n_ctas, T)`` -> ``(2, T)``; on the card in CTA index
    order, one thread per second."""
    if part.device.type == "cpu":
        return series_sum_plain(part)
    if part.device.type != "cuda":
        raise ValueError(f"unsupported device {part.device}")
    _check(part, torch.float32, part.device, "partials")
    if part.dim() != 3 or part.shape[0] != 2:
        raise ValueError("series_sum: partials must be (2, n_ctas, T)")
    _, n_ctas, T = part.shape
    out = torch.empty((2, T), dtype=torch.float32, device=part.device)
    p = build.ptr
    fn = build.entry("block_step.cu", "series_sum",
                     [ctypes.c_int, ctypes.c_int] + [_P] * 4)
    rc = fn(n_ctas, T, p(part[0]), p(part[1]), p(out[0]), p(out[1]),
            build.stream_ptr(part.device))
    build.check(rc, "series_sum")
    K4_SUM.launches += 1
    return out


def _series_cuda(tables, rows_i, rows_f, k_scan, k_meter, carry,
                 meter_max_w, surface_tilt, albedo, site, fleet=None,
                 kernels="exact", compute_dtype="f32", layout="scan"):
    carry, part = series_partials_cuda(tables, rows_i, rows_f, k_scan,
                                       k_meter, carry, meter_max_w,
                                       surface_tilt, albedo, site, fleet,
                                       kernels, compute_dtype, layout)
    out = series_sum(part)
    return carry, out[0], out[1]


def _trace_cuda(tables, rows_i, rows_f, k_scan, k_meter, carry,
                meter_max_w, surface_tilt, albedo, site, fleet=None,
                kernels="exact", compute_dtype="f32", layout="trace"):
    n, T, dev, args = _common_args(tables, rows_i, rows_f, k_scan, k_meter,
                                   carry, 0, meter_max_w, surface_tilt,
                                   albedo, site, fleet, kernels, layout)
    rbg = rng.is_rbg(k_scan)
    out = torch.empty((2, T, n), dtype=torch.float32, device=dev)
    p = build.ptr
    fn = build.entry(_library(kernels, compute_dtype, rbg),
                     "block_step_trace", _COMMON + [_P] * 5)
    rc = fn(*args, *(p(carry[k]) for k in CARRY), p(out[0]), p(out[1]),
            build.stream_ptr(dev))
    build.check(rc, "block_step_trace")
    _count("trace", site, fleet, kernels, compute_dtype, rbg)
    return carry, out[0], out[1]


def _dispatch(k_scan, cuda_fn, plain_fn, *args, **kw):
    if kw.get("compute_dtype", "f32") not in COMPUTE_DTYPES:
        raise ValueError(f"block_step: compute_dtype "
                         f"{kw['compute_dtype']!r} must be one of "
                         f"{COMPUTE_DTYPES}")
    if k_scan.device.type == "cuda":
        return cuda_fn(*args, **kw)
    if k_scan.device.type != "cpu":
        raise ValueError(f"unsupported device {k_scan.device}")
    return plain_fn(*args, **kw)


def block_step_acc(tables, rows_i, rows_f, k_scan, k_meter, carry, acc,
                   duration_s: int, meter_max_w: float, surface_tilt,
                   albedo, site: SiteGeometry | None = None,
                   fleet: FleetLeaves | None = None, kernels: str = "exact",
                   compute_dtype: str = "f32", layout: str = "scan"):
    """Fold one block into the accumulator; returns ``(carry, acc)``.

    ``tables``: value-major K2 tables; ``rows_i``/``rows_f``: the block's
    rows (``block_rows``, or ``site_rows`` with ``site=``, when
    ``surface_tilt`` and ``albedo`` are None); ``carry``/``acc``: dicts of
    ``(n,)`` tensors (``CARRY`` float32; ``ACC_F`` float32 and int32
    ``n_seconds``); ``fleet``: K7's per-chain leaves; ``kernels``: the
    transcendental set, 'exact' or 'table' (K11); ``compute_dtype``:
    'f32' or 'bf16' (K12); ``layout``: the draw layout of rbg keys
    (``clearsky_index.DRAW_LAYOUTS``; threefry keys draw the same values
    in every layout)."""
    return _dispatch(k_scan, _block_step_cuda, block_step_plain, tables,
                     rows_i, rows_f, k_scan, k_meter, carry, acc,
                     duration_s, meter_max_w, surface_tilt, albedo, site,
                     fleet, kernels=kernels, compute_dtype=compute_dtype,
                     layout=layout)


def block_step_obs(tables, rows_i, rows_f, k_scan, k_meter, carry, acc,
                   duration_s: int, meter_max_w: float, surface_tilt,
                   albedo, site: SiteGeometry | None = None,
                   fleet: FleetLeaves | None = None,
                   obs: Observers = None, kernels: str = "exact",
                   compute_dtype: str = "f32", layout: str = "scan"):
    """``block_step_acc`` with the reduce-mode observers (K8 telemetry, K9
    analytics) folded in the same launch: ``(carry, acc, out)``, ``out``
    as ``block_step_obs_plain`` returns it (on the card the per-block
    deltas come zero-initialised out of the kernel and its collapse)."""
    if obs is None or (obs.telemetry == "off" and obs.analytics == "off"):
        raise ValueError("block_step_obs: no observer is on")
    return _dispatch(k_scan, _block_step_cuda, block_step_obs_plain, tables,
                     rows_i, rows_f, k_scan, k_meter, carry, acc,
                     duration_s, meter_max_w, surface_tilt, albedo, site,
                     fleet=fleet, obs=obs, kernels=kernels,
                     compute_dtype=compute_dtype, layout=layout)


def block_step_scenario(tables, rows_i, rows_f, k_scan, k_meter, carry,
                        acc, duration_s: int, meter_max_w: float,
                        surface_tilt, albedo,
                        site: SiteGeometry | None = None,
                        fleet: FleetLeaves | None = None, scen: dict = None,
                        params: flt.FleetParams = None, cohort=None,
                        per_chain: bool = False, kernels: str = "exact",
                        compute_dtype: str = "f32"):
    """One scenario-batched block (K10; under bf16 K12 in K10): the step
    once per chain-second,
    then each row of ``scen`` (``(B,)`` knob tensors,
    ``serve.schema.encode_batch``) folds its own transform of it into
    ``acc`` (``(B, n)`` statistics, updated in place on the card) and
    into the block's zero-initialised ``risk`` FleetAcc of the sketch
    ``params``.  ``cohort``: the chains' ids for the cohort selector
    (None: no selector).  Returns ``(carry, acc, delta)`` with ``delta``
    the block's collapsed FleetAcc per row (``(B, ...)`` leaves; with
    ``per_chain`` also each row's per-chain leaves under ``chain``)."""
    if scen is None or params is None:
        raise ValueError("block_step_scenario: needs scen= and params=")
    return _dispatch(k_scan, _scenario_cuda, scenario_plain, tables, rows_i,
                     rows_f, k_scan, k_meter, carry, acc, duration_s,
                     meter_max_w, surface_tilt, albedo, site, fleet,
                     scen=scen, params=params, cohort=cohort,
                     per_chain=per_chain, kernels=kernels,
                     compute_dtype=compute_dtype)


def block_step_series(tables, rows_i, rows_f, k_scan, k_meter, carry,
                      meter_max_w: float, surface_tilt, albedo,
                      site: SiteGeometry | None = None,
                      fleet: FleetLeaves | None = None,
                      kernels: str = "exact", compute_dtype: str = "f32",
                      layout: str = "scan"):
    """One ensemble block: ``(carry, meter_sum, pv_sum)``, the sums
    ``(T,)`` over chains per second.  On the card a fixed-order reduction
    (per CTA, then over CTAs in index order): a repeated run gives the
    same bits."""
    return _dispatch(k_scan, _series_cuda, series_plain, tables, rows_i,
                     rows_f, k_scan, k_meter, carry, meter_max_w,
                     surface_tilt, albedo, site, fleet, kernels=kernels,
                     compute_dtype=compute_dtype, layout=layout)


def block_step_trace(tables, rows_i, rows_f, k_scan, k_meter, carry,
                     meter_max_w: float, surface_tilt, albedo,
                     site: SiteGeometry | None = None,
                     fleet: FleetLeaves | None = None,
                     kernels: str = "exact", compute_dtype: str = "f32",
                     layout: str = "trace"):
    """One trace block: ``(carry, meter, pv)``, time-major ``(T, n)``."""
    return _dispatch(k_scan, _trace_cuda, trace_plain, tables, rows_i,
                     rows_f, k_scan, k_meter, carry, meter_max_w,
                     surface_tilt, albedo, site, fleet, kernels=kernels,
                     compute_dtype=compute_dtype, layout=layout)


def geometry_fields_plain(rows_f, site: SiteGeometry,
                          kernels: str = "exact"):
    """Plain ``device_geometry_fields``: ``solar.device_geometry`` stacked
    into ``(9, T, n)``."""
    g = _geometry(rows_f, None, None, site, kernels)
    shape = (rows_f.shape[1], site.site["latitude"].shape[0])
    return torch.stack([torch.broadcast_to(g[k], shape)
                        for k in GEOM_FIELDS])


def device_geometry_fields(rows_f, site: SiteGeometry,
                           kernels: str = "exact"):
    """The site mode's per-chain geometry on its own: ``(9, T, n)``
    float32, the ``GEOM_FIELDS`` of every chain and second of the block
    whose site rows are ``rows_f`` (``(6, T)``).  A test entry of the
    kernel's geometry device function; on the CPU, the plain
    ``solar.device_geometry``."""
    dev = rows_f.device
    if site.stride > 1:
        raise ValueError("device_geometry_fields: the site mode's rows "
                         "(stride 1)")
    if dev.type == "cpu":
        return geometry_fields_plain(rows_f, site, kernels)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    T = rows_f.shape[1]
    n = site.site["latitude"].shape[0]
    if rows_f.shape != (len(ROWS_F_SITE), T):
        raise ValueError("device_geometry_fields: rows_f must be (6, T)")
    _check(rows_f, torch.float32, dev, "rows_f")
    for k in SITE_FIELDS:
        _check(site.site[k], torch.float32, dev, f"site {k}")
    _check(site.turbidity, torch.float32, dev, "turbidity")
    out = torch.empty((len(GEOM_FIELDS), T, n), dtype=torch.float32,
                      device=dev)
    p = build.ptr
    fn = build.entry(_library(kernels, "f32"), "device_geometry_fields",
                     [ctypes.c_int64, ctypes.c_int] + [_P] * 9)
    rc = fn(n, T, p(rows_f), *(p(site.site[k]) for k in SITE_FIELDS),
            p(site.turbidity), p(out), build.stream_ptr(dev))
    build.check(rc, "device_geometry_fields")
    return out
