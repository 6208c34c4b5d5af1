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
  (``block_step_obs``; obs/telemetry.py, obs/analytics.py): telemetry
  alone in the acc launch; with analytics on two launches, the acc
  producer (K3's statistics, writing the block's time-major meter, pv,
  csi and covered flags, ``obs_producer``) and the observer fold over
  them (``obs_fold``, csrc/wide_fold.cu);
* K10 the scenario fold of ``_block_step_scan_scenario`` /
  ``_scenario_block_core`` (:1834, :1871-1937), two launches
  (``block_step_scenario``): the step writes the block's time-major meter
  and pv (``scenario_producer``), then each scenario row's transform of
  them, its selectors and horizon, the seven statistics per (scenario,
  chain) and a ``risk`` FleetAcc per scenario with its
  ``reduce_chainwise`` (``scenario_fold``);
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
  (csrc/block_step_rbg*.cu);
* K14 the same step under ``prng_impl='unsafe_rbg'``: K13's draws, with
  the tile keys derived by unsafe_rbg's Philox ``fold_in`` (jax/_src/
  prng.py ``_unsafe_rbg_fold_in``; in the flat scan and trace layouts a
  batched datum, the block's first minute's seed), once per CTA; its own
  four libraries (csrc/block_step_urbg*.cu).  The wrappers pick the
  libraries by ``impl=``, the run's ``prng_impl``, never by the keys'
  width.

Every epilogue shares one pre-fold body: for every chain and second the
table lerps, the renewal step (a new cycle from ``cycle_from_u`` on
redraw), the csi composition, ``pv.power_from_csi`` and the meter, fed by
``scan_draws_tmajor`` / ``meter_block_tmajor`` (models/clearsky_index.py
:278-319).  ``block_step_plain``, ``series_plain``, ``trace_plain``,
``obs_producer_plain`` and ``scenario_producer_plain`` are that body
(``_body_plain``) plus their epilogue, so they cannot drift apart
(``scenario_plain`` is the producer's and ``scenario_fold_plain``'s
composition, ``block_step_obs_plain`` ``obs_producer_plain``'s and
``obs_fold_plain``'s); the CUDA kernel (csrc/block_step.cuh) is one template over
the kernel set, the epilogue, the geometry mode and the observers, beside
the scenario fold and the series' cross-CTA sum.  Its shared-site acc,
series and trace steps run each 60-second tile in two passes (the
renewal carry first, then the seconds' draws and physics, none on a
second without clear-sky GHI); ``redraws_plain`` says where a block's
cycles renew, for checks that reach that design's edge cases.

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
             ("trace", "block_step_trace"), ("prod", "block_step_prod"))


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
#: K14's instantiations (prng_impl 'unsafe_rbg'), float32 and bf16
STEP_URBG = _counters("_urbg")
STEP_URBG_BF16 = _counters("_urbg_bf16")
#: the counters of each (key implementation, compute dtype)
_STEPS = {("threefry2x32", "f32"): STEP, ("threefry2x32", "bf16"): STEP_BF16,
          ("rbg", "f32"): STEP_RBG, ("rbg", "bf16"): STEP_RBG_BF16,
          ("unsafe_rbg", "f32"): STEP_URBG,
          ("unsafe_rbg", "bf16"): STEP_URBG_BF16}
#: K3: the acc epilogue, shared site, exact set
K3 = STEP["acc", "shared", "exact"]
#: the values of ``compute_dtype=`` (Plan.compute_dtype)
COMPUTE_DTYPES = ("f32", "bf16")
K4_SUM = build.LaunchCounter("series_sum")
#: block-step launches (any epilogue) that apply fleet transforms
K7_FLEET = build.LaunchCounter("block_step_fleet")
#: blocks folded with the observers: telemetry only (the acc launch's
#: telemetry instantiation), analytics only, both (each an acc producer
#: launch and an observer fold)
K8 = build.LaunchCounter("block_step_tel")
K9 = build.LaunchCounter("block_step_analytics")
K89 = build.LaunchCounter("block_step_tel_analytics")
#: the observer fold over the acc producer's arrays (csrc/wide_fold.cu
#: ``obs_fold``; the producer counts as the prod epilogue's instantiation)
OBS_FOLD = build.LaunchCounter("obs_fold")
#: the second pass of reduce_chainwise (per-CTA partials over CTAs)
COLLAPSE = build.LaunchCounter("chainwise_collapse")
#: K10's second launch, the scenario fold over the producer's meter and pv
#: (the producer counts as the scenario epilogue's instantiation)
SCN_FOLD = build.LaunchCounter("scenario_fold")
#: every counter of this module: the instantiations in (epilogue,
#: geometry, kernel set) order, then the rest
COUNTERS = tuple(dict.fromkeys(
    [*STEP.values(), *STEP_BF16.values(), *STEP_RBG.values(),
     *STEP_RBG_BF16.values(), *STEP_URBG.values(),
     *STEP_URBG_BF16.values()])) + (K4_SUM, K7_FLEET, K8, K9, K89,
                                     OBS_FOLD, COLLAPSE, SCN_FOLD)

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
#: the observer, wide and scenario folds count the exceedance slots in
#: registers up to this many thresholds (csrc/fold.cuh ``MAX_THR``)
MAX_THR = 8
#: the scenario fold's shared sketch (its row's residual histogram, and
#: its exceedance slots when they do not count in registers) and its ramp
#: flags may take this many bytes per CTA; beyond, the sketch counts with
#: global atomics
SCN_SMEM_MAX = 200 * 1024
#: series_sum's strands per second (csrc/block_step.cuh ``SUM_STRANDS``)
SUM_STRANDS = 32

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
#: the scenario fold's per-(scenario, chain) risk leaves
#: (``per_chain=True``), in row order
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
    ``(T, 1)`` columns, or every chain's device geometry ``(T, n)`` (the
    sun's site-independent half on the ``(T, 1)`` time rows, once per
    second, as the kernel's ``sun_time``: ``solar.sun_time_terms``); in
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
                layout="scan", impl="threefry2x32"):
    """The pre-fold body every epilogue shares: everything carry-
    independent over the whole block at once, the renewal compare/select
    second by second, then the fleet transforms.  Returns ``(carry,
    meter, ac, csi, covered)`` with time-major ``(T, n)`` arrays (csi
    before the cap, as the telemetry reads it).  ``compute_dtype='bf16'``
    runs K12's arithmetic: u / z drawn in bf16 when ``bf16_draws`` (the
    acc and series epilogues), the physics on bf16 geometry and csi.
    ``layout`` is the JAX formulation's draw layout
    (``clearsky_index.DRAW_LAYOUTS``), which only rbg and unsafe_rbg keys
    (``impl``) tell apart."""
    T = rows_i.shape[1]
    g0 = int(rows_i[0, 0]) // 60
    bf = compute_dtype == "bf16"
    lay = layout if impl != "threefry2x32" else "scan"
    u, z = ci.scan_draws_tmajor(
        k_scan, g0, T // 60,
        torch.bfloat16 if bf and bf16_draws else torch.float32, lay, impl)
    u, z = u.float(), z.float()
    meter = ci.meter_block_tmajor(k_meter, g0, T // 60, meter_max_w, lay,
                                  impl)
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


def redraws_plain(tables, rows_i, rows_f, k_scan, carry,
                  layout: str = "scan", impl: str = "threefry2x32"):
    """Where the block's renewal cycles end: a time-major ``(T, n)`` bool
    array, true in the seconds in which a chain draws a new cycle (its u
    and both ``powf``), as ``_body_plain`` steps the carry.  Checks use it
    to show that an input reaches the step's edge cases (redraws in a
    tile's first and last second, in consecutive seconds)."""
    T = rows_i.shape[1]
    lay = layout if impl != "threefry2x32" else "scan"
    u, z = ci.scan_draws_tmajor(k_scan, int(rows_i[0, 0]) // 60, T // 60,
                                torch.float32, lay, impl)
    x = {"h": rows_i[1].long(), "d": rows_i[2].long(), "m": rows_i[3].long(),
         "hf": rows_f[0][:, None], "df": rows_f[1][:, None],
         "mf": rows_f[2][:, None], "z": z}
    ins = ci.csi_inputs(tables, x)
    cloud, total = renewal.cycle_from_u(u, ins["cc_t"], ins["ws_t"])
    carry = dict(carry)
    out = torch.empty_like(cloud, dtype=torch.bool)
    for s in range(T):
        out[s] = carry["sec"] + 1.0 >= carry["total_end"]
        carry, _ = renewal.step_from_cycle(carry, cloud[s], total[s])
    return out


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
    big = torch.tensor(_BIG, dtype=torch.float32, device=ac.device)
    acc = dict(acc)
    for s in range(T):
        _fold_stats_second(acc, valid[s], meter[s], ac[s], residual[s], big)
        if second_hook is not None:
            second_hook(s, valid[s], residual[s])
    return acc


def _fold_stats_second(acc, ok, meter, ac, residual, big):
    """Fold one second into ``acc`` (in place): ``ok`` its validity mask,
    the rest its values, all of one shape; ``big`` float32's max."""
    w = ok.to(torch.float32)
    acc["pv_sum"] = acc["pv_sum"] + ac * w
    acc["pv_max"] = torch.maximum(acc["pv_max"], torch.where(ok, ac, -big))
    acc["meter_sum"] = acc["meter_sum"] + meter * w
    acc["residual_sum"] = acc["residual_sum"] + residual * w
    acc["residual_min"] = torch.minimum(acc["residual_min"],
                                        torch.where(ok, residual, big))
    acc["residual_max"] = torch.maximum(acc["residual_max"],
                                        torch.where(ok, residual, -big))
    acc["n_seconds"] = acc["n_seconds"] + ok.to(torch.int32)


def block_step_plain(tables, rows_i, rows_f, k_scan, k_meter, carry, acc,
                     duration_s: int, meter_max_w: float,
                     surface_tilt, albedo, site: SiteGeometry | None = None,
                     fleet: FleetLeaves | None = None,
                     kernels: str = "exact", compute_dtype: str = "f32",
                     layout: str = "scan", impl: str = "threefry2x32"):
    """Plain torch K3 / K6 / K6s / K12 / K13 / K14 (the ``acc`` epilogue,
    with K7's transforms): the shared body, then the statistics fold.
    Returns ``(carry, acc)``."""
    carry, meter, ac, _, _ = _body_plain(
        tables, rows_i, rows_f, k_scan, k_meter, carry, meter_max_w,
        surface_tilt, albedo, site, fleet, kernels, compute_dtype,
        layout=layout, impl=impl)
    return carry, stats_fold_plain(acc, rows_i[0], duration_s, meter, ac)


def obs_producer_plain(tables, rows_i, rows_f, k_scan, k_meter, carry,
                       acc, duration_s: int, meter_max_w: float,
                       surface_tilt, albedo,
                       site: SiteGeometry | None = None,
                       fleet: FleetLeaves | None = None,
                       kernels: str = "exact", compute_dtype: str = "f32",
                       layout: str = "scan", impl: str = "threefry2x32"):
    """Plain acc producer (the first launch of K9 and K8 + K9): the shared
    body, the statistics fold, and the body's time-major ``(T, n)``
    outputs the observer fold reads.  Returns ``(carry, acc, prod)``,
    ``prod`` with float32 ``meter``, ``pv``, ``csi`` (before the cap, as
    the telemetry reads it) and bool ``covered``."""
    carry, meter, ac, csi, covered = _body_plain(
        tables, rows_i, rows_f, k_scan, k_meter, carry, meter_max_w,
        surface_tilt, albedo, site, fleet, kernels, compute_dtype,
        layout=layout, impl=impl)
    acc = stats_fold_plain(acc, rows_i[0], duration_s, meter, ac)
    return carry, acc, {"meter": meter, "pv": ac, "csi": csi,
                        "covered": covered}


def obs_fold_plain(prod: dict, t, duration_s: int, obs: Observers):
    """Plain observer fold: the observers' per-chain folds (obs/
    telemetry.py and obs/analytics.py ``fold_second``, zero-initialised
    for the block) second by second over the producer's ``(T, n)``
    arrays (``t``: the ``(T,)`` global seconds), then their
    ``reduce_chainwise``.  Returns ``out`` as ``block_step_obs_plain``'s:
    the block's collapsed ``telemetry`` and ``fleet`` deltas (None when
    off) and, with ``obs.per_chain``, the per-chain accs under
    ``telemetry_chain`` / ``fleet_chain``."""
    meter, ac = prod["meter"], prod["pv"]
    csi, covered = prod.get("csi"), prod.get("covered")
    n, dev = ac.shape[1], ac.device
    cohorts = obs.n_cohorts if obs.n_cohorts >= 2 else 0
    ta = None if obs.telemetry == "off" else \
        tel.init_acc(obs.telemetry, n, dev)
    fa = None if obs.analytics == "off" else \
        flt.init_acc(obs.analytics, n, params=obs.params, cohorts=cohorts,
                     device=dev)
    residual = meter - ac
    valid = t < duration_s
    for s, ts in enumerate(t.tolist()):
        if ta is not None:
            ta = tel.fold_second(
                ta, obs.telemetry, meter=meter[s], pv=ac[s], csi=csi[s],
                residual=residual[s], covered=covered[s], valid=valid[s])
        if fa is not None:
            fa = flt.fold_second(
                fa, obs.analytics, obs.params, meter=meter[s], pv=ac[s],
                residual=residual[s],
                covered=None if covered is None else covered[s], t=ts,
                valid=valid[s], cohort=obs.cohort)
    out = {"telemetry": None if ta is None else tel.reduce_chainwise(ta),
           "fleet": None if fa is None else
           flt.reduce_chainwise(fa, cohort=obs.cohort)}
    if obs.per_chain:
        out["telemetry_chain"], out["fleet_chain"] = ta, fa
    return out


def block_step_obs_plain(tables, rows_i, rows_f, k_scan, k_meter, carry,
                         acc, duration_s: int, meter_max_w: float,
                         surface_tilt, albedo,
                         site: SiteGeometry | None = None,
                         fleet: FleetLeaves | None = None,
                         obs: Observers = None, kernels: str = "exact",
                         compute_dtype: str = "f32", layout: str = "scan",
                         impl: str = "threefry2x32"):
    """Plain K8 / K9, the kernels' composition: the acc producer
    (``obs_producer_plain``: the shared body and the statistics fold),
    then the observers' per-chain folds over its arrays and their
    ``reduce_chainwise`` (``obs_fold_plain``).  Returns ``(carry, acc,
    out)``; ``out`` holds the block's collapsed ``telemetry`` and
    ``fleet`` deltas (None when off) and, with ``obs.per_chain``, the
    per-chain accs under ``telemetry_chain`` / ``fleet_chain``."""
    carry, acc, prod = obs_producer_plain(
        tables, rows_i, rows_f, k_scan, k_meter, carry, acc, duration_s,
        meter_max_w, surface_tilt, albedo, site, fleet, kernels,
        compute_dtype, layout, impl)
    return carry, acc, obs_fold_plain(prod, rows_i[0], duration_s, obs)


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
    """Row ``b``'s transform of the step's meter and pv (every row's at
    once, over a row axis, when ``scen``'s leaves are ``(B, 1)`` and
    ``b`` a slice):
    ``meter * demand_scale + demand_shift_w`` rounded once (the JAX scan
    contracts it into a multiply-add; tests/test_torch_serve.py settles
    it), ``min(ac * (pv_scale * weather_bias), curtail_w)``, and the
    residual."""
    m = rng.fma(meter, scen["demand_scale"][b], scen["demand_shift_w"][b])
    p = torch.minimum(ac * (scen["pv_scale"][b] * scen["weather_bias"][b]),
                      scen["curtail_w"][b])
    return m, p, m - p


def scenario_valid_plain(rows_i, duration_s, scen, b, n, cohort=None):
    """Row ``b``'s validity as ``(selected chains (n,), valid seconds
    (T,))`` (with ``b`` a slice of rows, the rows' ``(B, n)`` and ``(T,
    B)``): the site selector (the chain's index against ``site_index``),
    the cohort selector (when ``cohort``, the chains' ids, is given),
    ``t < duration_s`` and ``t < horizon_s``; a second's ``(n,)`` mask is
    ``sel & tv[s][..., None]``."""
    dev = rows_i.device
    iota = torch.arange(n, device=dev, dtype=torch.int32)
    site = scen["site_index"][b][..., None]
    sel = (site < 0) | (iota == site)
    if cohort is not None:
        c = scen["cohort"][b][..., None]
        sel = sel & ((c < 0) | (cohort == c))
    h = scen["horizon_s"][b]
    t = rows_i[0].reshape(-1, *([1] * h.dim()))
    return sel, (t < duration_s) & (t < h)


def scenario_producer_plain(tables, rows_i, rows_f, k_scan, k_meter, carry,
                            meter_max_w: float, surface_tilt, albedo,
                            site: SiteGeometry | None = None,
                            fleet: FleetLeaves | None = None,
                            kernels: str = "exact",
                            compute_dtype: str = "f32",
                            impl: str = "threefry2x32"):
    """Plain K10 producer: the shared body's meter and pv (K3's step with
    K7's transforms, the flat scan's draw layout; under bf16 the acc
    epilogue's bf16 draws).  Returns ``(carry, meter, pv)``, time-major
    ``(T, n)``."""
    return _body_plain(tables, rows_i, rows_f, k_scan, k_meter, carry,
                       meter_max_w, surface_tilt, albedo, site, fleet,
                       kernels, compute_dtype, impl=impl)[:3]


def scenario_fold_plain(meter, ac, t, acc, duration_s: int, scen: dict,
                        params: flt.FleetParams, cohort=None,
                        per_chain: bool = False):
    """Plain K10 fold: every scenario row's transform, validity and
    statistics fold of the block's time-major ``(T, n)`` meter and pv
    (``t``: the ``(T,)`` global seconds) into ``acc`` (``(B, n)``
    leaves) beside a zero-initialised ``risk`` FleetAcc
    (obs/analytics.py ``fold_second`` / ``reduce_chainwise``), all rows
    at once over a leading row axis (each row's arithmetic, in second
    order, is the one row's).  Returns ``(acc, delta)``: ``delta`` holds
    the block's collapsed FleetAcc of each row (``(B, ...)`` leaves) and,
    with ``per_chain``, ``chain``, each row's per-chain FleetAcc (``(B,
    n)`` leaves)."""
    B = _scenario_check(scen)
    n, dev = ac.shape[1], ac.device
    t_rows = t.tolist()
    rows, col = slice(None), {k: v[:, None] for k, v in scen.items()}
    sel, tv = scenario_valid_plain(t[None], duration_s, scen, rows, n,
                                   cohort)
    fa0 = flt.init_acc("risk", n, params=params, device=dev)
    fa = {k: v.expand(B, *v.shape).clone() for k, v in fa0.items()}
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    out = dict(acc)
    for s in range(len(t_rows)):
        # the second's (B, n) transform and mask, one second at a time
        m, p, r = scenario_transform_plain(meter[s], ac[s], col, rows)
        ok = sel & tv[s][:, None]
        _fold_stats_second(out, ok, m, p, r, big)
        fa = flt.fold_second(fa, "risk", params, meter=m, pv=p, residual=r,
                             covered=None, t=t_rows[s], valid=ok)
    deltas = [flt.reduce_chainwise({k: v[b] for k, v in fa.items()})
              for b in range(B)]
    delta = {k: torch.stack([d[k] for d in deltas]) for k in deltas[0]}
    if per_chain:
        delta["chain"] = {k: v for k, v in fa.items() if v.shape == (B, n)}
    return out, delta


def scenario_plain(tables, rows_i, rows_f, k_scan, k_meter, carry, acc,
                   duration_s: int, meter_max_w: float, surface_tilt,
                   albedo, site: SiteGeometry | None = None,
                   fleet: FleetLeaves | None = None, scen: dict = None,
                   params: flt.FleetParams = None, cohort=None,
                   per_chain: bool = False, kernels: str = "exact",
                   compute_dtype: str = "f32", impl: str = "threefry2x32"):
    """Plain K10 (under bf16 K12 in K10), the kernels' composition: the
    producer (``scenario_producer_plain``), then the fold
    (``scenario_fold_plain``).  Returns ``(carry, acc, delta)``."""
    _scenario_check(scen)
    carry, meter, ac = scenario_producer_plain(
        tables, rows_i, rows_f, k_scan, k_meter, carry, meter_max_w,
        surface_tilt, albedo, site, fleet, kernels, compute_dtype, impl)
    out, delta = scenario_fold_plain(meter, ac, rows_i[0], acc, duration_s,
                                     scen, params, cohort, per_chain)
    return carry, out, delta


def series_plain(tables, rows_i, rows_f, k_scan, k_meter, carry,
                 meter_max_w: float, surface_tilt, albedo,
                 site: SiteGeometry | None = None,
                 fleet: FleetLeaves | None = None, kernels: str = "exact",
                 compute_dtype: str = "f32", layout: str = "scan",
                 impl: str = "threefry2x32"):
    """Plain K4 series: ``series_parts_plain``, then ``series_total``
    (each second's cross-chain sums of meter and pv accumulated in
    float64, rounded once to float32).  Returns ``(carry, meter_sum,
    pv_sum)``, each ``(T,)``; padding seconds are summed too (the engine
    trims them)."""
    carry, parts = series_parts_plain(
        tables, rows_i, rows_f, k_scan, k_meter, carry, meter_max_w,
        surface_tilt, albedo, site, fleet, kernels, compute_dtype, layout,
        impl)
    out = series_total(parts)
    return carry, out[0], out[1]


def series_parts_plain(tables, rows_i, rows_f, k_scan, k_meter, carry,
                       meter_max_w: float, surface_tilt, albedo,
                       site: SiteGeometry | None = None,
                       fleet: FleetLeaves | None = None,
                       kernels: str = "exact", compute_dtype: str = "f32",
                       layout: str = "scan", impl: str = "threefry2x32"):
    """Plain K4 series up to its rounding: the shared body, then
    ``(carry, parts)``, with ``parts`` ``(2, 1, T)`` the float64 sums of
    meter | pv over chains."""
    carry, meter, ac, _, _ = _body_plain(
        tables, rows_i, rows_f, k_scan, k_meter, carry, meter_max_w,
        surface_tilt, albedo, site, fleet, kernels, compute_dtype,
        layout=layout, impl=impl)
    return carry, torch.stack([meter.double().sum(1),
                               ac.double().sum(1)])[:, None]


def series_total(parts):
    """The per-second sums over chains, ``(2, T)`` float32, of series
    parts ``(2, k, T)``: the card's float32 per-CTA partials (summed as
    ``series_sum`` sums them) or the plain version's float64 sums (added
    and rounded once).  The parts of consecutive chain ranges, joined on
    axis 1 in chain order, give the sums of the whole range: the bits of
    one launch over it on the CPU, and on the card when every range but
    the last holds a whole number of CTAs (``THREADS`` chains)."""
    if parts.dtype == torch.float64:
        return parts.sum(1).float()
    return series_sum(parts)


def series_fold_plain(meter, ac):
    """The series epilogue's first pass over time-major ``(T, n)`` meter
    and pv in the kernel's order: ``(2, n_ctas, T)`` float32 sums of each
    CTA's chains, per second a warp's 32 chains by the butterfly (lane 0
    adds lane 16's value, then 8's, 4's, 2's, 1's), then the CTA's warps
    in index order; a chain past ``n`` adds 0."""
    T, n = meter.shape
    n_ctas = -(-n // THREADS)
    lane = torch.arange(32, device=meter.device)

    def fold(x):
        x = torch.nn.functional.pad(x, (0, n_ctas * THREADS - n))
        x = x.reshape(T, n_ctas, THREADS // 32, 32)
        for off in (16, 8, 4, 2, 1):
            x = x + x[..., lane ^ off]
        part = x[..., 0, 0]
        for w in range(1, THREADS // 32):
            part = part + x[..., w, 0]
        return part.t()

    return torch.stack((fold(meter), fold(ac)))


def series_partials_plain(tables, rows_i, rows_f, k_scan, k_meter, carry,
                          meter_max_w: float, surface_tilt, albedo,
                          site: SiteGeometry | None = None,
                          fleet: FleetLeaves | None = None,
                          kernels: str = "exact", compute_dtype: str = "f32",
                          layout: str = "scan", impl: str = "threefry2x32"):
    """Plain K4 series' first pass, equal to ``series_partials_cuda`` bit
    for bit: ``(carry, partials)``, the shared body's meter and pv folded
    by ``series_fold_plain``."""
    carry, meter, ac, _, _ = _body_plain(
        tables, rows_i, rows_f, k_scan, k_meter, carry, meter_max_w,
        surface_tilt, albedo, site, fleet, kernels, compute_dtype,
        layout=layout, impl=impl)
    return carry, series_fold_plain(meter, ac)


def trace_plain(tables, rows_i, rows_f, k_scan, k_meter, carry,
                meter_max_w: float, surface_tilt, albedo,
                site: SiteGeometry | None = None,
                fleet: FleetLeaves | None = None, kernels: str = "exact",
                compute_dtype: str = "f32", layout: str = "trace",
                impl: str = "threefry2x32"):
    """Plain K4 trace: the shared body's every chain-second.  Returns
    ``(carry, meter, pv)`` with time-major ``(T, n)`` arrays.  Under bf16
    the u / z draws stay float32, as in the JAX ``_block_step``."""
    return _body_plain(tables, rows_i, rows_f, k_scan, k_meter, carry,
                       meter_max_w, surface_tilt, albedo, site, fleet,
                       kernels, compute_dtype, bf16_draws=False,
                       layout=layout, impl=impl)[:3]


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
#: the block-step library of each (kernel set, compute dtype, key
#: implementation): block_step{_rbg|_urbg}{_bf16}{_table}.cu
_LIBRARY = {(ks, cd, impl): "block_step"
            + {"threefry2x32": "", "rbg": "_rbg", "unsafe_rbg": "_urbg"}[impl]
            + ("_bf16" if cd == "bf16" else "")
            + ("_table" if ks == "table" else "") + ".cu"
            for ks in ("exact", "table") for cd in ("f32", "bf16")
            for impl in rng.IMPLS}
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
                ("thr", _P), ("thr_v", ctypes.c_float * MAX_THR),
                ("res_hist", _P), ("exceed", _P),
                ("cohort_hist", _P), ("cohort", _P), ("flt_part", _P),
                ("coh_part", _P), ("flt_chain_i", _P), ("flt_chain_f", _P)]


class _Scen(ctypes.Structure):
    """ctypes mirror of csrc/block_step.cu's ``Scen``."""

    _fields_ = [("B", ctypes.c_int), ("bins", ctypes.c_int),
                ("n_thr", ctypes.c_int), ("lolp_k", ctypes.c_int),
                ("hist_shared", ctypes.c_int), ("T", ctypes.c_int),
                ("duration_s", ctypes.c_int), ("ramp_w", ctypes.c_int * 3),
                ("lo", ctypes.c_float), ("inv_w", ctypes.c_float),
                ("capacity", ctypes.c_float), ("n", ctypes.c_int64),
                ("t", _P), ("meter", _P), ("pv", _P), ("tame", _P),
                ("thr", _P),
                ("thr_v", ctypes.c_float * MAX_THR),
                ("knob_f", _P * len(SCEN_F)), ("knob_i", _P * len(SCEN_I)),
                ("cohort", _P), ("stat_f", _P * len(ACC_F)),
                ("n_seconds", _P), ("res_hist", _P), ("exceed", _P),
                ("chain_i", _P), ("chain_f", _P), ("part", _P)]


#: the grouped collapse's row sets a launch (csrc/block_step.cuh
#: ``COLLAPSE_MAX_SETS``) and the longest period of a set's kinds
COLLAPSE_MAX_SETS = 4
COLLAPSE_MAX_PERIOD = 32


class _CollapseSet(ctypes.Structure):
    """ctypes mirror of csrc/block_step.cuh's ``CollapseSet``."""

    _fields_ = [("part", _P), ("out", _P), ("kinds", ctypes.c_uint64),
                ("n_parts", ctypes.c_int), ("L", ctypes.c_int),
                ("period", ctypes.c_int), ("cta0", ctypes.c_int)]


class _CollapseGroup(ctypes.Structure):
    """ctypes mirror of csrc/block_step.cuh's ``CollapseGroup``."""

    _fields_ = [("n_sets", ctypes.c_int), ("n_ctas", ctypes.c_int),
                ("set", _CollapseSet * COLLAPSE_MAX_SETS)]


def _check(t, dtype, dev, what):
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"block_step: {what} must be a contiguous "
                         f"{dtype} tensor on {dev}")


def _geo_mode(site: SiteGeometry | None) -> str:
    return "shared" if site is None else site.mode


def _common_args(tables, rows_i, rows_f, k_scan, k_meter, carry,
                 duration_s, meter_max_w, surface_tilt, albedo, site,
                 fleet=None, kernels="exact", layout="scan",
                 impl="threefry2x32"):
    """Validate the shared inputs and return the C arguments they fill."""
    n = k_scan.shape[0]
    if layout not in LAYOUTS:
        raise ValueError(f"block_step: unknown draw layout {layout!r}")
    width = rng.KEY_WIDTH[impl]
    if k_scan.shape != (n, width) or k_meter.shape != (n, width):
        raise ValueError(f"block_step: k_scan and k_meter must be "
                         f"(n, {width}) {impl} keys")
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


def _library(kernels: str, compute_dtype: str,
             impl: str = "threefry2x32") -> str:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"block_step: compute_dtype {compute_dtype!r} "
                         f"must be one of {COMPUTE_DTYPES}")
    return _LIBRARY[kernels, compute_dtype, impl]


def _count(epi: str, site, fleet, kernels: str, compute_dtype: str = "f32",
           impl: str = "threefry2x32"):
    _STEPS[impl, compute_dtype][epi, _geo_mode(site),
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


def _thresholds(thresholds, dev, what: str):
    """The exceedance thresholds as a fold takes them: ``(thr, thr_v)``,
    all of them as a float32 tensor on ``dev`` and the first ``MAX_THR``
    by value, then +inf.  They must be ascending in float32."""
    if (np.diff(np.asarray(thresholds, np.float32)) < 0).any():
        raise ValueError(f"{what}: the thresholds must be ascending in "
                         "float32")
    thr_v = list(thresholds[:MAX_THR]) \
        + [math.inf] * max(0, MAX_THR - len(thresholds))
    return _const_tensor(thresholds, torch.float32, dev), thr_v


def collapse_plain(part, kinds):
    """Plain second pass: ``(n_parts, L)`` float64 partial rows combined
    over the rows, by kind (0 sum, 1 min, 2 max); ``(L,)`` float64."""
    k = torch.as_tensor(kinds, device=part.device)
    return torch.where(k == 0, part.sum(0),
                       torch.where(k == 1, part.min(0).values,
                                   part.max(0).values))


def _kinds_bits(kinds: tuple, L: int) -> int:
    """One period of a set's kinds (it repeats over the ``L`` leaves;
    at most ``COLLAPSE_MAX_PERIOD`` long) packed two bits a leaf."""
    if not 0 < len(kinds) <= COLLAPSE_MAX_PERIOD or L % len(kinds) or \
            any(k not in (0, 1, 2) for k in kinds):
        raise ValueError(f"collapse: kinds {kinds} are not one period of "
                         f"at most {COLLAPSE_MAX_PERIOD} that tiles {L} "
                         "leaves")
    return sum(k << (2 * j) for j, k in enumerate(kinds))


_collapse_size_checked: set = set()


def _collapse_cuda(sets):
    dev = sets[0][0].device
    outs = torch.empty(sum(p.shape[1] for p, _ in sets), dtype=torch.float64,
                       device=dev).split([p.shape[1] for p, _ in sets])
    g = _CollapseGroup()
    g.n_sets = len(sets)
    for q, (part, kinds), out in zip(g.set, sets, outs):
        _check(part, torch.float64, dev, "collapse rows")
        q.n_parts, q.L = part.shape
        if q.n_parts < 1:
            raise ValueError("collapse: a set without rows")
        q.period, q.kinds = len(kinds), _kinds_bits(kinds, q.L)
        q.part, q.out = build.ptr(part), build.ptr(out)
    lib = "block_step.cu"
    if lib not in _collapse_size_checked:
        size = build.entry(lib, "collapse_struct_size", [])
        if size(None) != ctypes.sizeof(_CollapseGroup):
            raise RuntimeError("collapse: the CollapseGroup layout differs "
                               "between the kernel and its wrapper")
        _collapse_size_checked.add(lib)
    fn = build.entry(lib, "collapse_partials", [_P])
    build.check(fn(ctypes.byref(g), build.stream_ptr(dev)),
                "collapse_partials")
    COLLAPSE.launches += 1
    return list(outs)


def collapse_group(sets):
    """reduce_chainwise's second pass for a block's row sets (at most
    ``COLLAPSE_MAX_SETS``), each ``(part, kinds)``: the ``(n_parts, L)``
    float64 per-CTA partial rows and their kinds (0 sum, 1 min, 2 max), one
    period of at most ``COLLAPSE_MAX_PERIOD`` that repeats over the ``L``
    leaves (the cohorts' and the scenario rows' do).  Returns each set's
    ``(L,)`` float64 leaves combined over the rows in index order (sums in
    float64).  On the card one launch for all the sets; on the CPU
    ``collapse_plain`` per set."""
    sets = [(part, tuple(kinds)) for part, kinds in sets]
    if not 1 <= len(sets) <= COLLAPSE_MAX_SETS:
        raise ValueError(f"collapse: 1 to {COLLAPSE_MAX_SETS} row sets a "
                         f"launch, not {len(sets)}")
    dev = sets[0][0].device
    if dev.type == "cuda":
        return _collapse_cuda(sets)
    if dev.type != "cpu":
        raise ValueError(f"collapse: no kernel for device {dev}")
    return [collapse_plain(part, kinds * (part.shape[1] // len(kinds)))
            for part, kinds in sets]


def _obs_buffers(obs: Observers, n: int, T: int, dev):
    """The observers' outputs, the kernel's ``Obs`` argument and its
    dynamic shared bytes: with analytics on, the sketch when it fits
    ``SMEM_MAX`` (the residual bins and exceedance slots, then the cohort
    histogram), then the T bytes of per-second ramp flags."""
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
        smem = hist_bytes * hist_shared + coh_bytes * coh_shared \
            + -(-T // 4) * 4
        o.flt_full = int(obs.analytics == "full")
        o.bins, o.n_thr, o.lolp_k = prm.bins, ne - 1, prm.lolp_k
        o.n_cohorts, o.hist_shared, o.coh_shared = C, hist_shared, coh_shared
        o.ramp_w[:] = list(prm.ramp_windows)
        o.lo, o.inv_w, o.capacity = prm.lo, prm.inv_w, prm.capacity_w
        thr, o.thr_v[:] = _thresholds(prm.thresholds, dev, "block_step")
        o.thr = p(thr)
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
    # the block's row sets in one collapse
    names = [k for k in PART_KINDS if k in buf]
    rows = dict(zip(names, collapse_group(
        [(buf[k], PART_KINDS[k]) for k in names])))
    if obs.telemetry != "off":
        t = rows["tel_part"]
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
        f = rows["flt_part"]
        d = {"count": f[0].to(torch.int32), "res_hist": buf["res_hist"],
             "exceed": buf["exceed"], "min_res": f[1].float(),
             "max_res": f[2].float(), "lol_seconds": f[3].to(torch.int32),
             "lol_events": f[4].to(torch.int32)}
        for k, w in enumerate(prm.ramp_windows):
            d[f"max_ramp_{w}s"] = f[5 + k].float()
        if "coh_part" in buf:
            C = obs.n_cohorts
            c = rows["coh_part"].view(C, len(COH_KINDS))
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


def _obs_struct_check(lib: str, entry: str = "obs_struct_size"):
    if lib not in _obs_size_checked:
        size = build.entry(lib, entry, [])
        if size(None) != ctypes.sizeof(_Obs):
            raise RuntimeError("block_step: the Obs layout differs between "
                               "the kernel and its wrapper")
        _obs_size_checked.add(lib)


def prod_buffers(n: int, T: int, csi: bool, covered: bool, dev,
                 held: dict | None = None) -> dict:
    """The acc producer's outputs for ``n`` chains x ``T`` s: float32
    ``meter``, ``pv`` and (with ``csi``) ``csi``, uint8 ``covered`` (with
    ``covered``), each ``(T, n)``: 13 bytes per chain-second at most
    (7.4 GB at 65536 chains x the default 8640 s block, 0.92 GB at 1080 s;
    27.9 GB at the int32 ceiling n * T < 2**31).  ``held``: the caller's
    dict that keeps the last call's buffers (the engine holds one per
    simulation, so they go with it): reused when the shape and outputs
    match, else dropped before new ones are made; None: new tensors.  A
    run that cannot allocate them fails here."""
    key = (n, T, csi, covered, str(dev))
    if held is not None:
        if held.get("key") == key:
            return held["buf"]
        held.clear()
    names = ["meter", "pv"] + (["csi"] if csi else [])
    size = (4 * len(names) + int(covered)) * n * T
    try:
        buf = {k: torch.empty((T, n), dtype=torch.float32, device=dev)
               for k in names}
        if covered:
            buf["covered"] = torch.empty((T, n), dtype=torch.uint8,
                                         device=dev)
    except torch.cuda.OutOfMemoryError as e:
        raise RuntimeError(
            f"block_step: the observer fold's inputs ({size / 1e9:.3g} GB "
            f"for {n} chains x {T} s) do not fit on {dev}; run fewer chains "
            "per block or shorter blocks") from e
    if held is not None:
        held.update(key=key, buf=buf)
    return buf


def _acc_checks(acc, dev):
    for k in ACC_F:
        _check(acc[k], torch.float32, dev, f"acc {k}")
    _check(acc["n_seconds"], torch.int32, dev, "acc n_seconds")


def _block_step_cuda(tables, rows_i, rows_f, k_scan, k_meter, carry, acc,
                     duration_s, meter_max_w, surface_tilt, albedo, site,
                     fleet=None, obs: Observers | None = None,
                     kernels="exact", compute_dtype="f32", layout="scan",
                     impl="threefry2x32", held=None):
    tel_on = obs is not None and obs.telemetry != "off"
    flt_on = obs is not None and obs.analytics != "off"
    if flt_on:
        # two launches: the producer, then the observer fold
        carry, acc, prod = _obs_producer_cuda(
            tables, rows_i, rows_f, k_scan, k_meter, carry, acc, duration_s,
            meter_max_w, surface_tilt, albedo, site, fleet, obs, kernels,
            compute_dtype, layout, impl, held)
        out = _obs_fold_cuda(prod, rows_i[0], duration_s, obs)
        (K89 if tel_on else K9).launches += 1
        return carry, acc, out
    n, T, dev, args = _common_args(tables, rows_i, rows_f, k_scan, k_meter,
                                   carry, duration_s, meter_max_w,
                                   surface_tilt, albedo, site, fleet, kernels,
                                   layout, impl)
    lib = _library(kernels, compute_dtype, impl)
    _acc_checks(acc, dev)
    fn = build.entry(lib, "block_step_acc", _COMMON + [_P] * 11
                     + [ctypes.c_int])
    o, buf = None, {}
    if tel_on:
        _obs_struct_check(lib)
        o, buf, _ = _obs_buffers(obs, n, T, dev)
    p = build.ptr
    rc = fn(*args, *(p(carry[k]) for k in CARRY),
            *(p(acc[k]) for k in ACC_F), p(acc["n_seconds"]),
            None if o is None else ctypes.byref(o), int(tel_on),
            build.stream_ptr(dev))
    build.check(rc, "block_step_acc")
    _count("acc", site, fleet, kernels, compute_dtype, impl)
    if o is None:
        return carry, acc
    K8.launches += 1
    return carry, acc, _obs_outputs(obs, buf, T)


def _obs_producer_cuda(tables, rows_i, rows_f, k_scan, k_meter, carry, acc,
                       duration_s, meter_max_w, surface_tilt, albedo, site,
                       fleet=None, obs: Observers | None = None,
                       kernels="exact", compute_dtype="f32", layout="scan",
                       impl="threefry2x32", held=None):
    n, T, dev, args = _common_args(tables, rows_i, rows_f, k_scan, k_meter,
                                   carry, duration_s, meter_max_w,
                                   surface_tilt, albedo, site, fleet, kernels,
                                   layout, impl)
    _acc_checks(acc, dev)
    want_csi, want_cov = _prod_wants(obs)
    prod = prod_buffers(n, T, want_csi, want_cov, dev, held)
    p = build.ptr
    fn = build.entry(_library(kernels, compute_dtype, impl),
                     "block_step_prod", _COMMON + [_P] * 14)
    rc = fn(*args, *(p(carry[k]) for k in CARRY),
            *(p(acc[k]) for k in ACC_F), p(acc["n_seconds"]),
            *(p(prod[k]) if k in prod else None
              for k in ("meter", "pv", "csi", "covered")),
            build.stream_ptr(dev))
    build.check(rc, "block_step_prod")
    _count("prod", site, fleet, kernels, compute_dtype, impl)
    return carry, acc, prod


def _prod_wants(obs: Observers | None):
    """Which of csi and the covered flags the observer fold reads."""
    if obs is None:
        return False, False
    return (obs.telemetry != "off",
            obs.telemetry == "full" or obs.analytics == "full")


def _obs_fold_cuda(prod, t, duration_s, obs: Observers):
    buf = _obs_fold_launch(prod, t, duration_s, obs)
    return _obs_outputs(obs, buf, prod["meter"].shape[0])


def _obs_fold_launch(prod, t, duration_s, obs: Observers) -> dict:
    """The observer fold's launch alone: its partial rows and histograms
    (``_obs_outputs`` collapses them)."""
    meter, ac = prod["meter"], prod["pv"]
    dev = meter.device
    T, n = meter.shape
    tel_on = obs.telemetry != "off"
    if obs.analytics == "off":
        raise ValueError("obs_fold: folds with analytics on (telemetry "
                         "alone folds in the acc launch)")
    want_csi, want_cov = _prod_wants(obs)
    _check(meter, torch.float32, dev, "meter")
    _check(ac, torch.float32, dev, "pv")
    _check(t, torch.int32, dev, "t")
    if ac.shape != (T, n) or t.shape != (T,):
        raise ValueError(f"obs_fold: meter and pv must be ({T}, n), t "
                         f"({T},)")
    for k, want, dtype in (("csi", want_csi, torch.float32),
                           ("covered", want_cov, torch.uint8)):
        if want:
            if k not in prod:
                raise ValueError(f"obs_fold: these observers read {k}")
            _check(prod[k], dtype, dev, k)
            if prod[k].shape != (T, n):
                raise ValueError(f"obs_fold: {k} must be ({T}, {n})")
    lib = "wide_fold.cu"
    _obs_struct_check(lib, "wide_obs_struct_size")
    o, buf, smem = _obs_buffers(obs, n, T, dev)
    p = build.ptr
    fn = build.entry(lib, "obs_fold", [ctypes.c_int64, ctypes.c_int,
                                       ctypes.c_int] + [_P] * 6
                     + [ctypes.c_int] * 2)
    rc = fn(n, T, int(duration_s), p(t), p(meter), p(ac),
            p(prod["csi"]) if want_csi else None,
            p(prod["covered"]) if want_cov else None, ctypes.byref(o),
            int(tel_on), smem, build.stream_ptr(dev))
    build.check(rc, "obs_fold")
    OBS_FOLD.launches += 1
    return buf


def step_attrs(epi: str, geo: str, tel: bool = False, kernels="exact",
               compute_dtype="f32", impl="threefry2x32") -> dict:
    """A block-step instantiation's launch shape on the card (``epi``:
    acc, series, trace, scen or prod; ``geo``: a ``GEOMS`` entry;
    ``tel``: the acc launch's telemetry instantiation): registers, CTAs
    per SM at 128 threads, local (spill) bytes."""
    fn = build.entry(_library(kernels, compute_dtype, impl), "step_attrs",
                     [ctypes.c_int] * 3 + [_P])
    out = (ctypes.c_int * 3)()
    codes = {"acc": 0, "series": 1, "trace": 2, "scen": 3, "prod": 4}
    build.check(fn(codes[epi], GEOMS.index(geo), int(tel), out, None),
                "step_attrs")
    return {"regs": out[0], "ctas_per_sm": out[1], "local_bytes": out[2]}


def obs_fold_attrs(n: int, obs: Observers, T: int, dev) -> dict:
    """The observer fold's launch shape on the card at ``n`` chains:
    registers, CTAs per SM, chain groups per CTA and CTAs (one wave)."""
    _, _, smem = _obs_buffers(obs, n, T, dev)
    fn = build.entry("wide_fold.cu", "obs_fold_attrs",
                     [ctypes.c_int64, ctypes.c_int, ctypes.c_int, _P])
    out = (ctypes.c_int * 4)()
    build.check(fn(n, int(obs.telemetry != "off"), smem, out, None),
                "obs_fold_attrs")
    return {"regs": out[0], "ctas_per_sm": out[1],
            "groups_per_cta": out[2], "ctas": out[3], "smem": smem}


_scen_size_checked: set = set()


def _scenario_producer_cuda(tables, rows_i, rows_f, k_scan, k_meter, carry,
                            meter_max_w, surface_tilt, albedo, site=None,
                            fleet=None, kernels="exact", compute_dtype="f32",
                            impl="threefry2x32"):
    n, T, dev, args = _common_args(tables, rows_i, rows_f, k_scan, k_meter,
                                   carry, 0, meter_max_w, surface_tilt,
                                   albedo, site, fleet, kernels, impl=impl)
    out = torch.empty((2, T, n), dtype=torch.float32, device=dev)
    tame = torch.empty(n, dtype=torch.int32, device=dev)
    p = build.ptr
    fn = build.entry(_library(kernels, compute_dtype, impl),
                     "block_step_scenario", _COMMON + [_P] * 6)
    rc = fn(*args, *(p(carry[k]) for k in CARRY), p(out[0]), p(out[1]),
            p(tame), build.stream_ptr(dev))
    build.check(rc, "block_step_scenario")
    _count("scen", site, fleet, kernels, compute_dtype, impl)
    return carry, out[0], out[1], tame


def scenario_fold_layout(T: int, params: flt.FleetParams):
    """The scenario fold's shared memory for a ``T``-second block: ``(the
    sketch in shared memory, dynamic shared bytes)``.  The sketch (the
    row's residual bins, and its exceedance slots past ``MAX_THR``
    thresholds) goes to global memory when it does not fit in
    ``SCN_SMEM_MAX`` beside the T bytes of per-second ramp flags."""
    nb, ne = params.bins + 2, len(params.thresholds) + 1
    sketch = 4 * (nb + (0 if ne - 1 <= MAX_THR else ne))
    flags = -(-T // 4) * 4
    if flags > SCN_SMEM_MAX:
        raise ValueError(f"scenario_fold: a {T} s block does not fit the "
                         "fold's shared memory")
    shared = sketch + flags <= SCN_SMEM_MAX
    return shared, sketch * shared + flags


def _scenario_fold_cuda(meter, ac, t, acc, duration_s, scen, params,
                        cohort=None, per_chain=False, tame=None):
    dev = meter.device
    T, n = meter.shape
    _check(meter, torch.float32, dev, "meter")
    _check(ac, torch.float32, dev, "pv")
    _check(t, torch.int32, dev, "t")
    if ac.shape != (T, n) or t.shape != (T,):
        raise ValueError(f"scenario_fold: meter and pv must be ({T}, n), "
                         f"t ({T},)")
    if T % 60:
        raise ValueError("block length must be a multiple of 60 seconds")
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
    thr, thr_v = _thresholds(params.thresholds, dev, "block_step_scenario")
    lib = "block_step.cu"
    if lib not in _scen_size_checked:
        size = build.entry(lib, "scen_struct_size", [])
        if size(None) != ctypes.sizeof(_Scen):
            raise RuntimeError("block_step_scenario: the Scen layout "
                               "differs between the kernel and its wrapper")
        _scen_size_checked.add(lib)
    hist_shared, smem = scenario_fold_layout(T, params)
    nb, ne = params.bins + 2, len(params.thresholds) + 1
    n_groups = (n + THREADS - 1) // THREADS
    p = build.ptr
    buf = {"res_hist": torch.zeros((B, nb), dtype=torch.int32, device=dev),
           "exceed": torch.zeros((B, ne), dtype=torch.int32, device=dev),
           "part": torch.empty((n_groups, B * len(SCN_KINDS)),
                               dtype=torch.float64, device=dev)}
    if per_chain:
        buf["chain_i"] = torch.empty((len(SCN_CHAIN_I), B, n),
                                     dtype=torch.int32, device=dev)
        buf["chain_f"] = torch.empty((len(SCN_CHAIN_F), B, n),
                                     dtype=torch.float32, device=dev)
    q = _Scen()
    q.B, q.bins, q.n_thr, q.lolp_k = B, params.bins, ne - 1, params.lolp_k
    q.hist_shared, q.T, q.duration_s = int(hist_shared), T, int(duration_s)
    q.ramp_w[:] = list(params.ramp_windows)
    q.lo, q.inv_w, q.capacity = params.lo, params.inv_w, params.capacity_w
    q.n, q.t, q.meter, q.pv, q.thr = n, p(t), p(meter), p(ac), p(thr)
    if tame is not None:
        _check(tame, torch.int32, dev, "tame")
        if tame.shape != (n,):
            raise ValueError(f"scenario_fold: tame must be ({n},)")
        q.tame = p(tame)
    q.thr_v[:] = thr_v
    q.knob_f[:] = [p(scen[k]) for k in SCEN_F]
    q.knob_i[:] = [p(scen[k]) for k in SCEN_I]
    if cohort is not None:
        _check(cohort, torch.int32, dev, "cohort")
        if cohort.shape != (n,):
            raise ValueError(f"block_step_scenario: cohort must be ({n},)")
        q.cohort = p(cohort)
    q.stat_f[:] = [p(acc[k]) for k in ACC_F]
    q.n_seconds = p(acc["n_seconds"])
    for k, v in buf.items():
        setattr(q, k, p(v))
    fn = build.entry(lib, "scenario_fold", [_P, ctypes.c_int])
    rc = fn(ctypes.byref(q), smem, build.stream_ptr(dev))
    build.check(rc, "scenario_fold")
    SCN_FOLD.launches += 1
    L = len(SCN_KINDS)
    f = collapse_group([(buf["part"], SCN_KINDS)])[0].view(B, L)
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
    return acc, delta


def _scenario_cuda(tables, rows_i, rows_f, k_scan, k_meter, carry, acc,
                   duration_s, meter_max_w, surface_tilt, albedo, site=None,
                   fleet=None, scen=None, params=None, cohort=None,
                   per_chain=False, kernels="exact", compute_dtype="f32",
                   impl="threefry2x32"):
    _scenario_check(scen)
    carry, meter, ac, tame = _scenario_producer_cuda(
        tables, rows_i, rows_f, k_scan, k_meter, carry, meter_max_w,
        surface_tilt, albedo, site, fleet, kernels, compute_dtype, impl)
    acc, delta = _scenario_fold_cuda(meter, ac, rows_i[0], acc, duration_s,
                                     scen, params, cohort, per_chain, tame)
    return carry, acc, delta


def series_partials_cuda(tables, rows_i, rows_f, k_scan, k_meter, carry,
                         meter_max_w, surface_tilt, albedo, site=None,
                         fleet=None, kernels="exact", compute_dtype="f32",
                         layout="scan", impl="threefry2x32"):
    """The series kernel's first pass on the card: ``(carry, partials)``
    with ``partials[0 | 1]`` the ``(n_ctas, T)`` per-CTA sums of meter |
    pv."""
    n, T, dev, args = _common_args(tables, rows_i, rows_f, k_scan, k_meter,
                                   carry, 0, meter_max_w, surface_tilt,
                                   albedo, site, fleet, kernels, layout,
                                   impl)
    n_ctas = (n + THREADS - 1) // THREADS
    part = torch.empty((2, n_ctas, T), dtype=torch.float32, device=dev)
    p = build.ptr
    fn = build.entry(_library(kernels, compute_dtype, impl),
                     "block_step_series", _COMMON + [_P] * 5)
    rc = fn(*args, *(p(carry[k]) for k in CARRY), p(part[0]), p(part[1]),
            build.stream_ptr(dev))
    build.check(rc, "block_step_series")
    _count("series", site, fleet, kernels, compute_dtype, impl)
    return carry, part


def series_strands(parts, strands=None, first: int = 0):
    """The first stage of ``series_sum``'s fixed order: series parts
    ``(2, k, T)`` added, in float64 and in index order, to strands ``(2,
    SUM_STRANDS, T)`` (new ones from 0.0, or ``strands``, updated in
    place): part ``c`` to strand ``(first + c) % SUM_STRANDS``.  With
    ``first`` the number of parts folded before, consecutive chain
    ranges fold as one range does."""
    p = parts.double()
    if strands is None:
        strands = torch.zeros((p.shape[0], SUM_STRANDS, p.shape[2]),
                              dtype=torch.float64, device=p.device)
    c = 0
    while c < p.shape[1]:
        j = (first + c) % SUM_STRANDS
        w = min(SUM_STRANDS - j, p.shape[1] - c)
        strands[:, j:j + w] += p[:, c:c + w]
        c += w
    return strands


def strands_total(strands):
    """The second stage: the strands ``(2, SUM_STRANDS, T)`` added in
    index order from 0.0 and rounded once, ``(2, T)`` float32."""
    tot = torch.zeros((strands.shape[0], strands.shape[2]),
                      dtype=torch.float64, device=strands.device)
    for j in range(SUM_STRANDS):
        tot = tot + strands[:, j]
    return tot.float()


def series_sum_plain(part):
    """Plain cross-CTA sum: ``(2, n_ctas, T)`` partials -> ``(2, T)``,
    in float64 in the kernel's order, rounded once: strand ``j`` of
    ``SUM_STRANDS`` adds partials ``j, j + SUM_STRANDS, ...`` from 0.0,
    then the strands are added in index order from 0.0, so the kernel
    equals it bit for bit."""
    return strands_total(series_strands(part))


_SUM_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [_P] * 4


def series_sum(part):
    """The series epilogue's second pass: the per-CTA partials summed over
    CTAs, ``(2, n_ctas, T)`` -> ``(2, T)``; on the card in
    ``series_sum_plain``'s fixed order (``SUM_STRANDS`` strands per
    second, spread over the whole card)."""
    if part.device.type == "cpu":
        return series_sum_plain(part)
    if part.device.type != "cuda":
        raise ValueError(f"unsupported device {part.device}")
    dev = part.device
    _check(part, torch.float32, dev, "partials")
    if part.dim() != 3 or part.shape[0] != 2:
        raise ValueError("series_sum: partials must be (2, n_ctas, T)")
    _, n_ctas, T = part.shape
    out = torch.empty((2, T), dtype=torch.float32, device=dev)
    fn = build.entry("block_step.cu", "series_sum", _SUM_ARGTYPES)
    # the halves' addresses from the base pointers (no views: this launch
    # is short enough for the host's per-call work to show)
    src, dst = part.data_ptr(), out.data_ptr()
    rc = fn(n_ctas, T, src, src + 4 * n_ctas * T, dst, dst + 4 * T,
            build.stream_ptr(dev))
    build.check(rc, "series_sum")
    K4_SUM.launches += 1
    return out


def _trace_cuda(tables, rows_i, rows_f, k_scan, k_meter, carry,
                meter_max_w, surface_tilt, albedo, site, fleet=None,
                kernels="exact", compute_dtype="f32", layout="trace",
                impl="threefry2x32"):
    n, T, dev, args = _common_args(tables, rows_i, rows_f, k_scan, k_meter,
                                   carry, 0, meter_max_w, surface_tilt,
                                   albedo, site, fleet, kernels, layout, impl)
    out = torch.empty((2, T, n), dtype=torch.float32, device=dev)
    p = build.ptr
    fn = build.entry(_library(kernels, compute_dtype, impl),
                     "block_step_trace", _COMMON + [_P] * 5)
    rc = fn(*args, *(p(carry[k]) for k in CARRY), p(out[0]), p(out[1]),
            build.stream_ptr(dev))
    build.check(rc, "block_step_trace")
    _count("trace", site, fleet, kernels, compute_dtype, impl)
    return carry, out[0], out[1]


def _dispatch(k_scan, cuda_fn, plain_fn, *args, **kw):
    if kw.get("compute_dtype", "f32") not in COMPUTE_DTYPES:
        raise ValueError(f"block_step: compute_dtype "
                         f"{kw['compute_dtype']!r} must be one of "
                         f"{COMPUTE_DTYPES}")
    rng.check_keys(k_scan, kw.get("impl", "threefry2x32"))
    if k_scan.device.type == "cuda":
        return cuda_fn(*args, **kw)
    if k_scan.device.type != "cpu":
        raise ValueError(f"unsupported device {k_scan.device}")
    return plain_fn(*args, **kw)


def block_step_acc(tables, rows_i, rows_f, k_scan, k_meter, carry, acc,
                   duration_s: int, meter_max_w: float, surface_tilt,
                   albedo, site: SiteGeometry | None = None,
                   fleet: FleetLeaves | None = None, kernels: str = "exact",
                   compute_dtype: str = "f32", layout: str = "scan",
                   impl: str = "threefry2x32"):
    """Fold one block into the accumulator; returns ``(carry, acc)``.

    ``tables``: value-major K2 tables; ``rows_i``/``rows_f``: the block's
    rows (``block_rows``, or ``site_rows`` with ``site=``, when
    ``surface_tilt`` and ``albedo`` are None); ``carry``/``acc``: dicts of
    ``(n,)`` tensors (``CARRY`` float32; ``ACC_F`` float32 and int32
    ``n_seconds``); ``fleet``: K7's per-chain leaves; ``kernels``: the
    transcendental set, 'exact' or 'table' (K11); ``compute_dtype``:
    'f32' or 'bf16' (K12); ``layout``: the draw layout of rbg and
    unsafe_rbg keys (``clearsky_index.DRAW_LAYOUTS``; threefry keys draw
    the same values in every layout); ``impl``: the keys' implementation
    (the run's ``prng_impl``: K13 rbg, K14 unsafe_rbg)."""
    return _dispatch(k_scan, _block_step_cuda, block_step_plain, tables,
                     rows_i, rows_f, k_scan, k_meter, carry, acc,
                     duration_s, meter_max_w, surface_tilt, albedo, site,
                     fleet, kernels=kernels, compute_dtype=compute_dtype,
                     layout=layout, impl=impl)


def block_step_obs(tables, rows_i, rows_f, k_scan, k_meter, carry, acc,
                   duration_s: int, meter_max_w: float, surface_tilt,
                   albedo, site: SiteGeometry | None = None,
                   fleet: FleetLeaves | None = None,
                   obs: Observers = None, kernels: str = "exact",
                   compute_dtype: str = "f32", layout: str = "scan",
                   impl: str = "threefry2x32", held: dict | None = None):
    """``block_step_acc`` with the reduce-mode observers (K8 telemetry, K9
    analytics): ``(carry, acc, out)``, ``out`` as ``block_step_obs_plain``
    returns it.  On the card telemetry alone folds in the acc launch; with
    analytics on the acc producer writes the block's arrays and the
    observer fold folds both observers over them (``obs_producer``,
    ``obs_fold``); the per-block deltas come zero-initialised out of the
    kernels and their collapse.  ``held``: a dict in which the producer's
    arrays stay from one call to the next (``prod_buffers``); None: new
    arrays each call."""
    if obs is None or (obs.telemetry == "off" and obs.analytics == "off"):
        raise ValueError("block_step_obs: no observer is on")

    def cuda(*a, **kw):
        return _block_step_cuda(*a, **kw, held=held)

    return _dispatch(k_scan, cuda, block_step_obs_plain, tables,
                     rows_i, rows_f, k_scan, k_meter, carry, acc,
                     duration_s, meter_max_w, surface_tilt, albedo, site,
                     fleet=fleet, obs=obs, kernels=kernels,
                     compute_dtype=compute_dtype, layout=layout, impl=impl)


def obs_producer(tables, rows_i, rows_f, k_scan, k_meter, carry, acc,
                 duration_s: int, meter_max_w: float, surface_tilt, albedo,
                 site: SiteGeometry | None = None,
                 fleet: FleetLeaves | None = None, obs: Observers = None,
                 kernels: str = "exact", compute_dtype: str = "f32",
                 layout: str = "scan", impl: str = "threefry2x32"):
    """The acc producer on its own (the first launch of ``block_step_obs``
    with analytics on): ``(carry, acc, prod)``, ``prod`` the block's
    time-major ``(T, n)`` arrays that ``obs_fold`` reads for ``obs``
    (``meter``, ``pv`` and on the card only those the observers read:
    ``csi`` with telemetry, uint8 ``covered`` with telemetry or analytics
    at level full; the plain version returns all four, ``covered``
    bool).  On the card the arrays are new tensors."""

    def plain(*a, obs=None, **kw):
        return obs_producer_plain(*a, **kw)

    return _dispatch(k_scan, _obs_producer_cuda, plain, tables, rows_i,
                     rows_f, k_scan, k_meter, carry, acc, duration_s,
                     meter_max_w, surface_tilt, albedo, site, fleet, obs=obs,
                     kernels=kernels, compute_dtype=compute_dtype,
                     layout=layout, impl=impl)


def obs_fold(prod: dict, t, duration_s: int, obs: Observers):
    """The observer fold on its own (the second launch of
    ``block_step_obs`` with analytics on): the observers' folds of the
    producer's ``(T, n)`` arrays (``t``: the block's ``(T,)`` int32
    global seconds), zero-initialised for the block, and their
    ``reduce_chainwise``.  Returns ``out`` as ``block_step_obs``'s."""
    dev = prod["meter"].device
    if dev.type == "cuda":
        return _obs_fold_cuda(prod, t, duration_s, obs)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return obs_fold_plain(prod, t, duration_s, obs)


def block_step_scenario(tables, rows_i, rows_f, k_scan, k_meter, carry,
                        acc, duration_s: int, meter_max_w: float,
                        surface_tilt, albedo,
                        site: SiteGeometry | None = None,
                        fleet: FleetLeaves | None = None, scen: dict = None,
                        params: flt.FleetParams = None, cohort=None,
                        per_chain: bool = False, kernels: str = "exact",
                        compute_dtype: str = "f32",
                        impl: str = "threefry2x32"):
    """One scenario-batched block (K10; under bf16 K12 in K10): the step
    once per chain-second (on the card the producer launch, writing the
    block's meter and pv), then each row of ``scen`` (``(B,)`` knob
    tensors, ``serve.schema.encode_batch``) folds its own transform of
    them (on the card the fold launch) into
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
                     compute_dtype=compute_dtype, impl=impl)


def scenario_producer(tables, rows_i, rows_f, k_scan, k_meter, carry,
                      meter_max_w: float, surface_tilt, albedo,
                      site: SiteGeometry | None = None,
                      fleet: FleetLeaves | None = None,
                      kernels: str = "exact", compute_dtype: str = "f32",
                      impl: str = "threefry2x32"):
    """K10's first launch on its own: ``(carry, meter, pv)``, the block's
    time-major ``(T, n)`` meter and pv as the scenario fold reads them
    (the flat scan's draws; under bf16 bf16 draws, as the acc epilogue).
    On the card ``_scenario_producer_cuda`` also returns the chains'
    flags that ``scenario_fold(tame=)`` takes."""
    def cuda(*a, **kw):
        return _scenario_producer_cuda(*a, **kw)[:3]

    return _dispatch(k_scan, cuda, scenario_producer_plain, tables, rows_i,
                     rows_f, k_scan, k_meter, carry, meter_max_w,
                     surface_tilt, albedo, site, fleet, kernels=kernels,
                     compute_dtype=compute_dtype, impl=impl)


def scenario_fold(meter, pv, t, acc, duration_s: int, scen: dict = None,
                  params: flt.FleetParams = None, cohort=None,
                  per_chain: bool = False, tame=None):
    """K10's second launch on its own: every row of ``scen`` folds its
    transform of the ``(T, n)`` meter and pv (``t``: the block's ``(T,)``
    int32 global seconds) into ``acc`` (updated in place on the card)
    and a zero-initialised ``risk`` FleetAcc.  Returns ``(acc, delta)``
    as ``block_step_scenario``'s.  ``tame``: on the card, the producer's
    ``(n,)`` int32 flags (a chain's values all at most 1e18 in magnitude,
    csrc/block_step.cuh ``SCN_TAME``), with which a (row, chain) past its
    last valid second skips the rest of the block's loads; they change no
    result."""
    if scen is None or params is None:
        raise ValueError("scenario_fold: needs scen= and params=")
    if meter.device.type == "cuda":
        return _scenario_fold_cuda(meter, pv, t, acc, duration_s, scen,
                                   params, cohort, per_chain, tame)
    if meter.device.type != "cpu":
        raise ValueError(f"unsupported device {meter.device}")
    return scenario_fold_plain(meter, pv, t, acc, duration_s, scen, params,
                               cohort, per_chain)


def block_step_series(tables, rows_i, rows_f, k_scan, k_meter, carry,
                      meter_max_w: float, surface_tilt, albedo,
                      site: SiteGeometry | None = None,
                      fleet: FleetLeaves | None = None,
                      kernels: str = "exact", compute_dtype: str = "f32",
                      layout: str = "scan", impl: str = "threefry2x32"):
    """One ensemble block: ``(carry, meter_sum, pv_sum)``, the sums
    ``(T,)`` over chains per second: ``block_step_series_parts``, then
    ``series_total``.  On the card a fixed-order reduction (per CTA, then
    over CTAs in index order): a repeated run gives the same bits."""
    carry, parts = block_step_series_parts(
        tables, rows_i, rows_f, k_scan, k_meter, carry, meter_max_w,
        surface_tilt, albedo, site, fleet, kernels=kernels,
        compute_dtype=compute_dtype, layout=layout, impl=impl)
    out = series_total(parts)
    return carry, out[0], out[1]


def block_step_series_parts(tables, rows_i, rows_f, k_scan, k_meter,
                            carry, meter_max_w: float, surface_tilt,
                            albedo, site: SiteGeometry | None = None,
                            fleet: FleetLeaves | None = None,
                            kernels: str = "exact",
                            compute_dtype: str = "f32",
                            layout: str = "scan",
                            impl: str = "threefry2x32"):
    """``block_step_series`` before its last fold: ``(carry, parts)`` for
    ``series_total`` (the slab scheduler joins the slabs' parts before
    it folds them, so that a slabbed run keeps the unslabbed sums)."""
    return _dispatch(k_scan, series_partials_cuda, series_parts_plain,
                     tables, rows_i, rows_f, k_scan, k_meter, carry,
                     meter_max_w, surface_tilt, albedo, site, fleet,
                     kernels=kernels, compute_dtype=compute_dtype,
                     layout=layout, impl=impl)


def block_step_trace(tables, rows_i, rows_f, k_scan, k_meter, carry,
                     meter_max_w: float, surface_tilt, albedo,
                     site: SiteGeometry | None = None,
                     fleet: FleetLeaves | None = None,
                     kernels: str = "exact", compute_dtype: str = "f32",
                     layout: str = "trace", impl: str = "threefry2x32"):
    """One trace block: ``(carry, meter, pv)``, time-major ``(T, n)``."""
    return _dispatch(k_scan, _trace_cuda, trace_plain, tables, rows_i,
                     rows_f, k_scan, k_meter, carry, meter_max_w,
                     surface_tilt, albedo, site, fleet, kernels=kernels,
                     compute_dtype=compute_dtype, layout=layout, impl=impl)


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


def nan_minmax_plain(a, b, lo: float, hi: float):
    """Plain ``nan_minmax``: ``torch.minimum(a, b)``, ``torch.maximum(a,
    b)`` and ``torch.clamp(a, lo, hi)`` stacked into ``(3, n)``: the
    NaN-keeping operations the kernels' helpers stand for."""
    return torch.stack([torch.minimum(a, b), torch.maximum(a, b),
                        torch.clamp(a, lo, hi)])


def nan_minmax(a, b, lo: float, hi: float):
    """The kernels' NaN-keeping minimum, maximum and clamp
    (csrc/nanminmax.cuh) on their own, a test entry: ``(3, n)`` float32
    of ``(n,)`` float32 ``a`` and ``b``; on the CPU, the plain version."""
    dev = a.device
    if dev.type == "cpu":
        return nan_minmax_plain(a, b, lo, hi)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = a.shape[0]
    if a.dim() != 1 or b.shape != a.shape:
        raise ValueError("nan_minmax: a and b must be (n,) alike")
    _check(a, torch.float32, dev, "a")
    _check(b, torch.float32, dev, "b")
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    fn = build.entry("block_step.cu", "nan_minmax",
                     [ctypes.c_int64, _P, _P, ctypes.c_float,
                      ctypes.c_float, _P])
    p = build.ptr
    rc = fn(n, p(a), p(b), lo, hi, p(out), build.stream_ptr(dev))
    build.check(rc, "nan_minmax")
    return out
