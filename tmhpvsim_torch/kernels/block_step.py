"""K3, K4 and K6: the fused per-second step of one block, with three
epilogues and two geometry modes.

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
  rows instead).

Every epilogue shares one pre-fold body: for every chain and second the
table lerps, the renewal step (a new cycle from ``cycle_from_u`` on
redraw), the csi composition, ``pv.power_from_csi`` and the meter, fed by
``scan_draws_tmajor`` / ``meter_block_tmajor`` (models/clearsky_index.py
:278-319).  ``block_step_plain``, ``series_plain`` and ``trace_plain`` are
that body (``_body_plain``) plus their epilogue, so the three cannot
drift apart; the CUDA kernel (csrc/block_step.cu) is one template over
the epilogue and the geometry mode.

Each wrapper runs its plain version on CPU tensors and launches the
kernel on CUDA tensors; every variant counts its launches.  The kernels
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

from tmhpvsim_torch.config import SITE_FIELDS
from tmhpvsim_torch.data import SANDIA_INVERTER, SAPM_MODULE
from tmhpvsim_torch.kernels import build
from tmhpvsim_torch.models import clearsky_index as ci
from tmhpvsim_torch.models import distributions as dist
from tmhpvsim_torch.models import pv, renewal, solar

K3 = build.LaunchCounter("block_step")
K6 = build.LaunchCounter("block_step_site")
K4_SERIES = build.LaunchCounter("block_step_series")
K4_SERIES_SITE = build.LaunchCounter("block_step_series_site")
K4_SUM = build.LaunchCounter("series_sum")
K4_TRACE = build.LaunchCounter("block_step_trace")
K4_TRACE_SITE = build.LaunchCounter("block_step_trace_site")
#: every counter of this module, in (epilogue, geometry) order
COUNTERS = (K3, K6, K4_SERIES, K4_SERIES_SITE, K4_SUM, K4_TRACE,
            K4_TRACE_SITE)

#: per-second integer rows: global second, rebased hour / day / minute index
ROWS_I = ("t", "h", "d", "m")
#: per-second float rows of the shared mode: calendar fractions, then
#: block_geometry's fields
ROWS_F = ("hf", "df", "mf", "zenith", "cos_zenith", "apparent_zenith",
          "azimuth", "csi_cap", "ghi_clear", "dni_extra", "airmass_abs",
          "cos_aoi", "doy")
#: per-second float rows of the site mode: calendar fractions, then the
#: float32-safe split time (the geometry is per chain, on the device)
ROWS_F_SITE = ("hf", "df", "mf", "day2000", "sec_of_day", "doy")
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

_BIG = float(np.finfo(np.float32).max)


@dataclasses.dataclass
class SiteGeometry:
    """The per-chain inputs of the site-geometry mode: ``site`` maps each
    ``config.SITE_FIELDS`` entry to an ``(n,)`` float32 tensor, ``turbidity`` is the
    grid's ``(12,)`` monthly Linke climatology."""

    site: dict
    turbidity: torch.Tensor


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


def _rows(block_idx, mlo, tail):
    ints = np.stack([block_idx["t"], block_idx["hour_idx"],
                     block_idx["day_idx"],
                     block_idx["min_idx"] - np.int32(mlo)]).astype(np.int32)
    fl = [block_idx["hour_frac"], block_idx["day_frac"],
          block_idx["min_frac"]] + list(tail)
    return ints, np.stack(fl).astype(np.float32)


def _geometry(rows_f, surface_tilt, albedo, site: SiteGeometry | None):
    """The ``power_from_csi`` geometry of a block: the shared rows as
    ``(T, 1)`` columns, or every chain's device geometry ``(T, n)``."""
    if site is None:
        g = {k: rows_f[i][:, None] for i, k in enumerate(ROWS_F)}
        g["surface_tilt"] = surface_tilt
        g["albedo"] = albedo
        return g
    r = {k: rows_f[i][:, None] for i, k in enumerate(ROWS_F_SITE)}
    s = site.site
    return solar.device_geometry(
        r["day2000"], r["sec_of_day"], r["doy"], s["latitude"],
        s["longitude"], s["altitude"], s["surface_tilt"],
        s["surface_azimuth"], s["albedo"], site.turbidity)


def _body_plain(tables, rows_i, rows_f, k_scan, k_meter, carry,
                meter_max_w, surface_tilt, albedo, site):
    """The pre-fold body every epilogue shares: everything carry-
    independent over the whole block at once, the renewal compare/select
    second by second.  Returns ``(carry, meter, ac)`` with time-major
    ``(T, n)`` meter and ac."""
    T = rows_i.shape[1]
    g0 = int(rows_i[0, 0]) // 60
    u, z = ci.scan_draws_tmajor(k_scan, g0, T // 60)
    meter = ci.meter_block_tmajor(k_meter, g0, T // 60, meter_max_w)
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
    ac = pv.power_from_csi(csi, _geometry(rows_f, surface_tilt, albedo,
                                          site),
                           SAPM_MODULE, SANDIA_INVERTER)
    return carry, meter, ac


def block_step_plain(tables, rows_i, rows_f, k_scan, k_meter, carry, acc,
                     duration_s: int, meter_max_w: float,
                     surface_tilt, albedo, site: SiteGeometry | None = None):
    """Plain torch K3 / K6 (the ``acc`` epilogue): the shared body, then
    the statistics fold second by second (in second order, as the scan
    adds).  Returns ``(carry, acc)``."""
    carry, meter, ac = _body_plain(tables, rows_i, rows_f, k_scan, k_meter,
                                   carry, meter_max_w, surface_tilt, albedo,
                                   site)
    residual = meter - ac
    T = rows_i.shape[1]
    valid = rows_i[0] < duration_s
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
    return carry, acc


def series_plain(tables, rows_i, rows_f, k_scan, k_meter, carry,
                 meter_max_w: float, surface_tilt, albedo,
                 site: SiteGeometry | None = None):
    """Plain K4 series: the shared body, then each second's cross-chain
    sums of meter and pv (accumulated in float64, rounded once to
    float32).  Returns ``(carry, meter_sum, pv_sum)``, each ``(T,)``;
    padding seconds are summed too (the engine trims them)."""
    carry, meter, ac = _body_plain(tables, rows_i, rows_f, k_scan, k_meter,
                                   carry, meter_max_w, surface_tilt, albedo,
                                   site)
    return (carry, meter.double().sum(1).float(),
            ac.double().sum(1).float())


def trace_plain(tables, rows_i, rows_f, k_scan, k_meter, carry,
                meter_max_w: float, surface_tilt, albedo,
                site: SiteGeometry | None = None):
    """Plain K4 trace: the shared body's every chain-second.  Returns
    ``(carry, meter, pv)`` with time-major ``(T, n)`` arrays."""
    return _body_plain(tables, rows_i, rows_f, k_scan, k_meter, carry,
                       meter_max_w, surface_tilt, albedo, site)


def cos_tilt(surface_tilt: float) -> float:
    """cos of the panel tilt as the plain version computes it (float32)."""
    return float(torch.cos(torch.tensor(surface_tilt * pv.DEG,
                                        dtype=torch.float32)))


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
#: the arguments every block-step entry takes, before its outputs
_COMMON = ([ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float] + [_P] * 17)


def _check(t, dtype, dev, what):
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"block_step: {what} must be a contiguous "
                         f"{dtype} tensor on {dev}")


def _common_args(tables, rows_i, rows_f, k_scan, k_meter, carry,
                 duration_s, meter_max_w, surface_tilt, albedo, site):
    """Validate the shared inputs and return the C arguments they fill."""
    n = k_scan.shape[0]
    T = rows_i.shape[1]
    dev = k_scan.device
    if T % 60:
        raise ValueError("block length must be a multiple of 60 seconds")
    names = ROWS_F if site is None else ROWS_F_SITE
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
        geo = [None] * 7
        ct, alb = cos_tilt(surface_tilt), albedo
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
        geo = [p(site.site[k]) for k in SITE_FIELDS] + [p(site.turbidity)]
        ct, alb = 0.0, 0.0
    args = [int(site is not None), n, T, int(duration_s), meter_max_w, ct,
            alb, p(rows_i), p(rows_f),
            *(p(tables[k]) for k in ("cc", "cloudy", "clear_day", "ws", "ml",
                                     "mc")),
            p(k_scan), p(k_meter), *geo]
    return n, T, dev, args


def _block_step_cuda(tables, rows_i, rows_f, k_scan, k_meter, carry, acc,
                     duration_s, meter_max_w, surface_tilt, albedo, site):
    n, T, dev, args = _common_args(tables, rows_i, rows_f, k_scan, k_meter,
                                   carry, duration_s, meter_max_w,
                                   surface_tilt, albedo, site)
    for k in ACC_F:
        _check(acc[k], torch.float32, dev, f"acc {k}")
    _check(acc["n_seconds"], torch.int32, dev, "acc n_seconds")
    fn = build.entry("block_step.cu", "block_step_acc", _COMMON + [_P] * 10)
    p = build.ptr
    rc = fn(*args, *(p(carry[k]) for k in CARRY),
            *(p(acc[k]) for k in ACC_F), p(acc["n_seconds"]),
            build.stream_ptr(dev))
    build.check(rc, "block_step_acc")
    (K3 if site is None else K6).launches += 1
    return carry, acc


def series_partials_cuda(tables, rows_i, rows_f, k_scan, k_meter, carry,
                         meter_max_w, surface_tilt, albedo, site=None):
    """The series kernel's first pass on the card: ``(carry, partials)``
    with ``partials[0 | 1]`` the ``(n_ctas, T)`` per-CTA sums of meter |
    pv."""
    n, T, dev, args = _common_args(tables, rows_i, rows_f, k_scan, k_meter,
                                   carry, 0, meter_max_w, surface_tilt,
                                   albedo, site)
    n_ctas = (n + THREADS - 1) // THREADS
    part = torch.empty((2, n_ctas, T), dtype=torch.float32, device=dev)
    p = build.ptr
    fn = build.entry("block_step.cu", "block_step_series", _COMMON + [_P] * 5)
    rc = fn(*args, *(p(carry[k]) for k in CARRY), p(part[0]), p(part[1]),
            build.stream_ptr(dev))
    build.check(rc, "block_step_series")
    (K4_SERIES if site is None else K4_SERIES_SITE).launches += 1
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
                 meter_max_w, surface_tilt, albedo, site):
    carry, part = series_partials_cuda(tables, rows_i, rows_f, k_scan,
                                       k_meter, carry, meter_max_w,
                                       surface_tilt, albedo, site)
    out = series_sum(part)
    return carry, out[0], out[1]


def _trace_cuda(tables, rows_i, rows_f, k_scan, k_meter, carry,
                meter_max_w, surface_tilt, albedo, site):
    n, T, dev, args = _common_args(tables, rows_i, rows_f, k_scan, k_meter,
                                   carry, 0, meter_max_w, surface_tilt,
                                   albedo, site)
    out = torch.empty((2, T, n), dtype=torch.float32, device=dev)
    p = build.ptr
    fn = build.entry("block_step.cu", "block_step_trace", _COMMON + [_P] * 5)
    rc = fn(*args, *(p(carry[k]) for k in CARRY), p(out[0]), p(out[1]),
            build.stream_ptr(dev))
    build.check(rc, "block_step_trace")
    (K4_TRACE if site is None else K4_TRACE_SITE).launches += 1
    return carry, out[0], out[1]


def _dispatch(k_scan, cuda_fn, plain_fn, *args):
    if k_scan.device.type == "cuda":
        return cuda_fn(*args)
    if k_scan.device.type != "cpu":
        raise ValueError(f"unsupported device {k_scan.device}")
    return plain_fn(*args)


def block_step_acc(tables, rows_i, rows_f, k_scan, k_meter, carry, acc,
                   duration_s: int, meter_max_w: float, surface_tilt,
                   albedo, site: SiteGeometry | None = None):
    """Fold one block into the accumulator; returns ``(carry, acc)``.

    ``tables``: value-major K2 tables; ``rows_i``/``rows_f``: the block's
    rows (``block_rows``, or ``site_rows`` with ``site=``, when
    ``surface_tilt`` and ``albedo`` are None); ``carry``/``acc``: dicts of
    ``(n,)`` tensors (``CARRY`` float32; ``ACC_F`` float32 and int32
    ``n_seconds``)."""
    return _dispatch(k_scan, _block_step_cuda, block_step_plain, tables,
                     rows_i, rows_f, k_scan, k_meter, carry, acc,
                     duration_s, meter_max_w, surface_tilt, albedo, site)


def block_step_series(tables, rows_i, rows_f, k_scan, k_meter, carry,
                      meter_max_w: float, surface_tilt, albedo,
                      site: SiteGeometry | None = None):
    """One ensemble block: ``(carry, meter_sum, pv_sum)``, the sums
    ``(T,)`` over chains per second.  On the card a fixed-order reduction
    (per CTA, then over CTAs in index order): a repeated run gives the
    same bits."""
    return _dispatch(k_scan, _series_cuda, series_plain, tables, rows_i,
                     rows_f, k_scan, k_meter, carry, meter_max_w,
                     surface_tilt, albedo, site)


def block_step_trace(tables, rows_i, rows_f, k_scan, k_meter, carry,
                     meter_max_w: float, surface_tilt, albedo,
                     site: SiteGeometry | None = None):
    """One trace block: ``(carry, meter, pv)``, time-major ``(T, n)``."""
    return _dispatch(k_scan, _trace_cuda, trace_plain, tables, rows_i,
                     rows_f, k_scan, k_meter, carry, meter_max_w,
                     surface_tilt, albedo, site)


def geometry_fields_plain(rows_f, site: SiteGeometry):
    """Plain ``device_geometry_fields``: ``solar.device_geometry`` stacked
    into ``(9, T, n)``."""
    g = _geometry(rows_f, None, None, site)
    shape = (rows_f.shape[1], site.site["latitude"].shape[0])
    return torch.stack([torch.broadcast_to(g[k], shape)
                        for k in GEOM_FIELDS])


def device_geometry_fields(rows_f, site: SiteGeometry):
    """The site mode's per-chain geometry on its own: ``(9, T, n)``
    float32, the ``GEOM_FIELDS`` of every chain and second of the block
    whose site rows are ``rows_f`` (``(6, T)``).  A test entry of the
    kernel's geometry device function; on the CPU, the plain
    ``solar.device_geometry``."""
    dev = rows_f.device
    if dev.type == "cpu":
        return geometry_fields_plain(rows_f, site)
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
    fn = build.entry("block_step.cu", "device_geometry_fields",
                     [ctypes.c_int64, ctypes.c_int] + [_P] * 9)
    rc = fn(n, T, p(rows_f), *(p(site.site[k]) for k in SITE_FIELDS),
            p(site.turbidity), p(out), build.stream_ptr(dev))
    build.check(rc, "device_geometry_fields")
    return out
