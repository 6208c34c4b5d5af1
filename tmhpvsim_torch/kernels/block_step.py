"""K3: the fused per-second step of one reduce-mode block.

Replaces ``Simulation._block_step_scan_acc`` (tmhpvsim_tpu/engine/
simulation.py:1276): ``_scan_block_setup.step`` (:1190-1242) plus
``_make_acc_body`` (:1246-1272), fed by ``scan_draws_tmajor`` /
``meter_block_tmajor`` (models/clearsky_index.py:278-319).  For every
chain and second: the table lerps, the renewal step (a new cycle from
``cycle_from_u`` on redraw), the csi composition, ``pv.power_from_csi``,
the meter, and the masked fold of the seven ``REDUCE_STATS``.

``block_step_acc`` runs ``block_step_plain`` on CPU tensors and launches
the CUDA kernel (csrc/block_step.cu) on CUDA tensors; ``K3.launches``
counts the launches.  The kernel updates ``carry`` and ``acc`` in place
(one chain per thread, each reading and writing only its own entries);
the plain version returns new tensors.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from tmhpvsim_torch.data import SANDIA_INVERTER, SAPM_MODULE
from tmhpvsim_torch.kernels import build
from tmhpvsim_torch.models import clearsky_index as ci
from tmhpvsim_torch.models import distributions as dist
from tmhpvsim_torch.models import pv, renewal

K3 = build.LaunchCounter("block_step")

#: per-second integer rows: global second, rebased hour / day / minute index
ROWS_I = ("t", "h", "d", "m")
#: per-second float rows: calendar fractions, then block_geometry's fields
ROWS_F = ("hf", "df", "mf", "zenith", "cos_zenith", "apparent_zenith",
          "azimuth", "csi_cap", "ghi_clear", "dni_extra", "airmass_abs",
          "cos_aoi", "doy")
CARRY = ("cloud_end", "total_end", "sec")
ACC_F = ("pv_sum", "pv_max", "meter_sum", "residual_sum", "residual_min",
         "residual_max")

_BIG = float(np.finfo(np.float32).max)


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
    }


def block_rows(block_idx: dict, mlo: int, geom: dict):
    """Pack one block's shared per-second inputs (numpy, from the engine's
    host_inputs) into the ``(4, T)`` int32 and ``(13, T)`` float32 rows."""
    ints = np.stack([block_idx["t"], block_idx["hour_idx"],
                     block_idx["day_idx"],
                     block_idx["min_idx"] - np.int32(mlo)]).astype(np.int32)
    fl = [block_idx["hour_frac"], block_idx["day_frac"],
          block_idx["min_frac"]]
    fl += [geom[k] for k in ROWS_F[3:]]
    return ints, np.stack(fl).astype(np.float32)


def _geometry(rows_f, surface_tilt: float, albedo: float):
    g = {k: rows_f[i][:, None] for i, k in enumerate(ROWS_F)}
    g["surface_tilt"] = surface_tilt
    g["albedo"] = albedo
    return g


def block_step_plain(tables, rows_i, rows_f, k_scan, k_meter, carry, acc,
                     duration_s: int, meter_max_w: float,
                     surface_tilt: float, albedo: float):
    """Plain torch K3: everything carry-independent over the whole block
    at once, then the renewal compare/select and the statistics fold
    second by second (the fold in second order, as the scan adds).
    Returns ``(carry, acc)``."""
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
    ac = pv.power_from_csi(csi, _geometry(rows_f, surface_tilt, albedo),
                           SAPM_MODULE, SANDIA_INVERTER)
    residual = meter - ac
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


def cos_tilt(surface_tilt: float) -> float:
    """cos of the panel tilt as the plain version computes it (float32)."""
    return float(torch.cos(torch.tensor(surface_tilt * pv.DEG,
                                        dtype=torch.float32)))


def _block_step_cuda(tables, rows_i, rows_f, k_scan, k_meter, carry, acc,
                     duration_s, meter_max_w, surface_tilt, albedo):
    n = k_scan.shape[0]
    T = rows_i.shape[1]
    dev = k_scan.device
    if T % 60:
        raise ValueError("block length must be a multiple of 60 seconds")
    if rows_i.shape[0] != len(ROWS_I) or rows_f.shape != (len(ROWS_F), T):
        raise ValueError("block_step: rows must be (4, T) int32 and "
                         "(13, T) float32")
    f32 = [rows_f] + [tables[k] for k in ("cc", "cloudy", "clear_day", "ws",
                                          "ml", "mc")]
    f32 += [carry[k] for k in CARRY] + [acc[k] for k in ACC_F]
    for t in f32:
        if t.device != dev or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError("block_step: float inputs must be contiguous "
                             "float32 tensors on the keys' device")
    for t, dt in ((rows_i, torch.int32), (acc["n_seconds"], torch.int32),
                  (k_scan, torch.int64), (k_meter, torch.int64)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError("block_step: integer inputs must be contiguous "
                             "int32 rows/counts and int64 keys")
    fn = build.entry("block_step.cu", "block_step",
                     [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_float, ctypes.c_float]
                     + [ctypes.c_void_p] * 20)
    p = build.ptr
    rc = fn(n, T, int(duration_s), meter_max_w, cos_tilt(surface_tilt),
            albedo, p(rows_i), p(rows_f),
            *(p(tables[k]) for k in ("cc", "cloudy", "clear_day", "ws", "ml",
                                     "mc")),
            p(k_scan), p(k_meter), *(p(carry[k]) for k in CARRY),
            *(p(acc[k]) for k in ACC_F), p(acc["n_seconds"]),
            build.stream_ptr(dev))
    build.check(rc, "block_step")
    K3.launches += 1
    return carry, acc


def block_step_acc(tables, rows_i, rows_f, k_scan, k_meter, carry, acc,
                   duration_s: int, meter_max_w: float, surface_tilt: float,
                   albedo: float):
    """Fold one block into the accumulator; returns ``(carry, acc)``.

    ``tables``: value-major K2 tables; ``rows_i``/``rows_f``: the block's
    shared rows (``block_rows``); ``carry``/``acc``: dicts of ``(n,)``
    tensors (``CARRY`` float32; ``ACC_F`` float32 and int32
    ``n_seconds``)."""
    if k_scan.device.type == "cuda":
        return _block_step_cuda(tables, rows_i, rows_f, k_scan, k_meter,
                                carry, acc, duration_s, meter_max_w,
                                surface_tilt, albedo)
    if k_scan.device.type != "cpu":
        raise ValueError(f"unsupported device {k_scan.device}")
    return block_step_plain(tables, rows_i, rows_f, k_scan, k_meter, carry,
                            acc, duration_s, meter_max_w, surface_tilt,
                            albedo)
