"""K2: per-chain sampler windows of one block.

Replaces ``Simulation._windows_one_chain`` (tmhpvsim_tpu/engine/
simulation.py:785-828) vmapped over chains, with ``value_major_tables``
(models/clearsky_index.py:447): the hourly Markov cloud cover (a
sequential hour loop), the cloudy, clear-day and windspeed draws, the two
minute-noise streams, and the advanced Markov carry.  Tables come out
value-major ``(values, chains)`` so K3 reads them coalesced.

K7 (half of it): with a heterogeneous fleet's ``regime`` vector each chain
draws its Markov steps from its own weather-regime table
(``markov_hourly.select_regime``, tmhpvsim_tpu/models/markov_hourly.py:70,
gathered per chain as at engine/simulation.py:800-806); the kernel holds
the three stacked 6-bin tables in constant memory.

K13 (half of it): with ``(n, 4)`` rbg keys the kernel's rbg
instantiation draws from Philox (csrc/philox.cuh) as jax's batching rule
has it (each batched draw from the batch's first key, the gamma draws per
key; csrc/windows.cu); ``windows_plain`` is the same model functions on
rbg keys.

``sampler_windows`` runs ``windows_plain`` on CPU tensors and launches the
CUDA kernel (csrc/windows.cu) on CUDA tensors; ``K2.launches`` counts the
launches, ``K7_REGIME.launches`` those with a regime vector,
``K2_RBG.launches`` those with rbg keys.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from tmhpvsim_torch import rng
from tmhpvsim_torch.data import MARKOV_STEP_BINS, MARKOV_STEP_PARAMS_REGIMES
from tmhpvsim_torch.kernels import build
from tmhpvsim_torch.models import clearsky_index as ci
from tmhpvsim_torch.models import distributions as dist
from tmhpvsim_torch.models import markov_hourly

K2 = build.LaunchCounter("sampler_windows")
K7_REGIME = build.LaunchCounter("sampler_windows_regime")
K2_RBG = build.LaunchCounter("sampler_windows_rbg")

#: longest hour window one kernel thread holds (csrc/windows.cu MAX_HOURS)
MAX_HOURS = 64


@dataclasses.dataclass(frozen=True)
class Bounds:
    """Global index bounds of one block's sampler windows.

    The hour window [hour_lo, hour_lo + n_hours) feeds the cloud cover and
    the cloudy csi (``n_cloudy`` values from hour_lo); ``hour_next_lo`` is
    where the next block's hour window starts (the carry advances to just
    before it); clear-day [cd_lo, cd_lo + n_cd), windspeed
    [day_lo, day_lo + n_days), minute noise from ``min_lo`` (one value per
    entry of the minute features)."""

    hour_lo: int
    n_hours: int
    n_cloudy: int
    hour_next_lo: int
    cd_lo: int
    n_cd: int
    day_lo: int
    n_days: int
    min_lo: int = 0


def kernel_constants() -> dict:
    """The constants csrc/windows.cu reads, from the models.  The Markov
    step tables are every weather regime's, flattened regime-major
    (entry ``regime * 6 + bin``); regime 0 is the Munich fit."""
    p = np.asarray(MARKOV_STEP_PARAMS_REGIMES, dtype=np.float64)
    return {
        "MK_BINS": list(MARKOV_STEP_BINS),
        "MK_LOC": list(p[..., 0].ravel()),
        "MK_SCALE": list(p[..., 1].ravel()),
        "MK_KAPPA": list(p[..., 2].ravel()),
        "MK_DF": list(p[..., 3].ravel()),
        "MK_IS_T": list(p[..., 4].ravel()),
        "CD_LOC": ci.CSI_CLEAR_DAY_LOC, "CD_SCALE": ci.CSI_CLEAR_DAY_SCALE,
        "CL_LOC": ci.CSI_CLOUDY_NORM_LOC, "CL_SCALE": ci.CSI_CLOUDY_NORM_SCALE,
        "CL_MID_A": ci.CSI_CLOUDY_GAMMA_MID[0],
        "CL_MID_SCALE": ci.CSI_CLOUDY_GAMMA_MID[1],
        "CL_HIGH_A": ci.CSI_CLOUDY_GAMMA_HIGH[0],
        "CL_HIGH_SCALE": ci.CSI_CLOUDY_GAMMA_HIGH[1],
        "WS_SHAPE": dist.WINDSPEED_SHAPE, "WS_SCALE": dist.WINDSPEED_SCALE,
        "SIGMA_MIN": ci.SIGMA_MIN_FACTOR,
        "MN_CLOUDY_S0": ci.NOISE_CLOUDY[0],
        "MN_CLOUDY_S1X8": ci.NOISE_CLOUDY[1] * 8.0,
        "MN_CLEAR_S0": ci.NOISE_CLEAR[0],
        "MN_CLEAR_S1X8": ci.NOISE_CLEAR[1] * 8.0,
    }


def windows_plain(k_arr, k_min, cc_carry, cc0, b: Bounds, mh_idx, mh_frac,
                  regime=None):
    """Plain torch K2 (the models' window functions, batched over chains).

    Returns ``(tables, new_cc_carry)`` with value-major tables ``cc``,
    ``cloudy``, ``clear_day``, ``ws``, ``ml`` (clear minute noise) and
    ``mc`` (cloudy minute noise).  ``regime`` (an ``(n,)`` integer tensor)
    gives each chain its weather-regime step table."""
    ks = rng.split(k_arr, 4)
    k_cc, k_cloudy, k_day, k_ws = (ks[:, i, :] for i in range(4))
    params = None if regime is None else markov_hourly.select_regime(
        markov_hourly.regime_step_params(k_arr.device), regime)
    cc_w, _ = markov_hourly.chain_window(k_cc, b.hour_lo, b.n_hours,
                                         cc_carry, params)
    if b.n_hours:
        adv = min(max(b.hour_next_lo - b.hour_lo - 1, 0), b.n_hours - 1)
        carry = (cc_carry if b.hour_next_lo == b.hour_lo
                 else cc_w[:, adv].contiguous())
    else:
        carry = cc_carry
    arrays = {
        "cc": cc_w,
        "cloudy": ci.cloudy_window(k_cloudy, b.hour_lo, b.n_cloudy, cc_w,
                                   b.hour_lo, cc0),
        "clear_day": ci.clear_day_window(k_day, b.cd_lo, b.n_cd),
        "ws": ci.ws_window(k_ws, b.day_lo, b.n_days),
    }
    if mh_idx.shape[0]:
        mvals = ci.minute_noise_values(k_min, cc_w, b.min_lo,
                                       (mh_idx.long(), mh_frac))
    else:
        empty = cc_carry.new_empty((cc_carry.shape[0], 0))
        mvals = {"noise_min_cloudy": empty, "noise_min_clear": empty}
    return ci.value_major_tables(arrays, mvals), carry


def _windows_cuda(k_arr, k_min, cc_carry, cc0, b: Bounds, mh_idx, mh_frac,
                  regime):
    if b.n_hours > MAX_HOURS or b.n_cloudy > MAX_HOURS:
        raise ValueError(f"hour window longer than {MAX_HOURS}")
    n = k_arr.shape[0]
    dev = k_arr.device
    n_min = int(mh_idx.shape[0])
    width = k_arr.shape[-1]
    if k_arr.shape != (n, width) or width not in (2, 4) or \
            k_min.shape != (n, width):
        raise ValueError("sampler_windows: k_arr and k_min must be (n, 2) "
                         "threefry or (n, 4) rbg keys")
    args = [k_arr, k_min, cc_carry, cc0]
    dts = [torch.int64, torch.int64, torch.float32, torch.float32]
    if regime is not None:
        args.append(regime)
        dts.append(torch.int32)
        if regime.shape != (n,):
            raise ValueError(f"sampler_windows: regime must be ({n},)")
    for t, dt in zip(args, dts):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError("sampler_windows: inputs must be contiguous "
                             "tensors on one device (int64 keys, float32, "
                             "int32 regime)")
    mh_idx = mh_idx.to(device=dev, dtype=torch.int32).contiguous()
    mh_frac = mh_frac.to(device=dev, dtype=torch.float32).contiguous()

    def out(rows):
        return torch.empty((rows, n), dtype=torch.float32, device=dev)

    tables = {"cc": out(b.n_hours), "cloudy": out(b.n_cloudy),
              "clear_day": out(b.n_cd), "ws": out(b.n_days),
              "ml": out(n_min), "mc": out(n_min)}
    carry = torch.empty_like(cc_carry)
    fn = build.entry("windows.cu", "sampler_windows",
                     [ctypes.c_int64] + [ctypes.c_void_p] * 5
                     + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 9
                     + [ctypes.c_int])
    p = build.ptr
    rc = fn(n, p(k_arr), p(k_min), p(cc_carry), p(cc0),
            None if regime is None else p(regime),
            b.hour_lo, b.n_hours, b.n_cloudy, b.hour_next_lo, b.cd_lo,
            b.n_cd, b.day_lo, b.n_days, b.min_lo, n_min,
            p(mh_idx), p(mh_frac),
            p(tables["cc"]), p(tables["cloudy"]), p(tables["clear_day"]),
            p(tables["ws"]), p(tables["ml"]), p(tables["mc"]), p(carry),
            int(width == 4), build.stream_ptr(dev))
    build.check(rc, "sampler_windows")
    K2.launches += 1
    if width == 4:
        K2_RBG.launches += 1
    if regime is not None:
        K7_REGIME.launches += 1
    return tables, carry


def sampler_windows(k_arr, k_min, cc_carry, cc0, bounds: Bounds,
                    mh_idx, mh_frac, regime=None):
    """One block's value-major sampler tables and the advanced Markov carry.

    ``k_arr``/``k_min`` are the chains' ``(n, 2)`` keys, ``cc_carry`` the
    Markov state before ``bounds.hour_lo``, ``cc0`` the construction-time
    cloud cover the primer cloudy draws see; ``mh_idx``/``mh_frac`` give
    each minute-noise value's hour index (into the hour window) and hour
    fraction at its draw instant; ``regime`` (``(n,)`` int32, or None for
    the Munich table) each chain's weather regime."""
    if k_arr.device.type == "cuda":
        return _windows_cuda(k_arr, k_min, cc_carry, cc0, bounds, mh_idx,
                             mh_frac, regime)
    if k_arr.device.type != "cpu":
        raise ValueError(f"unsupported device {k_arr.device}")
    return windows_plain(k_arr, k_min, cc_carry, cc0, bounds, mh_idx,
                         mh_frac, regime)
