"""K4 merges: the wide formulation's statistics, over a block's
materialised time-major ``(T, n)`` meter and pv (the K4 trace launch's
output, kernels/block_step.py).

Replaces, in tmhpvsim_tpu/engine/simulation.py:

* ``_block_stats`` (:958) with ``_merge_acc`` (:1070) /
  ``_block_stats_acc`` (:1078): the seven ``REDUCE_STATS`` per chain,
  masked by ``t < duration_s`` and merged into the accumulator — with the
  wide observer folds in the same launch: ``_wide_telemetry`` (:1377,
  obs/telemetry.py ``fold_wide``) and ``_wide_fleet`` (:1565,
  obs/analytics.py ``fold_wide``) (``wide_fold``);
* ``_ensemble_series`` (:983): the per-second sums over chains
  (``wide_series``).

Both kernels are in csrc/wide_fold.cu.  ``wide_fold`` folds in the block
step's acc epilogue's order (each chain's seconds in order, with its
expressions), so on the same meter and pv its statistics equal K3's bit
for bit (without observers a thread keeps 16 seconds of loads in flight,
for the card's memory rate); ``wide_series`` sums in the series
epilogue's order (per CTA of 128 chains, then ``series_sum`` over CTAs in
index order), so on the same values it equals the scan ensemble's sums
bit for bit.

Each wrapper runs its plain version on CPU tensors and launches its
kernel on CUDA tensors, and counts its launches.  ``wide_fold`` merges
into ``acc`` in place on the card; the plain version returns new
tensors.
"""

from __future__ import annotations

import ctypes

import torch

from tmhpvsim_torch.kernels import block_step as k3
from tmhpvsim_torch.kernels import build
from tmhpvsim_torch.obs import analytics as flt
from tmhpvsim_torch.obs import telemetry as tel

#: every launch of the fold, and those with each observer on
WIDE_FOLD = build.LaunchCounter("wide_fold")
WIDE_FOLD_TEL = build.LaunchCounter("wide_fold_tel")
WIDE_FOLD_FLT = build.LaunchCounter("wide_fold_analytics")
WIDE_SERIES = build.LaunchCounter("wide_series")
COUNTERS = (WIDE_FOLD, WIDE_FOLD_TEL, WIDE_FOLD_FLT, WIDE_SERIES)

_P = ctypes.c_void_p
_SOURCE = "wide_fold.cu"


def wide_fold_plain(meter, pv, t, duration_s: int, acc,
                    obs: k3.Observers | None = None):
    """Plain K4 merges: the statistics fold second by second into ``acc``
    (``block_step.stats_fold_plain``, the acc epilogue's order), and the
    observers' wide folds, zero-initialised for the block.  Returns
    ``(acc, out)``: ``out`` holds the block's collapsed ``telemetry`` and
    ``fleet`` deltas (None when off) and, with ``obs.per_chain``, the
    per-chain accs under ``telemetry_chain`` / ``fleet_chain``."""
    acc = k3.stats_fold_plain(acc, t, duration_s, meter, pv)
    out = {"telemetry": None, "fleet": None}
    if obs is None:
        return acc, out
    dev = meter.device
    wide = dict(meter=meter, pv=pv, t=t, duration_s=duration_s)
    if obs.telemetry != "off":
        out["telemetry"] = tel.fold_wide(
            tel.init_acc(obs.telemetry, device=dev), obs.telemetry, **wide)
        if obs.per_chain:
            out["telemetry_chain"] = tel.fold_wide_chains(**wide)
    if obs.analytics != "off":
        C = obs.n_cohorts if obs.cohort is not None else 0
        out["fleet"] = flt.fold_wide(
            flt.init_acc(obs.analytics, params=obs.params, cohorts=C,
                         device=dev),
            obs.analytics, obs.params, cohort=obs.cohort, **wide)
        if obs.per_chain:
            out["fleet_chain"] = flt.fold_wide_chains(
                obs.params, cohort=obs.cohort, n_cohorts=C, **wide)
    return acc, out


def wide_series_plain(meter, pv):
    """Plain K4m series: per second the sums over chains of ``(T, n)``
    meter and pv (accumulated in float64, rounded once).  Returns
    ``(meter_sum, pv_sum)``, each ``(T,)``."""
    return meter.double().sum(1).float(), pv.double().sum(1).float()


def _check_block(meter, pv, what):
    dev = meter.device
    if meter.dim() != 2 or pv.shape != meter.shape:
        raise ValueError(f"{what}: meter and pv must be (T, n) alike")
    for name, v in (("meter", meter), ("pv", pv)):
        k3._check(v, torch.float32, dev, name)
    return meter.shape[0], meter.shape[1], dev


_obs_size_checked = False


def _wide_fold_cuda(meter, pv, t, duration_s, acc, obs):
    global _obs_size_checked
    T, n, dev = _check_block(meter, pv, "wide_fold")
    k3._check(t, torch.int32, dev, "t")
    if t.shape != (T,):
        raise ValueError(f"wide_fold: t must be ({T},)")
    for k in k3.ACC_F:
        k3._check(acc[k], torch.float32, dev, f"acc {k}")
    k3._check(acc["n_seconds"], torch.int32, dev, "acc n_seconds")
    for k, v in acc.items():
        if v.shape != (n,):
            raise ValueError(f"wide_fold: acc {k} must be ({n},)")
    tel_on = obs is not None and obs.telemetry != "off"
    flt_on = obs is not None and obs.analytics != "off"
    o, buf, smem = None, {}, 0
    if tel_on or flt_on:
        if not _obs_size_checked:
            size = build.entry(_SOURCE, "wide_obs_struct_size", [])
            if size(None) != ctypes.sizeof(k3._Obs):
                raise RuntimeError("wide_fold: the Obs layout differs "
                                   "between the kernel and its wrapper")
            _obs_size_checked = True
        o, buf, smem = k3._obs_buffers(obs, n, T, dev)
    fn = build.entry(_SOURCE, "wide_fold",
                     [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
                     + [_P] * 11 + [ctypes.c_int] * 3)
    p = build.ptr
    rc = fn(n, T, int(duration_s), p(meter), p(pv), p(t),
            *(p(acc[k]) for k in k3.ACC_F), p(acc["n_seconds"]),
            None if o is None else ctypes.byref(o), int(tel_on),
            int(flt_on), smem, build.stream_ptr(dev))
    build.check(rc, "wide_fold")
    WIDE_FOLD.launches += 1
    WIDE_FOLD_TEL.launches += int(tel_on)
    WIDE_FOLD_FLT.launches += int(flt_on)
    if o is None:
        return acc, {"telemetry": None, "fleet": None}
    out = k3._obs_outputs(obs, buf, T)
    # the wide fold observes neither csi nor the cloud state: the
    # occupancy and the regime flag stay at their zeros
    if obs.telemetry == "full":
        out["telemetry"]["occupancy"] = torch.zeros(2, dtype=torch.float32,
                                                    device=dev)
    if obs.analytics == "full":
        out["fleet"]["regime_observed"] = torch.zeros(
            (), dtype=torch.int32, device=dev)
    return acc, out


def wide_fold(meter, pv, t, duration_s: int, acc,
              obs: k3.Observers | None = None):
    """Fold one block's time-major ``(T, n)`` meter and pv (``t``: the
    ``(T,)`` int32 global seconds) into the accumulator, with the wide
    observer folds when ``obs`` turns them on.  Returns ``(acc, out)`` as
    ``wide_fold_plain`` does (on the card ``acc`` is updated in place and
    the per-block deltas come zero-initialised out of the kernel and its
    collapse)."""
    if meter.device.type == "cuda":
        return _wide_fold_cuda(meter, pv, t, duration_s, acc, obs)
    if meter.device.type != "cpu":
        raise ValueError(f"unsupported device {meter.device}")
    return wide_fold_plain(meter, pv, t, duration_s, acc, obs)


def wide_fold_attrs() -> dict:
    """The acc fold's launch shape on the card (no observer): registers,
    CTAs per SM at 128 threads, local (spill) bytes."""
    fn = build.entry(_SOURCE, "wide_fold_attrs", [_P])
    out = (ctypes.c_int * 3)()
    build.check(fn(out, None), "wide_fold_attrs")
    return {"regs": out[0], "ctas_per_sm": out[1], "local_bytes": out[2]}


def wide_series_partials_cuda(meter, pv):
    """The series kernel's first pass on the card: ``(2, n_ctas, T)``
    per-CTA sums of meter | pv (``series_sum``'s input)."""
    T, n, dev = _check_block(meter, pv, "wide_series")
    if T % 60:
        raise ValueError("wide_series: T must be a multiple of 60 seconds")
    n_ctas = (n + k3.THREADS - 1) // k3.THREADS
    part = torch.empty((2, n_ctas, T), dtype=torch.float32, device=dev)
    fn = build.entry(_SOURCE, "wide_series",
                     [ctypes.c_int64, ctypes.c_int] + [_P] * 4)
    p = build.ptr
    rc = fn(n, T, p(meter), p(pv), p(part[0]), p(part[1]),
            build.stream_ptr(dev))
    build.check(rc, "wide_series")
    WIDE_SERIES.launches += 1
    return part


def wide_series(meter, pv):
    """Per second the sums over chains of one block's ``(T, n)`` meter
    and pv: ``(meter_sum, pv_sum)``, each ``(T,)``.  On the card a
    fixed-order reduction (per CTA, then ``series_sum`` over CTAs in
    index order): a repeated run gives the same bits."""
    if meter.device.type == "cuda":
        out = k3.series_sum(wide_series_partials_cuda(meter, pv))
        return out[0], out[1]
    if meter.device.type != "cpu":
        raise ValueError(f"unsupported device {meter.device}")
    return wide_series_plain(meter, pv)
