"""Fleet-risk analytics of a reduce run: the FleetAcc (own copy of the JAX
package's obs/analytics.py; the fold K9 runs on the card).

The accumulator answers the grid operator's question from inside the
block step, so a fleet-day leaves the card as a few KB:

* a residual-load sketch: an equi-width histogram of ``residual = meter -
  pv`` over ``[lo, hi)`` with under/overflow slots (``bins + 2`` int32)
  and exact running min / max; :func:`summarize` interpolates quantiles;
* an exceedance curve: seconds with exactly ``j`` thresholds below the
  residual (``searchsorted(thresholds, r, 'left')``), suffix-summed on the
  host;
* loss of load: seconds (and events) in which ``residual > capacity_w``
  has held for ``lolp_k`` consecutive seconds, by a per-chain run length;
* ramp extremes ``max |Δresidual|`` on the global-second grids
  ``(t + 1) % w == 0`` of ``w`` = 1, 60 and 3600 s, each one
  previous-sample slot per chain;
* with two or more cohorts, the per-cohort group-by: count, residual
  histogram, min / max and the sums of meter, pv and residual;
* at level ``full``: the cloud-covered / clear sums of meter, pv and
  residual.

The accumulator is zero-initialised for every block, so the LOLP run and
the ramp slots restart at block boundaries (the JAX package's documented
seam: a run spanning two blocks is split).  Integer leaves and extrema
merge exactly in any order.

Float sums over chains are taken in float64 and rounded once (the JAX
package sums in float32 in XLA's order).  ``cohort_sum_*`` is a running
float32 scatter over seconds in the JAX package, an order no parallel
fold reproduces; here each chain sums its own seconds in float32 (the
per-chain acc carries ``cohort_sum_*`` as ``(n,)`` leaves) and the
collapse adds the chains of each cohort in chain order in float64.

``csrc/block_step.cu``'s analytics epilogue is this fold in registers and
shared-memory histograms; ``fold_second`` / ``reduce_chainwise`` are its
plain versions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from tmhpvsim_torch.config import ANALYTICS_LEVELS  # noqa: F401

#: sample-grid windows [s] of the ramp-rate extrema
RAMP_WINDOWS = (1, 60, 3600)

_BIG = float(np.finfo(np.float32).max)
_SUMMED = ("meter", "pv", "residual")


@dataclasses.dataclass(frozen=True)
class FleetParams:
    """The sketch geometry of a run (fixed for every block and chain).

    ``lo``/``hi``: the residual histogram's support [W); ``bins``: its
    interior bins; ``thresholds``: the exceedance grid [W], strictly
    ascending; ``capacity_w``: loss-of-load capacity [W]; ``lolp_k``:
    consecutive loss seconds that make a loss run; ``ramp_windows``: the
    ramp sample grids [s]."""

    lo: float
    hi: float
    bins: int
    thresholds: tuple
    capacity_w: float
    lolp_k: int
    ramp_windows: tuple = RAMP_WINDOWS

    def __post_init__(self):
        if not self.hi > self.lo:
            raise ValueError(f"FleetParams: hi {self.hi} must be > lo {self.lo}")
        if self.bins < 1:
            raise ValueError(f"FleetParams: bins {self.bins} must be >= 1")
        if self.lolp_k < 1:
            raise ValueError(f"FleetParams: lolp_k {self.lolp_k} must be >= 1")
        th = tuple(float(t) for t in self.thresholds)
        if not th:
            raise ValueError("FleetParams: thresholds must be non-empty")
        if any(b <= a for a, b in zip(th, th[1:])):
            raise ValueError(
                f"FleetParams: thresholds {th} must be strictly ascending")
        object.__setattr__(self, "thresholds", th)
        rw = tuple(int(w) for w in self.ramp_windows)
        if any(w < 1 for w in rw) or any(
                b <= a for a, b in zip(rw, rw[1:])):
            raise ValueError(
                f"FleetParams: ramp_windows {rw} must be strictly "
                "ascending positive ints")
        object.__setattr__(self, "ramp_windows", rw)

    @property
    def inv_w(self) -> float:
        """Histogram bins per watt (python float; the fold rounds it to
        float32)."""
        return self.bins / (self.hi - self.lo)


def params_from_config(config) -> FleetParams:
    """The sketch geometry of a SimConfig: ``[-meter_max_w, meter_max_w)``
    in ``analytics_bins`` bins, thresholds at 1/8..7/8 of ``meter_max_w``
    unless given, capacity 0.8 * ``meter_max_w`` unless given."""
    mx = float(config.meter_max_w)
    th = config.analytics_thresholds
    cap = config.analytics_capacity_w
    return FleetParams(
        lo=-mx,
        hi=mx,
        bins=int(config.analytics_bins),
        thresholds=(tuple(th) if th
                    else tuple(mx * f / 8.0 for f in range(1, 8))),
        capacity_w=(float(cap) if cap is not None else 0.8 * mx),
        lolp_k=int(config.analytics_lolp_k),
    )


def init_acc(level: str, n_chains=None, *, params: FleetParams,
             cohorts: int = 0, device=None) -> dict:
    """A zeroed FleetAcc for one block.

    With ``n_chains`` the extremum, LOLP, ramp, regime and ``cohort_sum_*``
    leaves are per-chain ``(n,)`` vectors (plus the carry-only slots
    ``lol_run``, ``prev_ramp_*`` and ``seen_ramp_*``); the histograms,
    counts and per-cohort count / histogram / extrema are shared scatter
    targets.  Without it, the collapsed form.  ``cohorts`` >= 2 adds the
    per-cohort leaves."""
    if level not in ("risk", "full"):
        raise ValueError(f"init_acc: analytics level {level!r} must be "
                         f"'risk' or 'full'")
    per_chain = n_chains is not None
    shape = (int(n_chains),) if per_chain else ()

    def full(v, dtype=torch.float32, shp=shape):
        return torch.full(shp, v, dtype=dtype, device=device)

    acc = {
        "count": full(0, torch.int32, ()),
        "res_hist": full(0, torch.int32, (params.bins + 2,)),
        "exceed": full(0, torch.int32, (len(params.thresholds) + 1,)),
        "min_res": full(_BIG),
        "max_res": full(-_BIG),
        "lol_seconds": full(0, torch.int32),
        "lol_events": full(0, torch.int32),
    }
    for w in params.ramp_windows:
        acc[f"max_ramp_{w}s"] = full(-_BIG)
    if per_chain:
        acc["lol_run"] = full(0, torch.int32)
        for w in params.ramp_windows:
            acc[f"prev_ramp_{w}s"] = full(0.0)
            acc[f"seen_ramp_{w}s"] = full(0, torch.int32)
    if cohorts:
        c = int(cohorts)
        acc["cohort_count"] = full(0, torch.int32, (c,))
        acc["cohort_hist"] = full(0, torch.int32, (c, params.bins + 2))
        acc["min_cohort_res"] = full(_BIG, shp=(c,))
        acc["max_cohort_res"] = full(-_BIG, shp=(c,))
        for f in _SUMMED:
            acc[f"cohort_sum_{f}"] = full(0.0, shp=shape if per_chain
                                          else (c,))
    if level == "full":
        acc["regime_observed"] = full(0, torch.int32, ())
        acc["cov_count"] = full(0, torch.int32)
        for f in _SUMMED:
            acc[f"sum_{f}"] = full(0.0)
            acc[f"cov_sum_{f}"] = full(0.0)
    return acc


def leaf_kinds(acc: dict) -> dict:
    """Reduction kind per leaf: 'min' | 'max' | 'sum' (``regime_observed``
    is a seen-flag: max)."""
    return {
        k: ("min" if k.startswith("min_")
            else "max" if k.startswith("max_") or k == "regime_observed"
            else "sum")
        for k in acc
    }


def _f32(v, device):
    return torch.tensor(v, dtype=torch.float32, device=device)


def _row_bincount(idx, use, nbins: int, rows) -> torch.Tensor:
    """int32 counts of ``idx[use]`` in ``nbins`` bins, one histogram per
    leading row (``rows``: the shape before the chain axis)."""
    if not rows:
        return torch.bincount(idx[use], minlength=nbins).to(torch.int32)
    r = math.prod(rows)
    off = torch.arange(r, dtype=torch.int64, device=idx.device).reshape(
        *rows, 1) * nbins
    return torch.bincount((idx + off)[use], minlength=r * nbins).reshape(
        *rows, nbins).to(torch.int32)


def fold_second(acc: dict, level: str, params: FleetParams, *, meter, pv,
                residual, covered, t, valid, cohort=None) -> dict:
    """Fold one second of ``(n,)`` vectors into a per-chain acc (or of
    ``(B, n)`` rows into a stack of B accs, each row's counts and
    histograms its own; without cohort leaves).

    ``t`` is the second's global index (it drives the ramp grids),
    ``valid`` its duration mask; a non-finite residual drops the sample
    from every statistic.  ``cohort``: the chains' int cohort ids
    (required when the acc has cohort leaves).  Every float constant is
    rounded to float32 first, as the JAX fold's weakly typed python
    floats are."""
    dev = residual.device
    r = residual
    valid = torch.as_tensor(valid, device=dev)
    use = valid & torch.isfinite(r)
    uz = use.to(torch.int32)
    out = dict(acc)
    rows = r.shape[:-1]
    out["count"] = acc["count"] + uz.sum(-1, dtype=torch.int32)
    lo = _f32(params.lo, dev)
    b = torch.where(use, (r - lo) * _f32(params.inv_w, dev),
                    _f32(0.0, dev))
    b = torch.clamp(b, -1.0, float(params.bins))
    idx = torch.floor(b).to(torch.int64) + 1
    nb = params.bins + 2
    out["res_hist"] = acc["res_hist"] + _row_bincount(idx, use, nb, rows)
    th = torch.tensor(params.thresholds, dtype=torch.float32, device=dev)
    rg = torch.where(use, r, lo)
    slot = torch.searchsorted(th, rg.contiguous(), right=False)
    out["exceed"] = acc["exceed"] + _row_bincount(
        slot, use, len(params.thresholds) + 1, rows)
    out["min_res"] = torch.minimum(acc["min_res"], torch.where(use, r, _BIG))
    out["max_res"] = torch.maximum(acc["max_res"],
                                   torch.where(use, r, -_BIG))
    exc = (r > _f32(params.capacity_w, dev)) & use
    run = torch.where(exc, acc["lol_run"] + 1, 0).to(torch.int32)
    out["lol_events"] = acc["lol_events"] + (run == params.lolp_k).to(
        torch.int32)
    out["lol_seconds"] = acc["lol_seconds"] + (run >= params.lolp_k).to(
        torch.int32)
    out["lol_run"] = run
    t = int(t)
    for w in params.ramp_windows:
        at = (t + 1) % w == 0
        prev = acc[f"prev_ramp_{w}s"]
        seen = acc[f"seen_ramp_{w}s"]
        mr = acc[f"max_ramp_{w}s"]
        if at:
            ok = use & (seen > 0)
            out[f"max_ramp_{w}s"] = torch.where(
                ok, torch.maximum(mr, torch.abs(r - prev)), mr)
            out[f"prev_ramp_{w}s"] = torch.where(use, r, prev)
            out[f"seen_ramp_{w}s"] = uz
    if "cohort_count" in acc:
        if cohort is None:
            raise ValueError("fold_second: the acc has cohort leaves; pass "
                             "cohort=")
        cid = cohort.to(torch.int64)
        out["cohort_count"] = acc["cohort_count"].index_add(0, cid, uz)
        out["cohort_hist"] = acc["cohort_hist"].index_put(
            (cid, idx), uz, accumulate=True)
        out["min_cohort_res"] = acc["min_cohort_res"].scatter_reduce(
            0, cid, torch.where(use, r, _BIG), "amin")
        out["max_cohort_res"] = acc["max_cohort_res"].scatter_reduce(
            0, cid, torch.where(use, r, -_BIG), "amax")
        for name, v in (("meter", meter), ("pv", pv), ("residual", r)):
            out[f"cohort_sum_{name}"] = acc[f"cohort_sum_{name}"] + \
                torch.where(use, v, torch.zeros_like(v))
    if level == "full":
        cov = (covered != 0) & use
        out["regime_observed"] = torch.ones_like(acc["regime_observed"])
        out["cov_count"] = acc["cov_count"] + cov.to(torch.int32)
        for name, v in (("meter", meter), ("pv", pv), ("residual", r)):
            zero = torch.zeros_like(v)
            out[f"sum_{name}"] = acc[f"sum_{name}"] + torch.where(use, v,
                                                                  zero)
            out[f"cov_sum_{name}"] = acc[f"cov_sum_{name}"] + torch.where(
                cov, v, zero)
    return out


def fold_wide_chains(params: FleetParams, *, meter, pv, t, duration_s,
                     cohort=None, n_cohorts: int = 0) -> dict:
    """The per-chain acc of one block's wide fold: what ``fold_second``
    at level ``risk`` folds from a zero acc over the block's time-major
    ``(T, n)`` meter and pv, second by second (``t``: the ``(T,)`` global
    seconds), vectorised over the block where the order does not matter.
    Counts and histograms are exact in any order, extrema too; the loss
    run is ``fold_second``'s counter (a run length from the last
    non-loss second); the ramp slots pair consecutive seconds of each
    window's grid; ``cohort_sum_*`` adds each chain's seconds in order in
    float32.  The wide kernel's per-chain registers (kernels/wide.py)."""
    T, n = meter.shape
    dev = meter.device
    C = int(n_cohorts) if cohort is not None else 0
    acc = init_acc("risk", n, params=params, cohorts=C, device=dev)
    r = meter - pv
    use = (t < duration_s)[:, None] & torch.isfinite(r)
    uz = use.to(torch.int32)
    acc["count"] = uz.sum(dtype=torch.int32)
    lo = _f32(params.lo, dev)
    b = torch.where(use, (r - lo) * _f32(params.inv_w, dev), _f32(0.0, dev))
    idx = torch.floor(torch.clamp(b, -1.0, float(params.bins))).to(
        torch.int64) + 1
    acc["res_hist"] = torch.bincount(idx[use], minlength=params.bins + 2
                                     ).to(torch.int32)
    th = torch.tensor(params.thresholds, dtype=torch.float32, device=dev)
    slot = torch.searchsorted(th, torch.where(use, r, lo).contiguous())
    acc["exceed"] = torch.bincount(
        slot[use], minlength=len(params.thresholds) + 1).to(torch.int32)
    acc["min_res"] = torch.where(use, r, _BIG).min(0).values
    acc["max_res"] = torch.where(use, r, -_BIG).max(0).values
    # the loss run at each second: seconds since the last non-loss one
    exc = (r > _f32(params.capacity_w, dev)) & use
    tidx = torch.arange(T, device=dev)[:, None]
    run = torch.where(exc, tidx - torch.cummax(
        torch.where(exc, -1, tidx), dim=0).values, 0)
    acc["lol_events"] = (run == params.lolp_k).sum(0, dtype=torch.int32)
    acc["lol_seconds"] = (run >= params.lolp_k).sum(0, dtype=torch.int32)
    acc["lol_run"] = run[-1].to(torch.int32)
    for w in params.ramp_windows:
        at = torch.nonzero((t + 1) % w == 0).flatten()
        if not len(at):
            continue
        ra, ua = r[at], use[at]
        if len(at) > 1:
            d = torch.where(ua[1:] & ua[:-1], torch.abs(ra[1:] - ra[:-1]),
                            -_BIG)
            acc[f"max_ramp_{w}s"] = d.max(0).values
        # the slots after the grid's last second: its use flag and the
        # residual of its last used second
        acc[f"seen_ramp_{w}s"] = ua[-1].to(torch.int32)
        j = torch.arange(len(at), device=dev)[:, None]
        last = torch.where(ua, j, -1).max(0).values
        acc[f"prev_ramp_{w}s"] = torch.where(
            last >= 0, ra.gather(0, last.clamp_min(0)[None])[0],
            _f32(0.0, dev))
    if C:
        cid = cohort.to(torch.int64)
        acc["cohort_count"] = acc["cohort_count"].index_add(
            0, cid, uz.sum(0, dtype=torch.int32))
        acc["cohort_hist"] = acc["cohort_hist"].index_put(
            (cid.expand(T, n), idx), uz, accumulate=True)
        acc["min_cohort_res"] = acc["min_cohort_res"].scatter_reduce(
            0, cid, acc["min_res"], "amin")
        acc["max_cohort_res"] = acc["max_cohort_res"].scatter_reduce(
            0, cid, acc["max_res"], "amax")
        for name, v in (("meter", meter), ("pv", pv), ("residual", r)):
            v0 = torch.where(use, v, torch.zeros_like(v))
            total = acc[f"cohort_sum_{name}"]
            for s in range(T):
                total = total + v0[s]
            acc[f"cohort_sum_{name}"] = total
    return acc


def fold_wide(acc: dict, level: str, params: FleetParams, *, meter, pv,
              t, duration_s, cohort=None) -> dict:
    """Fold one block's materialised time-major ``(T, n)`` meter and pv
    into the collapsed ``acc`` (the JAX package's ``fold_wide``, its
    arrays transposed): the per-chain fold (``fold_wide_chains``), then
    ``reduce_chainwise``.  The wide formulation never materialises the
    cloud state, so the ``full`` level's regime leaves stay unfolded and
    ``regime_observed`` 0 (``summarize`` reports regimes as unobserved).
    Loss runs and ramp pairs restart at the block's start, as in the JAX
    fold.  ``cohort``: the chains' ids, for an acc with cohort leaves."""
    C = acc["cohort_count"].shape[0] if "cohort_count" in acc else 0
    if C and cohort is None:
        raise ValueError("fold_wide: the acc has cohort leaves; pass "
                         "cohort=")
    delta = reduce_chainwise(fold_wide_chains(
        params, meter=meter, pv=pv, t=t, duration_s=duration_s,
        cohort=cohort if C else None, n_cohorts=C),
        cohort=cohort if C else None)
    if level == "full":
        zero = init_acc("full", params=params, device=meter.device)
        for k in ("regime_observed", "cov_count", *(
                f"{p}sum_{f}" for p in ("", "cov_") for f in _SUMMED)):
            delta[k] = zero[k]
    kinds = leaf_kinds(acc)
    op = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}
    return {k: op[kinds[k]](acc[k], delta[k]) for k in acc}


def reduce_chainwise(acc: dict, cohort=None) -> dict:
    """Collapse a per-chain FleetAcc to the per-block form: the carry-only
    slots dropped, integer leaves summed exactly, extrema taken, float
    sums over chains in float64 rounded once; ``cohort_sum_*`` grouped by
    ``cohort`` (the chains' ids) in chain order.  Leaf names and shapes
    match the JAX package's."""
    out = {}
    for k, v in acc.items():
        if k == "lol_run" or k.startswith(("prev_ramp_", "seen_ramp_")):
            continue
        if k.startswith("cohort_sum_"):
            c = acc["cohort_count"].shape[0]
            out[k] = torch.zeros(c, dtype=torch.float64,
                                 device=v.device).index_add_(
                0, cohort.to(torch.int64), v.double()).float()
        elif "cohort" in k:
            out[k] = v
        elif k.startswith("min_"):
            out[k] = v.min()
        elif k.startswith("max_"):
            out[k] = v.max()
        elif k in ("count", "res_hist", "exceed", "regime_observed"):
            out[k] = v
        elif v.dtype == torch.int32:
            out[k] = v.sum(dtype=torch.int32)
        else:
            out[k] = v.double().sum().float()
    return out


def merge(total: Optional[dict], delta: dict) -> dict:
    """Run-total merge of scalar-form FleetAccs on the deltas' device.

    Widens int32 counts to int64 and float sums to float64 so run totals
    stay exact past the per-block int32 bound; extrema keep their
    compute dtype (selection is exact at any width).  ``total=None``
    starts a fresh total from ``delta``.
    """
    kinds = leaf_kinds(delta)

    def widen(k, v):
        if kinds[k] in ("min", "max"):
            return v.clone()
        return v.to(torch.float64 if v.is_floating_point() else torch.int64)

    if total is None:
        return {k: widen(k, v) for k, v in delta.items()}
    op = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}
    return {k: op[kinds[k]](total[k], widen(k, v))
            for k, v in delta.items()}


def merge_host(total: Optional[dict], delta: dict) -> dict:
    """``merge`` on the host: fetched deltas into a numpy int64 / float64
    run total (the JAX package's ``merge_host``)."""
    tot = None if total is None else {
        k: torch.from_numpy(np.array(v)) for k, v in total.items()}
    d = {k: torch.as_tensor(np.asarray(v.cpu() if isinstance(
        v, torch.Tensor) else v)) for k, v in delta.items()}
    return {k: v.numpy() for k, v in merge(tot, d).items()}


def _quantile(q: float, cum, edges_lo, edges_hi, counts, mn, mx,
              count: int) -> float:
    """Linear-interpolation quantile from cumulative histogram mass.

    Deterministic host float64 math on the (identical) integer counts,
    so equal sketches give bit-equal quantiles.
    """
    target = q * count
    i = int(np.searchsorted(cum, target, side="left"))
    i = min(i, len(counts) - 1)
    below = cum[i] - counts[i]
    frac = (target - below) / counts[i] if counts[i] else 0.0
    v = edges_lo[i] + frac * (edges_hi[i] - edges_lo[i])
    return float(min(max(v, mn), mx))


def summarize(acc: dict, params: FleetParams) -> dict:
    """Host-side reduction of a (fetched or host-merged) scalar-form
    FleetAcc into the plain-python ``fleet`` report section."""
    host = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in acc.items()}
    dt = host["min_res"].dtype
    big = float(np.finfo(dt).max)
    count = int(host["count"])
    mn = float(host["min_res"])
    mx = float(host["max_res"])
    observed = count > 0 and mn < 0.5 * big and mx > -0.5 * big
    level = "full" if "cov_count" in host else "risk"

    quantiles = None
    hist = host["res_hist"].astype(np.int64)
    if observed:
        width = (params.hi - params.lo) / params.bins
        interior_lo = params.lo + width * np.arange(params.bins)
        # under/overflow slots span [min, lo] and [hi, max] (clamped so
        # a degenerate all-interior run keeps monotone edges)
        edges_lo = np.concatenate(
            [[min(mn, params.lo)], interior_lo, [params.hi]])
        edges_hi = np.concatenate(
            [[params.lo], interior_lo + width, [max(mx, params.hi)]])
        cum = np.cumsum(hist)
        quantiles = {
            f"p{int(q * 100)}": _quantile(
                q, cum, edges_lo, edges_hi, hist, mn, mx, count)
            for q in (0.01, 0.05, 0.50, 0.95, 0.99)
        }

    exceed = host["exceed"].astype(np.int64)
    # slot i = seconds with exactly i thresholds below r, so seconds
    # with r > th_j = total mass in slots j+1..
    suffix = np.cumsum(exceed[::-1])[::-1]
    exceedance = [
        {"threshold_w": float(th),
         "seconds": int(suffix[j + 1]),
         "prob": float(suffix[j + 1] / count) if count else 0.0}
        for j, th in enumerate(params.thresholds)
    ]

    loss_s = int(host["lol_seconds"])
    events = int(host["lol_events"])
    ramp = {}
    for w in params.ramp_windows:
        v = float(host[f"max_ramp_{w}s"])
        ramp[f"{w}s"] = v if v > -0.5 * big else None

    out = {
        "level": level,
        "count": count,
        "residual": {
            "min": mn if observed else None,
            "max": mx if observed else None,
            "quantiles": quantiles,
        },
        "exceedance": exceedance,
        "lolp": {
            "capacity_w": float(params.capacity_w),
            "k_s": int(params.lolp_k),
            "loss_seconds": loss_s,
            "events": events,
            "prob": float(loss_s / count) if count else 0.0,
        },
        "ramp": ramp,
        "sketch": {
            "bins": int(params.bins),
            "lo_w": float(params.lo),
            "hi_w": float(params.hi),
            "width_w": float((params.hi - params.lo) / params.bins),
            "underflow": int(hist[0]),
            "overflow": int(hist[-1]),
        },
        "regimes": None,
        "cohorts": None,
    }
    if "cohort_count" in host:
        counts = host["cohort_count"].astype(np.int64)
        ghist = host["cohort_hist"].astype(np.int64)
        mins = host["min_cohort_res"].astype(np.float64)
        maxs = host["max_cohort_res"].astype(np.float64)
        width = (params.hi - params.lo) / params.bins
        interior_lo = params.lo + width * np.arange(params.bins)
        cohorts = []
        for c in range(len(counts)):
            n = int(counts[c])
            c_mn, c_mx = float(mins[c]), float(maxs[c])
            seen = n > 0 and c_mn < 0.5 * big and c_mx > -0.5 * big
            q = None
            if seen:
                e_lo = np.concatenate(
                    [[min(c_mn, params.lo)], interior_lo, [params.hi]])
                e_hi = np.concatenate(
                    [[params.lo], interior_lo + width,
                     [max(c_mx, params.hi)]])
                ccum = np.cumsum(ghist[c])
                q = {f"p{int(p * 100)}": _quantile(
                    p, ccum, e_lo, e_hi, ghist[c], c_mn, c_mx, n)
                    for p in (0.05, 0.50, 0.95)}
            means = {
                f"{f}_mean": (float(host[f"cohort_sum_{f}"][c]) / n
                              if n else None)
                for f in ("meter", "pv", "residual")
            }
            cohorts.append({
                "cohort": c,
                "count": n,
                "residual_min": c_mn if seen else None,
                "residual_max": c_mx if seen else None,
                "quantiles": q,
                **means,
            })
        out["cohorts"] = cohorts
    if level == "full" and int(host["regime_observed"]):
        cov_n = int(host["cov_count"])
        clr_n = count - cov_n
        regimes = {}
        for name, n in (("covered", cov_n), ("clear", clr_n)):
            means = {}
            for f in ("meter", "pv", "residual"):
                s = float(host[f"cov_sum_{f}"]) if name == "covered" else (
                    float(host[f"sum_{f}"]) - float(host[f"cov_sum_{f}"]))
                means[f"{f}_mean"] = s / n if n else None
            regimes[name] = {"seconds": n, **means}
        out["regimes"] = regimes
    return out
