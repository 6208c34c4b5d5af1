"""Numerics telemetry of a reduce run: the TelemetryAcc (own copy of the JAX
package's obs/telemetry.py; the fold K8 runs on the card).

Per field (``meter``, ``csi``, ``pv``, ``residual``) the accumulator keeps
NaN and non-finite counts (int32) and min / max / sum / sum of squares of
the finite valid samples; level ``full`` adds an 8-bin csi histogram
(width 0.25, last bin open) and the cloud-covered occupancy.  The fold is
per chain (``fold_second``), zero-initialised for every block, and
collapsed once per block (``reduce_chainwise``), so each block's
telemetry is a pure delta; ``summarize`` turns a delta into plain floats
on the host.

Two differences from the JAX package, both in the collapse: float sums
over chains are taken in float64 and rounded once (the JAX package sums
in float32, in XLA's order), and the histogram counts in integers and
converts to float32 once.  The JAX leaf is a float32 scatter-add, which
stops counting above 2**24 per bin, a count a 65536-chain block of
1080 s reaches.  At the sizes where the JAX leaf is exact the two agree.

``csrc/block_step.cu``'s telemetry epilogue is this fold in registers;
``fold_second`` / ``reduce_chainwise`` are its plain versions.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tmhpvsim_torch import rng
from tmhpvsim_torch.config import TELEMETRY_LEVELS  # noqa: F401

#: fields with NaN / non-finite counters and moment accumulators
TELEMETRY_FIELDS = ("meter", "csi", "pv", "residual")

#: csi histogram: CSI_HIST_BINS bins of width CSI_HIST_WIDTH from 0; the
#: last bin is open
CSI_HIST_BINS = 8
CSI_HIST_WIDTH = 0.25

_BIG = float(np.finfo(np.float32).max)


def init_acc(level: str, n_chains=None, device=None) -> dict:
    """A zeroed TelemetryAcc for one block.

    With ``n_chains`` the per-field leaves are per-chain ``(n,)`` vectors
    folded elementwise by :func:`fold_second`, with a non-finite counter
    ``nf_{field}`` in place of ``inf_{field}``, the per-chain covered count
    ``occ_cov`` and the csi histogram as int32 counts; without it, the
    collapsed form :func:`reduce_chainwise` returns.  min / max start at
    -/+ float32 max."""
    if level not in ("light", "full"):
        raise ValueError(f"init_acc: telemetry level {level!r} must be "
                         f"'light' or 'full'")
    per_chain = n_chains is not None
    shape = (int(n_chains),) if per_chain else ()

    def full(v, dtype=torch.float32):
        return torch.full(shape, v, dtype=dtype, device=device)

    acc = {"count": torch.zeros((), dtype=torch.float32, device=device)}
    for f in TELEMETRY_FIELDS:
        acc[f"nan_{f}"] = full(0, torch.int32)
        acc[f"nf_{f}" if per_chain else f"inf_{f}"] = full(0, torch.int32)
        acc[f"min_{f}"] = full(_BIG)
        acc[f"max_{f}"] = full(-_BIG)
        acc[f"sum_{f}"] = full(0.0)
        acc[f"sumsq_{f}"] = full(0.0)
    if level == "full":
        if per_chain:
            acc["csi_hist"] = torch.zeros(CSI_HIST_BINS, dtype=torch.int32,
                                          device=device)
            acc["occ_cov"] = full(0, torch.int32)
        else:
            acc["csi_hist"] = torch.zeros(CSI_HIST_BINS, dtype=torch.float32,
                                          device=device)
            acc["occupancy"] = torch.zeros(2, dtype=torch.float32,
                                           device=device)
    return acc


def leaf_kinds(acc: dict) -> dict:
    """Reduction kind per leaf: 'min' | 'max' | 'sum'."""
    return {k: ("min" if k.startswith("min_")
                else "max" if k.startswith("max_") else "sum")
            for k in acc}


def _fold_field(out: dict, acc: dict, name: str, v, valid) -> None:
    """One field's per-chain leaves of one second: the NaN and
    non-finite counts, extrema and sums of the finite valid samples (the
    sum of squares as one multiply-add)."""
    isn = v != v
    use = torch.isfinite(v) & valid
    out[f"nan_{name}"] = acc[f"nan_{name}"] + (isn & valid).to(torch.int32)
    out[f"nf_{name}"] = acc[f"nf_{name}"] + (valid ^ use).to(torch.int32)
    v0 = torch.where(use, v, torch.zeros_like(v))
    out[f"min_{name}"] = torch.minimum(acc[f"min_{name}"],
                                       torch.where(use, v, _BIG))
    out[f"max_{name}"] = torch.maximum(acc[f"max_{name}"],
                                       torch.where(use, v, -_BIG))
    out[f"sum_{name}"] = acc[f"sum_{name}"] + v0
    out[f"sumsq_{name}"] = rng.fma(v0, v0, acc[f"sumsq_{name}"])


def fold_second(acc: dict, level: str, *, meter, pv, csi, residual,
                covered, valid) -> dict:
    """Fold one second of ``(n,)`` vectors into a per-chain acc.

    ``valid`` is the second's duration mask (a bool or 0-dim tensor).
    Non-finite samples are counted, not folded into the moments.  The
    sum of squares adds ``v0 * v0`` with one rounding, as the JAX scan
    contracts it into a multiply-add (``rng.fma``; settled against the
    JAX engine in tests/test_torch_obs.py)."""
    valid = torch.as_tensor(valid, device=meter.device)
    vz = valid.to(torch.float32)
    n = meter.shape[0]
    out = dict(acc)
    out["count"] = acc["count"] + vz * n
    for name, v in (("meter", meter), ("csi", csi), ("pv", pv),
                    ("residual", residual)):
        _fold_field(out, acc, name, v, valid)
    if level == "full":
        fin_c = torch.isfinite(csi)
        bins = torch.clamp(csi / CSI_HIST_WIDTH, 0, CSI_HIST_BINS - 1)
        idx = torch.where(fin_c, bins, 0).to(torch.int64)
        hit = fin_c & valid
        out["csi_hist"] = acc["csi_hist"] + torch.bincount(
            idx[hit], minlength=CSI_HIST_BINS).to(torch.int32)
        out["occ_cov"] = acc["occ_cov"] + ((covered != 0) & valid).to(
            torch.int32)
    return out


def fold_wide_chains(meter, pv, t, duration_s) -> dict:
    """The per-chain leaves of the wide fold: each chain folds meter, pv
    and residual of its ``(T, n)`` time-major block second by second, as
    ``fold_second`` does (csi stays at its identities), zero-initialised.
    The wide kernel's per-chain registers (kernels/wide.py)."""
    T, n = meter.shape
    acc = init_acc("light", n, device=meter.device)
    out = dict(acc)
    valid = t < duration_s
    residual = meter - pv
    for s in range(T):
        for name, v in (("meter", meter), ("pv", pv),
                        ("residual", residual)):
            _fold_field(out, out, name, v[s], valid[s])
    return out


def fold_wide(acc: dict, level: str, *, meter, pv, t, duration_s) -> dict:
    """Fold one block's materialised time-major ``(T, n)`` meter and pv
    into the collapsed ``acc`` (the JAX package's ``fold_wide``, its
    arrays transposed).

    The wide formulation never materialises csi, so only meter, pv and
    residual are folded and csi stays unobserved; the ``full`` level's
    histogram and occupancy stay zero too.  ``count`` adds the valid
    seconds times the chains, in float32 as the JAX fold takes it.  The
    per-chain folds (``fold_wide_chains``) are summed over chains in
    float64 and rounded once, as ``reduce_chainwise`` does."""
    valid = t < duration_s
    n = meter.shape[1]
    delta = reduce_chainwise(fold_wide_chains(meter, pv, t, duration_s))
    delta["count"] = valid.to(torch.float32).sum() * n
    if level == "full":
        delta["csi_hist"] = torch.zeros(CSI_HIST_BINS, dtype=torch.float32,
                                        device=meter.device)
        delta["occupancy"] = torch.zeros(2, dtype=torch.float32,
                                         device=meter.device)
    return merge(acc, delta)


def merge(acc: dict, delta: dict) -> dict:
    """Two collapsed TelemetryAccs combined leaf by leaf (counts and sums
    added, extrema taken)."""
    op = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}
    kinds = leaf_kinds(acc)
    return {k: op[kinds[k]](acc[k], delta[k]) for k in acc}


def _sum_f64(v):
    """A float32 leaf summed over chains in float64, rounded once."""
    return v.double().sum().float()


def reduce_chainwise(acc: dict) -> dict:
    """Collapse a per-chain TelemetryAcc to the per-block form: integer
    counts summed exactly (``inf = nf - nan``), extrema taken, float sums
    over chains in float64 rounded once, the histogram converted to
    float32 once.  Leaf names and shapes match the JAX package's."""
    out = {}
    for k, v in acc.items():
        if k.startswith("nan_"):
            out[k] = v.sum(dtype=torch.int32)
        elif k.startswith("nf_"):
            f = k[3:]
            out[f"inf_{f}"] = (v.sum(dtype=torch.int32)
                               - acc[f"nan_{f}"].sum(dtype=torch.int32))
        elif k.startswith("min_"):
            out[k] = v.min()
        elif k.startswith("max_"):
            out[k] = v.max()
        elif k.startswith(("sum_", "sumsq_")):
            out[k] = _sum_f64(v)
        elif k == "occ_cov":
            cov = v.sum(dtype=torch.int64).to(torch.float32)
            out["occupancy"] = torch.stack([acc["count"] - cov, cov])
        elif k == "csi_hist":
            out[k] = v.to(torch.float32)
        else:  # count
            out[k] = v
    return out


def summarize(acc: dict) -> dict:
    """A collapsed TelemetryAcc (tensors or numpy) as plain floats: per
    field its NaN / Inf counts, min, max, mean and std over the folded
    samples; a field never folded reports ``observed: False``."""
    host = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in acc.items()}
    big = float(np.finfo(host["count"].dtype).max)
    count = float(host["count"])
    fields = {}
    for f in TELEMETRY_FIELDS:
        mn = float(host[f"min_{f}"])
        mx = float(host[f"max_{f}"])
        s = float(host[f"sum_{f}"])
        ss = float(host[f"sumsq_{f}"])
        nan = int(host[f"nan_{f}"])
        inf = int(host[f"inf_{f}"])
        observed = not (mn > 0.5 * big and mx < -0.5 * big
                        and s == 0.0 and nan == 0 and inf == 0)
        mean = s / count if count else 0.0
        var = max(ss / count - mean * mean, 0.0) if count else 0.0
        fields[f] = {
            "nan": nan,
            "inf": inf,
            "observed": observed,
            "min": mn if mn < 0.5 * big else None,
            "max": mx if mx > -0.5 * big else None,
            "mean": mean,
            "std": math.sqrt(var),
        }
    out = {"count": count, "fields": fields}
    if "csi_hist" in host:
        out["csi_hist"] = [float(x) for x in host["csi_hist"]]
    if "occupancy" in host:
        out["cloud_occupancy"] = {
            "clear": float(host["occupancy"][0]),
            "covered": float(host["occupancy"][1]),
        }
    return out


def publish(registry, summary: dict) -> None:
    """Flush one block summary into the metrics registry (``device.*``):
    counters accumulate across blocks (NaN / Inf totals, histogram mass,
    occupancy seconds), gauges hold the latest block's moments."""
    registry.counter("device.telemetry.blocks_total").inc()
    for f, s in summary["fields"].items():
        registry.counter(f"device.nan_total.{f}").inc(s["nan"])
        registry.counter(f"device.inf_total.{f}").inc(s["inf"])
        if not s["observed"]:
            continue
        registry.gauge(f"device.{f}.mean").set(s["mean"])
        registry.gauge(f"device.{f}.std").set(s["std"])
        if s["min"] is not None:
            registry.gauge(f"device.{f}.min").set(s["min"])
        if s["max"] is not None:
            registry.gauge(f"device.{f}.max").set(s["max"])
    for i, v in enumerate(summary.get("csi_hist") or ()):
        if v:
            registry.counter(f"device.csi_hist.bin{i}").inc(v)
    for k, v in (summary.get("cloud_occupancy") or {}).items():
        if v:
            registry.counter(f"device.cloud_occupancy.{k}").inc(v)
