"""Composed clear-sky-index model, batched over chains (own copy of
tmhpvsim_tpu/models/clearsky_index.py in torch).

Per second, ``csi = base * (minute_noise + second_noise)``, with the base
and minute samplers chosen by whether the renewal process says the sky is
covered.  Every sampler value carries a global interval index and is drawn
from ``fold_in(key, index)``, so any block regenerates exactly the values
it touches: hourly cloud cover (a Markov chain, the only sequential
dependency above 1 s), hourly cloudy csi, clear-day csi (advancing on hour
and day rollovers), daily windspeed, and the two minute-noise streams.

Window functions take ``(chains, 2)`` keys and return ``(chains, n)``
values; ``value_major_tables`` turns them into the ``(n, chains)`` tables
the per-second step reads row by row.  The hourly cloud cover is
``markov_hourly.chain_window`` (the persistent chain; the JAX package's
``cc_window`` also offers the reference's i.i.d. compat mode, which the
port's ModelOptions refuse).
"""

from __future__ import annotations

import numpy as np
import torch

from tmhpvsim_torch import rng
from tmhpvsim_torch.models import distributions as dist
from tmhpvsim_torch.models import renewal
from tmhpvsim_torch.models.timegrid import TimeGridSpec

# Bright et al. 2015 parameters as used by the reference
CSI_CLEAR_DAY_LOC = 0.99
CSI_CLEAR_DAY_SCALE = 0.08
CSI_CLOUDY_NORM_LOC = 0.6784
CSI_CLOUDY_NORM_SCALE = 0.2046
CSI_CLOUDY_GAMMA_MID = (5.0, 0.1)      # 6/8 <= cc < 7/8
CSI_CLOUDY_GAMMA_HIGH = (3.5624, 0.0867)  # cc >= 7/8
#: the JAX package's numpy-float64 factors, as float32 (what x32 jax uses)
SIGMA_MIN_FACTOR = float(np.float32(np.sqrt(0.9)))
SIGMA_SEC_FACTOR = float(np.float32(np.sqrt(0.1 * 60)))
NOISE_CLOUDY = (0.01, 0.003)           # (sigma0, sigma1) minute, cloudy
NOISE_CLEAR = (0.001, 0.0015)          # minute, clear; per second both


def start_hour_fraction(spec: TimeGridSpec) -> float:
    """Hour fraction at the grid start: the primer cloud cover cc0 is the
    lerp of the first two hourly values at it."""
    return float(spec.block(0, 1).hour_fraction[0])


def _f32(v, device):
    return torch.tensor(v, dtype=torch.float32, device=device)


def cloudy_csi_draw(keys, cc):
    """One cloudy-csi sample per key given the cloud cover at the draw."""
    ks = rng.split(keys, 2)
    z = dist.normal(ks[..., 0, :], CSI_CLOUDY_NORM_LOC, CSI_CLOUDY_NORM_SCALE)
    mid = cc < 7 / 8
    a = torch.where(mid, _f32(CSI_CLOUDY_GAMMA_MID[0], cc.device),
                    _f32(CSI_CLOUDY_GAMMA_HIGH[0], cc.device))
    scale = torch.where(mid, _f32(CSI_CLOUDY_GAMMA_MID[1], cc.device),
                        _f32(CSI_CLOUDY_GAMMA_HIGH[1], cc.device))
    g = scale * rng.gamma(ks[..., 1, :], a)
    return torch.where(cc < 6 / 8, z, g)


def _idx(lo: int, n: int, device):
    return lo + torch.arange(n, dtype=torch.int64, device=device)


def cloudy_window(k_cloudy, lo: int, n: int, cc_vals, cc_lo: int, cc0):
    """Cloudy csi for global indices [lo, lo+n).  Value k >= 2 is drawn at
    hour rollover k-1 and sees cc[k-1] (from the window ``cc_vals`` that
    starts at global ``cc_lo``); the primers k < 2 see ``cc0``."""
    idx = _idx(lo, n, k_cloudy.device)
    w = max(cc_vals.shape[-1], 1)
    pos = torch.clamp(idx - 1 - cc_lo, 0, w - 1)
    gathered = (cc_vals[:, pos] if cc_vals.shape[-1]
                else cc0[:, None].expand(-1, n))
    cc_at = torch.where(idx < 2, cc0[:, None], gathered)
    keys = rng.fold_in(k_cloudy[:, None, :], idx)
    return cloudy_csi_draw(keys, cc_at)


def clear_day_window(k_day, lo: int, n: int):
    """Clear-sky-day values for global pair indices [lo, lo+n)."""
    keys = rng.fold_in(k_day[:, None, :], _idx(lo, n, k_day.device))
    return dist.normal(keys, CSI_CLEAR_DAY_LOC, CSI_CLEAR_DAY_SCALE)


def ws_window(k_ws, lo: int, n: int):
    """Daily windspeed values for global day indices [lo, lo+n)."""
    return dist.windspeed(
        rng.fold_in(k_ws[:, None, :], _idx(lo, n, k_ws.device)))


def minute_noise_values(k_min, cc, lo: int, feats):
    """Minute-noise values for global indices [lo, lo+len(feats)).

    Value i uses ``fold_in(fold_in(key, i), 0 | 1)`` (cloudy | clear);
    sigma follows the hourly cloud cover interpolated at the value's draw
    instant: ``sigma = sqrt(0.9) * (s0 + s1*8*cc)``.  ``feats`` is the
    (hour index into ``cc``'s window, hour fraction) pair per value.
    """
    h_idx, h_frac = feats
    cc_at = cc[:, h_idx] * (1 - h_frac) + cc[:, h_idx + 1] * h_frac
    keys = rng.fold_in(k_min[:, None, :], _idx(lo, h_idx.shape[0],
                                                k_min.device))

    def draw(sub, s0, s1):
        sigma = SIGMA_MIN_FACTOR * (s0 + s1 * 8.0 * cc_at)
        return 1.0 + sigma * rng.normal(rng.fold_in(keys, sub))

    return {
        "noise_min_cloudy": draw(0, *NOISE_CLOUDY),
        "noise_min_clear": draw(1, *NOISE_CLEAR),
    }


#: the per-second draw layouts of the JAX formulations: 'scan' the flat
#: scan's ``scan_draws_tmajor`` (groups outside, chains inside), 'scan2'
#: the nested scan's per-minute draws, 'trace' the wide / trace step's
#: per-chain ``_minute_grouped_draws`` (chains outside, groups inside).
#: threefry keys draw the same values in each; rbg keys do not (each
#: batched draw takes its batch's first key, rng.py)
DRAW_LAYOUTS = ("scan", "scan2", "trace")


def _tmajor(keys, draw, g0: int, n_groups: int, layout: str):
    """``draw(per-group keys)`` -> ``(..., 60)`` values laid out time-major
    ``(n_groups*60, chains)``, with the key batch of ``layout``."""
    if layout not in DRAW_LAYOUTS:
        raise ValueError(f"draw layout must be one of {DRAW_LAYOUTS}, "
                         f"got {layout!r}")
    n = keys.shape[0]
    if layout == "trace":
        # minute_grouped_keys: (T + 119) // 60 groups, one spare
        g = _idx(g0, n_groups + 1, keys.device)
        v = draw(rng.fold_in(keys[:, None, :], g))[:, :n_groups]
        return v.permute(1, 2, 0).reshape(n_groups * 60, n).contiguous()
    if layout == "scan2":
        v = torch.stack([draw(rng.fold_in(keys, g0 + j))
                         for j in range(n_groups)])
    else:
        g = _idx(g0, n_groups, keys.device)
        v = draw(rng.fold_in(keys[None, :, :], g[:, None]))  # (G, n, 60)
    return v.permute(0, 2, 1).reshape(n_groups * 60, n).contiguous()


def scan_draws_tmajor(keys, g0: int, n_groups: int, dtype=torch.float32,
                      layout: str = "scan"):
    """Per-second (u_cycle, z_sec) streams of a minute-aligned block,
    time-major ``(n_groups*60, chains)``: second s reads slot s % 60 of
    ``fold_in(fold_in(k_scan, g0 + s//60), 0 | 1)``; ``dtype`` float32 or
    (``compute_dtype='bf16'``) bfloat16; ``layout`` one of
    ``DRAW_LAYOUTS``."""
    u = _tmajor(keys, lambda kg: rng.uniform(rng.fold_in(kg, 0), (60,),
                                             dtype=dtype),
                g0, n_groups, layout)
    z = _tmajor(keys, lambda kg: rng.normal(rng.fold_in(kg, 1), (60,),
                                            dtype=dtype),
                g0, n_groups, layout)
    return u, z


def meter_block_tmajor(keys, g0: int, n_groups: int, max_w: float,
                       layout: str = "scan"):
    """Time-major meter stream ``(n_groups*60, chains)``:
    ``max_w * uniform(fold_in(k_meter, g), (60,))``."""
    return max_w * _tmajor(keys, lambda kg: rng.uniform(kg, (60,)),
                           g0, n_groups, layout)


def value_major_tables(arrays, minute_vals):
    """Window values transposed to value-major ``(n_values, chains)``."""
    return {
        "cc": arrays["cc"].T.contiguous(),
        "cloudy": arrays["cloudy"].T.contiguous(),
        "clear_day": arrays["clear_day"].T.contiguous(),
        "ws": arrays["ws"].T.contiguous(),
        "ml": minute_vals["noise_min_clear"].T.contiguous(),
        "mc": minute_vals["noise_min_cloudy"].T.contiguous(),
    }


def _lerp(table, i, f):
    return table[i] * (1 - f) + table[i + 1] * f


def csi_inputs(tables, x):
    """The carry-independent part of one or many seconds: interpolated
    samplers, the second noise, both bases and both minute noises.
    ``x`` holds the calendar indices/fractions as tensors shaped so that
    ``tables[...][idx]`` broadcasts (scalars for one second, ``(T,)`` with
    fractions ``(T, 1)`` for a block) and the per-chain normal ``z``."""
    h, d, m = x["h"], x["d"], x["m"]
    hf, df, mf = x["hf"], x["df"], x["mf"]
    cc_t = _lerp(tables["cc"], h, hf)
    ws_t = _lerp(tables["ws"], d, df)
    s0, s1 = NOISE_CLEAR
    noise_sec = SIGMA_SEC_FACTOR * (s0 + s1 * 8.0 * cc_t) * x["z"]
    return {
        "cc_t": cc_t,
        "ws_t": ws_t,
        "noise_sec": noise_sec,
        "base_clear": _lerp(tables["clear_day"], h + d, df),
        "base_cloudy": _lerp(tables["cloudy"], h, hf),
        "nmin_clear": _lerp(tables["ml"], m, mf),
        "nmin_cloudy": _lerp(tables["mc"], m, mf),
    }


def compose(ins, covered):
    """csi from the carry-independent inputs and the covered flag (the
    reference's branch assignment: covered selects the clear samplers)."""
    base = torch.where(covered, ins["base_clear"], ins["base_cloudy"])
    nmin = torch.where(covered, ins["nmin_clear"], ins["nmin_cloudy"])
    return base * (nmin + ins["noise_sec"])


def csi_compose_step(tables, x, carry):
    """One simulated second of csi for all chains: returns
    (carry', csi, covered)."""
    ins = csi_inputs(tables, x)
    cloud, total = renewal.cycle_from_u(x["u"], ins["cc_t"], ins["ws_t"])
    carry, covered = renewal.step_from_cycle(carry, cloud, total)
    return carry, compose(ins, covered), covered


def host_block_index(spec: TimeGridSpec, offset: int, length: int, blk=None):
    """Shared per-second calendar inputs of one block as numpy arrays
    (t, hour/day/minute indices and fractions), plus the minute-value range
    ``(lo, hi)`` the block reads."""
    if blk is None:
        blk = spec.block(offset, length)
    return {
        "t": np.asarray(blk.offset + np.arange(len(blk.epoch)), np.int32),
        "hour_idx": np.asarray(blk.hour_idx, np.int32),
        "day_idx": np.asarray(blk.day_idx, np.int32),
        "min_idx": np.asarray(blk.min_idx, np.int32),
        "hour_frac": np.asarray(blk.hour_fraction, np.float32),
        "day_frac": np.asarray(blk.day_fraction, np.float32),
        "min_frac": np.asarray(blk.min_fraction, np.float32),
    }, (int(blk.min_idx[0]), int(blk.min_idx[-1]) + 2)
