"""Per-second binary cloud cover: the alternating cloud/clear renewal
process with an O(1) carry (own copy of the device half of
tmhpvsim_tpu/models/renewal.py in torch).

A cycle is a cloud transit time from the power law truncated so the whole
cycle stays under 90 minutes, plus the clear interval that makes the
cycle's cloud fraction equal the capped hourly cloud cover.  The carry is
three floats ``(cloud_end, total_end, sec)``.
"""

from __future__ import annotations

import torch

from tmhpvsim_torch import rng
from tmhpvsim_torch.models import distributions as dist

MAX_CYCLE_S = 90 * 60
MAX_CLOUDCOVER = 0.95


def cycle_from_u(u, cloudcover, windspeed):
    """One (cloud_length, total_length) cycle from a pre-drawn uniform."""
    cc = torch.clamp(cloudcover, 1e-3, MAX_CLOUDCOVER)
    cap_m = MAX_CYCLE_S * cc * windspeed  # length cap in metres
    cloud = dist.cloud_length_seconds_from_u(u, windspeed, xmax_m=cap_m)
    total = cloud / cc
    return cloud, total


def init_from_u(u_cycle, u_phase, cloudcover, windspeed):
    """Initial carry from its two uniforms: phase randomised inside the
    first cycle."""
    cloud, total = cycle_from_u(u_cycle, cloudcover, windspeed)
    return {"cloud_end": cloud, "total_end": total, "sec": total * u_phase}


def init(keys, cloudcover, windspeed):
    """Initial carry: ``k_cycle, k_phase = split(key)``, one uniform each."""
    ks = rng.split(keys, 2)
    return init_from_u(rng.uniform(ks[..., 0, :]), rng.uniform(ks[..., 1, :]),
                       cloudcover, windspeed)


def step_from_cycle(carry, cloud_new, total_new):
    """Advance one second given this second's candidate cycle (consumed
    only on redraw); returns (carry, covered) with covered a bool tensor."""
    sec = carry["sec"] + 1.0
    redraw = sec >= carry["total_end"]
    cloud_end = torch.where(redraw, cloud_new, carry["cloud_end"])
    total_end = torch.where(redraw, total_new, carry["total_end"])
    sec = torch.where(redraw, torch.ones_like(sec), sec)
    covered = sec < cloud_end
    return {"cloud_end": cloud_end, "total_end": total_end, "sec": sec}, covered
