"""Per-second binary cloud cover: the alternating cloud/clear renewal
process with an O(1) carry (own copy of tmhpvsim_tpu/models/renewal.py:
the device half in torch, ``ReferenceRenewal`` in numpy).

A cycle is a cloud transit time from the power law truncated so the whole
cycle stays under 90 minutes, plus the clear interval that makes the
cycle's cloud fraction equal the capped hourly cloud cover.  The carry is
three floats ``(cloud_end, total_end, sec)``.
"""

from __future__ import annotations

import numpy as np
import torch

from tmhpvsim_torch import rng
from tmhpvsim_torch.models import distributions as dist

MAX_CYCLE_S = 90 * 60
TARGET_CYCLE_S = 60 * 60
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


def init(keys, cloudcover, windspeed, impl="threefry2x32"):
    """Initial carry: ``k_cycle, k_phase = split(key)``, one uniform each."""
    ks = rng.split(keys, 2, impl)
    return init_from_u(rng.uniform(ks[..., 0, :], impl=impl),
                       rng.uniform(ks[..., 1, :], impl=impl),
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


class ReferenceRenewal:
    """The reference's renewal algorithm, stateful and float64 (the JAX
    package's ``ReferenceRenewal``, the golden model's cloud process):
    growing cumulative candidate arrays, a selection among up to 20
    power-law draws of the candidate whose cycle is closest to an hour, a
    reset and one retry after 20 rejections, and, where the constraints
    cannot be met (cloud cover below ~0.06), the unconstrained
    cloud-fraction renewal."""

    def __init__(self, cloudcover, windspeed, rng=None):
        self.rng = rng if rng is not None else np.random.default_rng()
        self.update_parameters(cloudcover, windspeed)
        self._reset_sigma()
        self._next_cloud()
        self.sec = int((self.cloud_length + self.clear_length)
                       * self.rng.random())

    def update_parameters(self, cloudcover, windspeed=None):
        # clamped below as the JAX package does (the reference fails for
        # cover below 1/12 and divides by zero at 0)
        self.cloudcover = min(max(float(cloudcover), 1e-3), MAX_CLOUDCOVER)
        if windspeed is not None:
            self.windspeed = float(windspeed)

    def _reset_sigma(self):
        n = max(int(self.cloudcover * 12), 1)
        self.sigma_cloud = 5 * 60 * np.arange(1, n + 1, dtype=np.float64)
        self.sigma_clear = (1 / self.cloudcover - 1) * self.sigma_cloud

    def _draw_cloud_seconds(self):
        beta = dist.CLOUD_LENGTH_BETA
        a = dist.CLOUD_LENGTH_XMAX_M ** (1 - beta)
        d = dist.CLOUD_LENGTH_XMIN_M ** (1 - beta) - a
        return (a + d * self.rng.random()) ** (1 / (1 - beta)) \
            / self.windspeed

    def _next_cloud(self, retried=False):
        for _ in range(20):
            cloud = self._draw_cloud_seconds()
            cand_cloud = cloud + self.sigma_cloud
            cand_clear = (1 / self.cloudcover - 1) * cand_cloud
            total = cand_cloud + cand_clear
            ok = (cand_clear - self.sigma_clear > 0) & (total < MAX_CYCLE_S)
            if ok.any():
                break
        else:
            if retried:
                # infeasible (cover below ~0.06): keep the cloud fraction,
                # drop the cycle cap
                cloud = self._draw_cloud_seconds()
                self.cloud_length = cloud
                self.clear_length = cloud * (1 / self.cloudcover - 1)
                self._reset_sigma()
                self.sec = 0
                return self.cloud_length, self.clear_length
            self._reset_sigma()
            return self._next_cloud(retried=True)

        idx = np.nonzero(ok)[0]
        pick = idx[np.abs(total[idx] - TARGET_CYCLE_S).argmin()]
        self.cloud_length = cloud
        self.clear_length = cand_clear[pick] - self.sigma_clear[pick]
        self.sigma_cloud = np.concatenate(([cloud], cand_cloud[: pick + 1]))
        self.sigma_clear = np.concatenate(([self.clear_length],
                                           cand_clear[: pick + 1]))
        self.sec = 0

    def __next__(self):
        self.sec += 1
        if self.sec < self.cloud_length:
            return 1
        if self.sec < self.cloud_length + self.clear_length:
            return 0
        self._next_cloud()
        return next(self)
