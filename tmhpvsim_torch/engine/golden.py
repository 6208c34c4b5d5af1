"""The float64 golden model: a streaming, scalar, seeded numpy simulator of
the clear-sky index and of AC power (own copy of
tmhpvsim_tpu/engine/golden.py).

An independent derivation of the reference's streaming model stack, not
the engine's arithmetic: interpolated samplers advanced by a
day / hour / minute rollover cascade, the hourly cloud-cover Markov chain
(``transition_numpy``), the reference's renewal algorithm
(``ReferenceRenewal``), the per-second composition, and a blockwise
physics chain in float64 (``solar.block_geometry`` and
``pv.power_from_csi_np``).  Every draw comes from one
``np.random.Generator``, so a seed gives the JAX package's golden stream
number for number.  The drift sentinel (obs/sentinel.py) builds its
reference bands from it.
"""

from __future__ import annotations

import datetime as _dt
from typing import Optional

import numpy as np

from tmhpvsim_torch.config import ModelOptions, Site
from tmhpvsim_torch.data import SANDIA_INVERTER, SAPM_MODULE
from tmhpvsim_torch.models import pv as pvmod
from tmhpvsim_torch.models.markov_hourly import transition_numpy
from tmhpvsim_torch.models import solar
from tmhpvsim_torch.models.clearsky_index import (
    CSI_CLEAR_DAY_LOC,
    CSI_CLEAR_DAY_SCALE,
    CSI_CLOUDY_GAMMA_HIGH,
    CSI_CLOUDY_GAMMA_MID,
    CSI_CLOUDY_NORM_LOC,
    CSI_CLOUDY_NORM_SCALE,
    NOISE_CLEAR,
    NOISE_CLOUDY,
)
from tmhpvsim_torch.models.renewal import ReferenceRenewal

#: the noise variance splits in float64 (the engine's models round them to
#: float32)
SIGMA_MIN_FACTOR = np.sqrt(0.9)
SIGMA_SEC_FACTOR = np.sqrt(0.1 * 60)


class _Sampler:
    """(before, after) pair with linear interpolation — the reference's
    InterpolatedSampler (clearskyindexmodel.py:12-40)."""

    def __init__(self, draw):
        self._draw = draw
        self.before = draw()
        self.after = draw()

    def advance(self):
        self.before = self.after
        self.after = self._draw()

    def interpolate(self, fraction: float) -> float:
        return (1.0 - fraction) * self.before + fraction * self.after


class GoldenClearskyIndex:
    """Streaming per-second clear-sky index, scalar float64.

    ``next(time)`` must be called with non-decreasing datetimes (the
    reference is driven at 1 Hz by fixedclock).
    """

    def __init__(self, time: _dt.datetime,
                 options: ModelOptions = ModelOptions(),
                 rng: Optional[np.random.Generator] = None):
        self.rng = rng if rng is not None else np.random.default_rng()
        self.options = options
        self._set_time(time, fire=False)

        # hourly cloud cover: persistent chain or the reference's accidental
        # i.i.d.-from-1.0 behaviour (clearskyindexmodel.py:61-63)
        self._cc_state = 1.0

        def draw_cc():
            nxt = transition_numpy(self.rng, self._cc_state)
            if self.options.persistent_cloud_chain:
                self._cc_state = nxt
            return nxt

        self.cloudcover_hour = _Sampler(draw_cc)
        self.clear_day = _Sampler(
            lambda: self.rng.normal(CSI_CLEAR_DAY_LOC, CSI_CLEAR_DAY_SCALE)
        )
        self.cloudy_hour = _Sampler(self._draw_cloudy)
        self.noise_min_cloudy = _Sampler(
            lambda: self._draw_minute_noise(*NOISE_CLOUDY)
        )
        self.noise_min_clear = _Sampler(
            lambda: self._draw_minute_noise(*NOISE_CLEAR)
        )
        self.windspeed_day = _Sampler(
            lambda: self.rng.gamma(2.69, 2.14)
        )
        self.renewal = ReferenceRenewal(
            self.cloudcover_hour.interpolate(0.0),
            self.windspeed_day.interpolate(0.0),
            self.rng,
        )

    # -- draw functions ------------------------------------------------

    def _draw_cloudy(self) -> float:
        """Cloudy-csi draw by cloud-cover band (clearskyindexmodel.py:68-84,
        NameError band fixed to a Gamma sample)."""
        cc = self.cloudcover_hour.interpolate(self._hour_fraction) \
            if hasattr(self, "cloudcover_hour") else 1.0
        if cc < 6 / 8:
            return self.rng.normal(CSI_CLOUDY_NORM_LOC, CSI_CLOUDY_NORM_SCALE)
        if cc < 7 / 8:
            a, s = CSI_CLOUDY_GAMMA_MID
        else:
            a, s = CSI_CLOUDY_GAMMA_HIGH
        return s * self.rng.gamma(a)

    def _draw_minute_noise(self, sigma0, sigma1) -> float:
        cc = self.cloudcover_hour.interpolate(self._hour_fraction) \
            if hasattr(self, "cloudcover_hour") else 1.0
        sigma = SIGMA_MIN_FACTOR * (sigma0 + sigma1 * 8.0 * cc)
        return self.rng.normal(1.0, sigma)

    # -- time cascade --------------------------------------------------

    def _set_time(self, time: _dt.datetime, fire: bool = True):
        min_fraction = time.second / 60.0
        self._hour_fraction = (time.minute + min_fraction) / 60.0
        self._day_fraction = (time.hour + self._hour_fraction) / 24.0
        self._min_fraction = min_fraction
        prev = getattr(self, "_time", None)
        self._time = time
        if not fire or prev is None:
            return
        if prev.day != time.day:
            self.clear_day.advance()
            self.windspeed_day.advance()
        if prev.hour != time.hour:
            self.cloudcover_hour.advance()
            self.clear_day.advance()
            if self.options.advance_cloudy_hour:
                self.cloudy_hour.advance()
        if prev.minute != time.minute:
            self.noise_min_cloudy.advance()
            self.noise_min_clear.advance()

    # -- per-second composition ----------------------------------------

    def next(self, time: _dt.datetime) -> float:
        """csi at ``time`` (clearskyindexmodel.py:128-160)."""
        self._set_time(time)
        cc = self.cloudcover_hour.interpolate(self._hour_fraction)

        self.renewal.update_parameters(
            cc, self.windspeed_day.interpolate(self._day_fraction)
        )
        covered = bool(next(self.renewal))
        #: exposed for the long-horizon parity harness (tests/test_parity.py)
        self.last_covered = covered

        # second-scale noise uses the clear sigmas in both branches
        # (clearskyindexmodel.py:152,158)
        s0, s1 = NOISE_CLEAR
        noise_sec = self.rng.normal(
            0.0, SIGMA_SEC_FACTOR * (s0 + s1 * 8.0 * cc)
        )

        use_clear = covered if not self.options.swap_covered_branches \
            else not covered
        if use_clear:
            base = self.clear_day.interpolate(self._day_fraction)
            nmin = self.noise_min_clear.interpolate(self._min_fraction)
        else:
            base = self.cloudy_hour.interpolate(self._hour_fraction)
            nmin = self.noise_min_cloudy.interpolate(self._min_fraction)
        return base * (nmin + noise_sec)


class GoldenPVModel:
    """Streaming AC power with blockwise physics precompute.

    The reference precomputes 5000-second blocks through its pvlib chain and
    serves ``next(time)`` from the cache (pvmodel.py:38-87).  Same scheme
    here, with the csi stream advanced sequentially and the physics applied
    vectorised in float64 over each block.
    """

    def __init__(self, time: _dt.datetime, site: Site = Site(),
                 options: ModelOptions = ModelOptions(),
                 rng: Optional[np.random.Generator] = None,
                 cache_s: int = 5000):
        self.site = site
        self.csi_model = GoldenClearskyIndex(time, options, rng)
        self.cache_s = cache_s
        self._tz = None  # lazily resolved ZoneInfo for local->epoch mapping
        self._cache_start = None
        self._cache = None
        self._fill(time)

    def _epoch(self, time: _dt.datetime) -> int:
        if time.tzinfo is None:
            from zoneinfo import ZoneInfo

            if self._tz is None:
                self._tz = ZoneInfo(self.site.timezone)
            time = time.replace(tzinfo=self._tz)
        return int(time.timestamp())

    def _fill(self, from_time: _dt.datetime):
        """Advance the csi stream ``cache_s`` seconds and run the physics."""
        csi = np.empty(self.cache_s)
        times = [from_time + _dt.timedelta(seconds=i)
                 for i in range(self.cache_s)]
        for i, t in enumerate(times):
            csi[i] = self.csi_model.next(t)

        epoch = np.asarray([self._epoch(t) for t in times], dtype=np.float64)
        doy = np.asarray([t.timetuple().tm_yday for t in times],
                         dtype=np.float64)
        geom = solar.block_geometry(epoch, doy, self.site)
        ac = pvmod.power_from_csi_np(csi, geom, SAPM_MODULE,
                                     SANDIA_INVERTER)
        self._cache_start = from_time
        self._cache = ac

    def next(self, time: _dt.datetime) -> float:
        """AC watts at ``time`` (whole-second, non-decreasing)."""
        i = int((time - self._cache_start).total_seconds())
        if i >= self.cache_s:
            self._fill(time)
            i = 0
        if i < 0:
            raise ValueError("GoldenPVModel.next requires monotonic time")
        return float(self._cache[i])
