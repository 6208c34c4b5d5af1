"""Fixed-rate simulation clock (own copy of the JAX package's
runtime/clock.py).

``fixedclock`` is an async generator yielding *ideal grid* timestamps
``start + i/rate``, never the actual wall time, so downstream joins see a
perfectly regular series even when the loop lags.  In realtime mode it
sleeps until the wall clock reaches each tick; ``PacingMonitor`` records
the lag and warns, rate-limited, when more than two periods behind.

Deliberate deviation from the reference's clock: in non-realtime mode
there is no 10 ms floor sleep.  The reference sleeps at least 10 ms per
tick even with ``realtime=False``, which caps every simulation at about
100 simulated seconds per second; here non-realtime mode yields back to
the event loop (``asyncio.sleep(0)``), which keeps the scheduling
cooperative without the cap.
"""

from __future__ import annotations

import asyncio
import datetime as _dt
import logging
import time
from typing import AsyncIterator, Optional

from tmhpvsim_torch.obs import metrics as obs_metrics

logger = logging.getLogger(__name__)


class PacingMonitor:
    """Realtime pacing lag as metrics and rate-limited warnings.

    Two gauges on the metrics registry: ``clock.pacing_lag_s`` (the
    current lag behind the ideal grid) and ``clock.pacing_slip_total_s``
    (the cumulative new slip: increases of the lag only, so recovered lag
    is not counted twice).  At most one warning per ``warn_every_s``,
    carrying the cumulative figure.  ``observe`` takes an injectable
    ``now`` and returns True when it warned.
    """

    def __init__(self, period: float, warn_every_s: float = 10.0):
        self.period = period
        self.warn_every_s = warn_every_s
        self._last_warn = None
        self._prev_lag = 0.0
        reg = obs_metrics.get_registry()
        self._g_lag = reg.gauge("clock.pacing_lag_s")
        self._g_slip = reg.gauge("clock.pacing_slip_total_s")
        self._g_lag.set(0.0)
        self._g_slip.set(0.0)

    def observe(self, behind: float, now: Optional[float] = None) -> bool:
        lag = max(0.0, behind)
        self._g_lag.set(lag)
        if lag > self._prev_lag:
            self._g_slip.add(lag - self._prev_lag)
        self._prev_lag = lag
        if behind <= 2 * self.period:
            return False
        if now is None:
            now = time.monotonic()
        if self._last_warn is not None and \
                now - self._last_warn < self.warn_every_s:
            return False
        self._last_warn = now
        logger.warning(
            "%.2f s behind realtime (cumulative slip %.2f s; warnings "
            "rate-limited to one per %.0f s)",
            behind, self._g_slip.value, self.warn_every_s)
        return True


async def fixedclock(
    rate: float = 1.0,
    realtime: bool = True,
    start: Optional[_dt.datetime] = None,
    duration_s: Optional[float] = None,
) -> AsyncIterator[_dt.datetime]:
    """Yield naive local datetimes on the ideal ``start + i/rate`` grid;
    ``duration_s`` bounds the stream (None: it never ends)."""
    period = 1.0 / rate
    if start is None:
        start = _dt.datetime.now()
    start_wall = time.monotonic()
    monitor = PacingMonitor(period) if realtime else None
    i = 0
    while duration_s is None or i * period < duration_s:
        yield start + _dt.timedelta(seconds=i * period)
        i += 1
        if realtime:
            behind = (time.monotonic() - start_wall) - i * period
            monitor.observe(behind)
            await asyncio.sleep(max(0.0, -behind))
        else:
            await asyncio.sleep(0)
