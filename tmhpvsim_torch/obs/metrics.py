"""Host-side metrics of the serving and streaming layers: counters, gauges,
histograms (own copy of the part of the JAX package's obs/metrics.py that
the server, the batchers and the streaming runtime use).

A registry hands out named metrics; :func:`get_registry` is the process
default, and :func:`use_registry` installs a fresh one for a scope (a
server run), so one run's numbers never mix with another's.
``MetricsRegistry.snapshot()`` is the JSON-able state;
:func:`quantile_from_snapshot` estimates a quantile from a histogram's
snapshot (Prometheus ``histogram_quantile`` semantics).
"""

from __future__ import annotations

import bisect
import contextlib
import threading
import time
from typing import Iterable, Optional

#: histogram bucket upper bounds (seconds; the +Inf bucket is implicit)
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 300.0,
)


class Counter:
    """Monotonically increasing value (floats allowed)."""

    __slots__ = ("name", "_v")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease "
                             f"(inc({amount}))")
        self._v += amount

    @property
    def value(self) -> float:
        return self._v


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "_v")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0

    def set(self, value: float) -> None:
        self._v = float(value)

    def add(self, delta: float) -> None:
        self._v += float(delta)

    @property
    def value(self) -> float:
        return self._v


class Histogram:
    """Count, sum, min, max and cumulative bucket counts (``buckets[i]``
    counts observations <= ``bounds[i]``)."""

    __slots__ = ("name", "bounds", "bucket_counts", "count", "sum",
                 "min", "max")

    def __init__(self, name: str, buckets: Iterable[float] = DEFAULT_BUCKETS):
        self.name = name
        self.bounds = tuple(sorted(float(b) for b in buckets))
        self.bucket_counts = [0] * len(self.bounds)
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        if self.min is None or value < self.min:
            self.min = value
        if self.max is None or value > self.max:
            self.max = value
        i = bisect.bisect_left(self.bounds, value)
        if i < len(self.bucket_counts):
            self.bucket_counts[i] += 1

    def snapshot(self) -> dict:
        cum = []
        running = 0
        for bound, n in zip(self.bounds, self.bucket_counts):
            running += n
            cum.append([bound, running])
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "mean": (self.sum / self.count) if self.count else None,
            "buckets": cum,
        }


def quantile_from_snapshot(snap: Optional[dict], q: float) -> Optional[float]:
    """Quantile estimate from a :meth:`Histogram.snapshot` by linear
    interpolation within the cumulative buckets, clamped to the observed
    [min, max]; None for an empty or absent histogram.

    When every observation landed in one bucket the estimate interpolates
    the observed span, ``min + q * (max - min)``; a quantile exactly on a
    cumulative bucket boundary is that bucket's upper bound; beyond the
    last finite bucket the answer is the observed ``max``."""
    if not snap or not snap.get("count"):
        return None
    count = snap["count"]
    target = q * count
    smin, smax = snap.get("min"), snap.get("max")
    buckets = [(b, c) for b, c in (snap.get("buckets") or ())]
    occupied = [i for i, (b, c) in enumerate(buckets)
                if c > (buckets[i - 1][1] if i else 0)]
    value = None
    if len(occupied) == 1 and buckets[occupied[0]][1] == count:
        if smin is not None and smax is not None:
            return smin + q * (smax - smin)
        value = buckets[occupied[0]][0]
    else:
        lo_bound, lo_cum = 0.0, 0
        for bound, cum in buckets:
            if cum >= target:
                if cum == target:
                    value = bound
                else:
                    frac = (target - lo_cum) / (cum - lo_cum)
                    value = lo_bound + frac * (bound - lo_bound)
                break
            lo_bound, lo_cum = bound, cum
    if value is None:
        value = smax
    if value is None:
        return None
    if smin is not None:
        value = max(value, smin)
    if smax is not None:
        value = min(value, smax)
    return value


class MetricsRegistry:
    """Named metrics.  Creation is locked (threads share a registry); the
    mutators are plain float operations under the GIL."""

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, **kw):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.setdefault(name, cls(name, **kw))
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, Histogram, buckets=buckets)

    @contextlib.contextmanager
    def timed(self, name: str):
        """Wall-time the scope into histogram ``name``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.histogram(name).observe(time.perf_counter() - t0)

    def snapshot(self) -> dict:
        """JSON-able state of every metric."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.snapshot()
        return out


_default = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-default registry."""
    return _default


@contextlib.contextmanager
def use_registry(registry: MetricsRegistry):
    """Install ``registry`` as the process default for the scope."""
    global _default
    prev = _default
    _default = registry
    try:
        yield registry
    finally:
        _default = prev
