"""Retries with backoff, and a circuit breaker (own copy of the part of
the JAX package's runtime/resilience.py that serving and the streaming
apps use).

* :class:`ResiliencePolicy`: one retry loop with a decorrelated-jitter
  (or, ``jitter=False``, constant) backoff; ``attempts=forever`` makes
  it a reconnect loop (its warnings rate-limited), otherwise the
  ``fallback`` decides what exhaustion returns (:data:`propagate`, the
  default, re-raises the last failure); a ``breaker`` refuses calls
  while open with :class:`BreakerOpenError`.
* :func:`asyncretry`: the reference's retry decorator (constant delay,
  ``forever``, a fallback value) as a policy without jitter;
  :func:`reconnect_policy`: the apps' reconnect-and-resubscribe loop
  (forever, jittered between 0.5 s and 5 s).
* :class:`CircuitBreaker`: consecutive failures open it; after
  ``reset_s`` it is half-open and work flows again, and the next
  outcome closes it (a success) or re-opens it (a failure).  The
  batchers shed requests with typed ``unavailable`` while it is open.
  This repairs the JAX package's breaker, which re-opens only on a
  probe marked by ``allow()``: its batchers never call it, so there a
  failure while half-open leaves the breaker half-open and work keeps
  flowing to a failing dispatch.

Metrics go to the given registry, else the process default at event
time: ``retry.attempts.{name}``, ``retry.exhausted.{name}``,
``resilience.retries_total``, ``resilience.giveups_total``,
``resilience.breaker_open_total.{name}``,
``resilience.breaker_rejected_total.{name}`` and the gauge
``resilience.breaker_state.{name}`` (0 closed, 1 half-open, 2 open).
"""

from __future__ import annotations

import asyncio
import functools
import inspect
import logging
import random
import time
from typing import Optional

from tmhpvsim_torch.obs import metrics as obs_metrics

logger = logging.getLogger(__name__)

#: sentinel for unbounded retries
forever = ...


class _Propagate:
    """The fallback that re-raises the last failure."""


propagate = _Propagate()

_UNSET = object()

#: window of the rate-limited reconnect warnings
WARN_EVERY_S = 10.0


class WarnRateLimiter:
    """At most one warning per ``every_s``, with a suppressed-count
    suffix."""

    def __init__(self, every_s: float = WARN_EVERY_S):
        self.every_s = every_s
        self._last: Optional[float] = None
        self._suppressed = 0

    def warn(self, log: logging.Logger, fmt: str, *args) -> bool:
        now = time.monotonic()
        if self._last is not None and now - self._last < self.every_s:
            self._suppressed += 1
            return False
        suffix = ""
        if self._suppressed:
            suffix = (f" ({self._suppressed} similar warnings "
                      f"suppressed in the last {self.every_s:.0f} s)")
        self._last = now
        self._suppressed = 0
        log.warning(fmt + "%s", *args, suffix)
        return True


class BreakerOpenError(ConnectionError):
    """A call refused because its circuit breaker is open (a
    ``ConnectionError``, so reconnect loops treat it as transient)."""


_STATE_CODES = {"closed": 0, "half_open": 1, "open": 2}


class CircuitBreaker:
    """Half-open circuit breaker (see the module docstring)."""

    def __init__(self, name: str = "default", *,
                 failure_threshold: int = 5, reset_s: float = 30.0,
                 registry=None):
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_s = reset_s
        self._registry = registry
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0

    def _reg(self):
        return (self._registry if self._registry is not None
                else obs_metrics.get_registry())

    def _set_state(self, state: str) -> None:
        self._state = state
        self._reg().gauge(
            f"resilience.breaker_state.{self.name}").set(
                _STATE_CODES[state])

    def _maybe_half_open(self) -> None:
        if (self._state == "open"
                and time.monotonic() - self._opened_at >= self.reset_s):
            self._set_state("half_open")

    @property
    def state(self) -> str:
        self._maybe_half_open()
        return self._state

    def count_rejected(self) -> None:
        """Count a rejection made on this breaker's behalf."""
        self._reg().counter(
            f"resilience.breaker_rejected_total.{self.name}").inc()

    def record_success(self) -> None:
        self._failures = 0
        if self._state != "closed":
            logger.info("breaker %r closed after successful probe",
                        self.name)
            self._set_state("closed")

    def reset_remaining_s(self) -> float:
        """Seconds until an open breaker half-opens (0 when not open)."""
        self._maybe_half_open()
        if self._state != "open":
            return 0.0
        return max(0.0,
                   self.reset_s - (time.monotonic() - self._opened_at))

    def record_failure(self) -> None:
        self._maybe_half_open()
        self._failures += 1
        if self._state == "half_open" or \
                self._failures >= self.failure_threshold:
            self._reg().counter(
                f"resilience.breaker_open_total.{self.name}").inc()
            logger.warning(
                "breaker %r open after %d consecutive failure(s); "
                "next probe in %.1f s", self.name, self._failures,
                self.reset_s)
            self._set_state("open")
            self._opened_at = time.monotonic()


class ResiliencePolicy:
    """One retry loop (see the module docstring): ``attempts`` an int or
    :data:`forever`; the sleep before retry ``n`` is drawn from
    ``uniform(base, 3 * previous)`` (``jitter=False``: ``base``), capped
    at ``max_delay_s``; on exhaustion
    ``fallback`` applies (:data:`propagate` re-raises, a callable gets
    the exception, anything else is returned); ``asyncio.CancelledError``
    is always fatal."""

    def __init__(self, *, attempts=3, base_delay_s: float = 0.0,
                 max_delay_s: Optional[float] = None, jitter: bool = True,
                 breaker: Optional[CircuitBreaker] = None,
                 name: Optional[str] = None, fallback=propagate,
                 registry=None):
        self.attempts = attempts
        self.base_delay_s = base_delay_s
        self.max_delay_s = (base_delay_s if max_delay_s is None
                            else max_delay_s)
        self.jitter = jitter
        self.breaker = breaker
        self.name = name
        self.fallback = fallback
        self._registry = registry
        self._rng = random.Random()
        self._warn = WarnRateLimiter()

    def backoff(self, prev: float) -> float:
        """The sleep before the next retry, given the previous sleep."""
        if self.base_delay_s <= 0.0:
            return 0.0
        if not self.jitter:
            return min(self.max_delay_s, self.base_delay_s)
        return min(self.max_delay_s,
                   self._rng.uniform(self.base_delay_s,
                                     max(prev, self.base_delay_s) * 3.0))

    async def call(self, fn, *args, name: Optional[str] = None,
                   fallback=_UNSET, **kwargs):
        """``await fn(*args, **kwargs)`` under this policy."""
        qualname = name or self.name or getattr(fn, "__qualname__",
                                                repr(fn))
        fb = self.fallback if fallback is _UNSET else fallback
        unbounded = self.attempts is forever
        n = 0
        delay = self.base_delay_s
        while True:
            if self.breaker is not None and \
                    self.breaker.state == "open":
                self.breaker.count_rejected()
                raise BreakerOpenError(
                    f"{qualname}: circuit breaker {self.breaker.name!r} "
                    "is open")
            try:
                result = await fn(*args, **kwargs)
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                n += 1
                reg = self._registry or obs_metrics.get_registry()
                reg.counter(f"retry.attempts.{qualname}").inc()
                reg.counter("resilience.retries_total").inc()
                if self.breaker is not None:
                    self.breaker.record_failure()
                if not unbounded and n >= self.attempts:
                    reg.counter(f"retry.exhausted.{qualname}").inc()
                    reg.counter("resilience.giveups_total").inc()
                    logger.warning(
                        "%s exhausted %d attempt(s); final failure %s: %s "
                        "(%s)", qualname, n, type(exc).__name__, exc,
                        "re-raising" if fb is propagate
                        else "applying fallback")
                    if fb is propagate:
                        raise
                    if callable(fb):
                        res = fb(exc)
                        return await res if inspect.isawaitable(res) \
                            else res
                    return fb
                delay = self.backoff(delay)
                if unbounded:
                    self._warn.warn(
                        logger, "%s failed (%s: %s); retrying in %.1f s "
                        "(attempt %s)", qualname, type(exc).__name__, exc,
                        delay, n)
                else:
                    logger.info(
                        "%s failed (%s: %s); retrying in %.1f s "
                        "(attempt %s)", qualname, type(exc).__name__,
                        exc, delay, f"{n}/{self.attempts}")
                await asyncio.sleep(delay)
            else:
                if self.breaker is not None:
                    self.breaker.record_success()
                return result


def asyncretry(func=None, *, attempts=3, delay: float = 0.0,
               fallback=propagate):
    """Decorator: retry an async callable on exception, with a constant
    ``delay`` between attempts, ``attempts`` an int or :data:`forever`,
    and ``fallback`` on exhaustion (the reference's decorator, as a
    :class:`ResiliencePolicy` without jitter).  Bare (``@asyncretry``) or
    parameterised (``@asyncretry(delay=5, attempts=forever)``)."""
    if func is None:
        return functools.partial(asyncretry, attempts=attempts, delay=delay,
                                 fallback=fallback)
    policy = ResiliencePolicy(attempts=attempts, base_delay_s=delay,
                              max_delay_s=delay, jitter=False,
                              fallback=fallback)

    @functools.wraps(func)
    async def wrapper(*args, **kwargs):
        return await policy.call(func, *args, name=func.__qualname__,
                                 **kwargs)

    return wrapper


def reconnect_policy(name: Optional[str] = None,
                     **overrides) -> ResiliencePolicy:
    """The apps' reconnect-and-resubscribe policy: retry forever with
    decorrelated jitter between 0.5 s and 5 s."""
    kwargs = dict(attempts=forever, base_delay_s=0.5, max_delay_s=5.0,
                  name=name)
    kwargs.update(overrides)
    return ResiliencePolicy(**kwargs)
