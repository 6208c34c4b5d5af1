"""Timestamp join of partial records from N streams (own copy of the JAX
package's runtime/funnel.py).

A dict cache keyed by timestamp: each ``put(time, field=value)`` merges
into the cached record, and when every field is present the completed
record moves to the output queue.  It is the whole stream join between
the broker's meter feed and the local PV feed of ``pvsim --backend
asyncio``.

Two deviations from the reference's funnel, both kept from the JAX
package:

* leak fix: the reference's cache grows without bound if one stream
  stalls.  ``max_pending`` (default 10 000) evicts the oldest incomplete
  records with a rate-limited warning; ``None`` restores the unbounded
  behaviour.
* backpressure: under ``--no-realtime`` the local PV stream can run
  thousands of simulated seconds ahead of the broker-paced meter stream,
  so every pv-only record would age past ``max_pending`` and be evicted
  before its meter value arrives.  ``max_lookahead`` bounds how far a
  producer may run ahead of the slowest *other* stream: ``put`` first
  delivers its value (so the join can always progress, which keeps the
  wait deadlock-free), then blocks until the other streams are within
  the window.  A stream that has never delivered imposes no time
  constraint, but ``max_initial_pending`` caps the records a producer may
  pile up before it (a slow-to-start peer would otherwise see its
  joinable records evicted before its first value).  Stall decisions key
  on the binding stream, the one pinning min(newest): if it makes no
  progress for ``stall_timeout_s`` the funnel logs and suspends that
  producer's backpressure until it advances again, so a meter feed that
  dies degrades to free-run-and-evict instead of hanging the app, while
  a merely slow one keeps the producer blocked.
"""

from __future__ import annotations

import asyncio
import heapq
import logging
import math
import time as _time
from typing import NamedTuple, Optional, Type

from tmhpvsim_torch.obs import metrics as obs_metrics

logger = logging.getLogger(__name__)

#: eviction warnings are rate-limited to one per this many seconds: a
#: --no-realtime free-run can evict thousands of records per second, and
#: per-event visibility lives in the ``funnel.evicted_total`` counter
EVICT_WARN_EVERY_S = 10.0

#: sentinel: "use the default initial-pending cap, clamped under
#: max_pending" — distinct from an explicit value (validated) or None
#: (disabled)
_DEFAULT_INITIAL = object()


class SynchronizingFunnel:
    """Merge per-timestamp partial records; emit completed ones in put-order.

    ``record_type`` is a NamedTuple class whose fields are the joined
    streams (the reference's ``Data = namedtuple(..., ['meter', 'pv'])``,
    pvsim.py:19); missing fields are NaN until every stream delivered.
    """

    def __init__(self, record_type: Type[NamedTuple],
                 queue: "asyncio.Queue",
                 max_pending: Optional[int] = 10_000,
                 max_lookahead=None,
                 stall_timeout_s: float = 10.0,
                 max_initial_pending: Optional[int] = _DEFAULT_INITIAL):
        self._type = record_type
        self._blank = record_type(*([math.nan] * len(record_type._fields)))
        self._queue = queue
        self._cache: dict = {}
        #: min-heap of times ever inserted into the cache, for O(log n)
        #: oldest-first eviction; entries go stale when a record completes
        #: (lazy deletion: _evict_if_needed skips keys no longer cached)
        self._age_heap: list = []
        self.max_pending = max_pending
        #: max `time` distance a producer may run ahead of the slowest other
        #: stream (same type as `time - time`: timedelta for datetimes,
        #: number for numeric grids); None disables backpressure
        self.max_lookahead = max_lookahead
        self.stall_timeout_s = stall_timeout_s
        #: before the other streams deliver their FIRST value there is no
        #: clock to be ahead of, but an unbounded free-run would fill the
        #: cache past max_pending and evict the very records the late
        #: stream will want to join (e.g. pv racing ahead while
        #: metersim builds its first block).  Cap the pending records a
        #: producer may accumulate in that window; stall/suspend semantics
        #: apply as usual if the other stream never shows up.
        if max_initial_pending is _DEFAULT_INITIAL:
            # default: clamp under max_pending so eviction can never keep
            # the cache below the cap and silently disable it
            max_initial_pending = 3600 if max_pending is None \
                else min(3600, max(1, max_pending // 2))
        elif (max_pending is not None and max_initial_pending is not None
                and max_initial_pending >= max_pending):
            raise ValueError(
                f"max_initial_pending ({max_initial_pending}) must be < "
                f"max_pending ({max_pending}): eviction would keep the "
                "cache below the cap and silently disable it"
            )
        self.max_initial_pending = max_initial_pending
        self.n_evicted = 0
        self._last_evict_warn: Optional[float] = None
        self._evict_warns_suppressed = 0
        # metrics bind the process-default registry at construction:
        # construct funnels inside a use_registry scope to isolate a run
        reg = obs_metrics.get_registry()
        self._g_pending = reg.gauge("funnel.pending_depth")
        self._g_high_water = reg.gauge("funnel.pending_high_water")
        self._c_evicted = reg.counter("funnel.evicted_total")
        self._c_stalls = reg.counter("funnel.stall_suspends_total")
        self._c_bp_waits = reg.counter("funnel.backpressure_waits_total")
        self._high_water = 0
        self._newest: dict = {}       # field -> newest time delivered
        self._advanced = asyncio.Event()
        #: per-producer suspension: {other-streams key -> the BINDING
        #: (minimum) floor at the moment that producer's backpressure gave
        #: up; cleared when it advances}
        self._suspended: dict = {}

    def __len__(self):
        return len(self._cache)

    async def put(self, time, **fields) -> None:
        rec = self._cache.get(time, self._blank)._replace(**fields)
        if any(isinstance(v, float) and math.isnan(v) for v in rec):
            if time not in self._cache:
                heapq.heappush(self._age_heap, time)
            self._cache[time] = rec
            await self._evict_if_needed()
            depth = len(self._cache)
            self._g_pending.set(depth)
            if depth > self._high_water:
                self._high_water = depth
                self._g_high_water.set(depth)
        else:
            self._cache.pop(time, None)
            # drain stale heap entries now, not only at eviction time: in a
            # healthy join the cache stays small and eviction never runs,
            # but every record passed through the heap — without this the
            # heap gains one entry per joined timestamp forever.  Times
            # arrive near-monotonically, so completed records surface at
            # the heap top and this stays amortised O(log n)...
            while self._age_heap and self._age_heap[0] not in self._cache:
                heapq.heappop(self._age_heap)
            # ...and a compaction backstop bounds the pathological case
            # (completions in anti-chronological order keep stale entries
            # buried mid-heap)
            if len(self._age_heap) > 2 * len(self._cache) + 64:
                self._age_heap = list(self._cache)
                heapq.heapify(self._age_heap)
            self._g_pending.set(len(self._cache))
            await self._queue.put((time, rec))
        for f in fields:
            cur = self._newest.get(f)
            if cur is None or time > cur:
                self._newest[f] = time
        self._advanced.set()  # wake producers waiting on this stream
        await self._backpressure(time, fields)

    def _floors(self, others) -> Optional[tuple]:
        """Newest times of the ``others`` streams, or None while any of
        them has not delivered yet."""
        vals = tuple(self._newest.get(f) for f in others)
        return None if None in vals else vals

    async def _backpressure(self, time, fields) -> None:
        if self.max_lookahead is None:
            return
        others = tuple(f for f in self._type._fields if f not in fields)
        if not others:
            return  # complete record: nothing to wait for
        loop = asyncio.get_event_loop()
        deadline = loop.time() + self.stall_timeout_s
        first = self._floors(others)
        last_binding = None if first is None else min(first)
        waited = False
        while True:
            floors = self._floors(others)
            # All decisions key on the BINDING floor (the slowest other
            # stream): with 3+ streams, a live stream's progress must
            # neither reset the stall clock for a dead one pinning the
            # minimum, nor re-arm a suspension taken against it.  A None
            # binding means some stream has not delivered at all yet —
            # no clock to be ahead of, but the pending-cache cap applies.
            binding = None if floors is None else min(floors)
            if others in self._suspended:
                susp = self._suspended[others]
                advanced = (binding is not None
                            and (susp is None or binding > susp))
                if not advanced:
                    return  # still stalled: stay in free-run mode
                del self._suspended[others]  # it advanced: re-arm
            if binding is None:
                if self.max_initial_pending is None or \
                        len(self._cache) <= self.max_initial_pending:
                    return
            elif time <= binding + self.max_lookahead:
                return
            if binding is not None and \
                    (last_binding is None or binding > last_binding):
                # progress of the binding stream resets the stall clock:
                # only a genuinely *silent* constraint trips the timeout, a
                # slow-but-live one keeps this producer blocked (that is
                # the backpressure)
                last_binding = binding
                deadline = loop.time() + self.stall_timeout_s
            remaining = deadline - loop.time()
            if remaining <= 0:
                self._suspended[others] = binding
                self._c_stalls.inc()
                logger.warning(
                    "funnel backpressure: stream(s) %s made no progress "
                    "for %.0f s (newest: %s); resuming free-run until they "
                    "advance", others, self.stall_timeout_s, self._newest,
                )
                return
            if not waited:
                waited = True
                self._c_bp_waits.inc()  # one count per put that blocked
            self._advanced.clear()
            try:
                await asyncio.wait_for(self._advanced.wait(), remaining)
            except asyncio.TimeoutError:
                pass  # loop once more; the deadline branch handles it

    async def _evict_if_needed(self):
        if self.max_pending is None or len(self._cache) <= self.max_pending:
            return
        # pop stale heap entries (records that completed and left the cache)
        # until the top is a live pending time — amortised O(log n) vs the
        # O(n) min(self._cache) scan this replaces.  Guarded: every cached
        # time is heappushed in put(), so the heap always holds a superset
        # of the cached times and this loop cannot run dry.  If that
        # invariant is ever broken by future code (a direct _cache insert,
        # an exception between the two writes), the cheap length check
        # below catches it BEST-EFFORT (stale heap entries can mask
        # missing ones) and rebuilds the heap from the cache — restoring
        # oldest-first eviction in the detected cases and, above all,
        # guaranteeing heappop never raises IndexError mid-funnel.  An
        # exact set-comparison guard would detect every break but cost
        # O(n) per eviction, which is the scan this heap exists to avoid.
        while True:
            if len(self._age_heap) < len(self._cache):
                self._age_heap = list(self._cache)
                heapq.heapify(self._age_heap)
            oldest = heapq.heappop(self._age_heap)
            if oldest in self._cache:
                break
        self._cache.pop(oldest)
        self.n_evicted += 1
        self._c_evicted.inc()
        self._warn_eviction()

    def _warn_eviction(self, now: Optional[float] = None) -> bool:
        """Rate-limited eviction WARN (at most one per
        :data:`EVICT_WARN_EVERY_S`, with a suppressed-count suffix —
        the PacingMonitor pattern).  ``now`` is injectable for tests;
        returns True when it warned."""
        if now is None:
            now = _time.monotonic()
        if self._last_evict_warn is not None and \
                now - self._last_evict_warn < EVICT_WARN_EVERY_S:
            self._evict_warns_suppressed += 1
            return False
        suffix = ""
        if self._evict_warns_suppressed:
            suffix = (f" ({self._evict_warns_suppressed} similar warnings "
                      f"suppressed in the last {EVICT_WARN_EVERY_S:.0f} s)")
        self._last_evict_warn = now
        self._evict_warns_suppressed = 0
        logger.warning(
            "funnel cache exceeded %d pending records; evicted %d "
            "incomplete (one input stream is stalled?)%s",
            self.max_pending, self.n_evicted, suffix,
        )
        return True
