"""Request batchers: coalesce concurrent scenario requests into fused
dispatches (own copy of the JAX package's serve/batcher.py, without its
fault-injection hook and its trace spans).

Two schedulers share one submit/stop front (:class:`_BatcherCore`):

* :class:`MicroBatcher`, the window protocol.  The first pending request
  opens a window; the batch dispatches when ``window_s`` elapses or
  ``max_batch`` requests are pending, whichever comes first.  Every row
  of a dispatch retires together, after the blocks of the batch's
  longest horizon.
* :class:`ContinuousBatcher`, rolling batching.  Requests occupy slots
  of one fixed-width device batch; each fused dispatch advances one block
  index for the resident rows at that cursor, rows retire as soon as
  their own horizon's blocks are folded, and freed slots are backfilled
  from the queue into the next dispatch.  Rows not scheduled in a
  dispatch ride along as ``horizon_s = 0`` padding, which folds nothing,
  so replies stay bit-identical to batch-of-1 runs.  The device side is
  ``serve.server.RollingSession``.

The dispatch callable runs in a single worker thread: one dispatch is in
flight at a time (one card), while the event loop keeps accepting and
rejecting traffic.  Typed ``busy`` / ``unavailable`` rejections carry a
``retry_after_ms`` hint from the window, the queue depth and the
dispatch time (or the breaker's remaining reset time).

A failed continuous dispatch leaves the shared accumulator undefined:
the session recovers a fresh one *before* the resident rows' futures
fail, so a caller that sees its typed ``internal`` error finds the
session already recovered.  (The JAX package fails the futures first
and recovers afterwards on the worker thread, which races with callers
that look at the session when their error arrives.)

SLO metrics (``serve.*``): ``queue_wait_s`` / ``dispatch_s`` histograms,
a ``batch_occupancy`` histogram on count buckets plus a last-batch
gauge, and ``batches_total``; the continuous scheduler adds
``serve.backfilled_total`` and a ``serve.resident_rows`` gauge.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import dataclasses
import logging
from typing import Callable, Dict, List, Optional, Sequence

from tmhpvsim_torch.obs import metrics as obs_metrics
from tmhpvsim_torch.runtime.resilience import CircuitBreaker
from tmhpvsim_torch.serve.schema import Request, RequestError

log = logging.getLogger(__name__)

#: occupancy histogram buckets — request counts, not seconds
OCCUPANCY_BUCKETS = (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0,
                     32.0, 48.0, 64.0)

#: dispatches the continuous scheduler may skip the oldest resident
#: row's cursor before it is forced (anti-starvation)
STARVE_LIMIT = 4

#: ceiling on retry_after hints — past this the client should treat the
#: server as down, not slow
MAX_RETRY_AFTER_MS = 60_000


@dataclasses.dataclass
class _Pending:
    request: Request
    future: asyncio.Future
    t_enq: float  # loop.time() at submit


class _BatcherCore:
    """Shared submit/stop front of both schedulers (see module
    docstring).  ``capacity`` is the per-dispatch row budget the
    retry_after arithmetic divides the queue by."""

    _STOP = object()

    def __init__(self, *, window_s: float, capacity: int,
                 queue_limit: int = 1024, registry=None,
                 breaker: Optional[CircuitBreaker] = None):
        if capacity < 1:
            raise ValueError(f"batch capacity {capacity} must be >= 1")
        self._window_s = float(window_s)
        self._capacity = int(capacity)
        #: dispatch circuit breaker: consecutive dispatch failures open
        #: it and submit sheds with typed ``unavailable`` until a probe
        #: batch succeeds (None = never shed)
        self.breaker = breaker
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=queue_limit)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-dispatch")
        self._task: Optional[asyncio.Task] = None
        self._closed = False
        #: EWMA of fused-dispatch device seconds (retry_after input)
        self._ewma_dispatch_s: Optional[float] = None
        reg = registry or obs_metrics.get_registry()
        self._c_batches = reg.counter("serve.batches_total")
        self._h_wait = reg.histogram("serve.queue_wait_s")
        self._h_dispatch = reg.histogram("serve.dispatch_s")
        self._h_occupancy = reg.histogram("serve.batch_occupancy",
                                          buckets=OCCUPANCY_BUCKETS)
        self._g_occupancy = reg.gauge("serve.last_batch_occupancy")

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    def retry_after_ms(self) -> int:
        """The honest backoff hint for a shedding rejection: how long
        until the queue ahead of a new request has likely dispatched
        (batches ahead x (window + EWMA dispatch)), or the breaker's
        remaining reset when it is open."""
        if self.breaker is not None and self.breaker.state == "open":
            ms = int(self.breaker.reset_remaining_s() * 1000.0)
            return max(1, min(MAX_RETRY_AFTER_MS, ms))
        per_batch = self._window_s + (self._ewma_dispatch_s
                                      if self._ewma_dispatch_s is not None
                                      else self._window_s)
        batches_ahead = -(-(self._queue.qsize() + 1) // self._capacity)
        ms = int(batches_ahead * per_batch * 1000.0)
        return max(1, min(MAX_RETRY_AFTER_MS, ms))

    def _note_dispatch(self, dispatch_s: float) -> None:
        e = self._ewma_dispatch_s
        self._ewma_dispatch_s = (dispatch_s if e is None
                                 else 0.2 * dispatch_s + 0.8 * e)

    def submit(self, request: Request) -> asyncio.Future:
        """Enqueue one request; the returned future resolves with its
        result.  Raises a typed ``busy`` rejection when the pending
        queue is full and ``draining`` once the batcher is stopping."""
        if self._closed:
            raise RequestError("draining", "batcher is stopping")
        if self.breaker is not None and self.breaker.state == "open":
            # shed while open; once half-open, requests flow again and
            # the next batch is the probe that closes or re-opens it
            self.breaker.count_rejected()
            raise RequestError(
                "unavailable",
                "dispatch circuit breaker is open; retry with backoff",
                retry_after_ms=self.retry_after_ms())
        loop = asyncio.get_running_loop()
        pending = _Pending(request, loop.create_future(), loop.time())
        try:
            self._queue.put_nowait(pending)
        except asyncio.QueueFull:
            raise RequestError(
                "busy", f"pending queue full "
                f"({self._queue.maxsize} requests)",
                retry_after_ms=self.retry_after_ms()) from None
        return pending.future

    async def stop(self, drain: bool = True,
                   timeout: Optional[float] = None) -> None:
        """Stop the loop.  ``drain=True`` processes everything already
        queued first; ``drain=False`` fails queued requests with a
        typed ``draining`` error.  ``timeout`` bounds the drain: past
        the deadline the loop is force-closed and every request still
        queued fails with a typed ``draining`` rejection instead of
        hanging shutdown on a stuck dispatch."""
        self._closed = True
        if not drain:
            self._fail_queued("server shut down")
        await self._queue.put(self._STOP)
        timed_out = False
        if self._task is not None:
            try:
                if timeout is None:
                    await self._task
                else:
                    await asyncio.wait_for(
                        asyncio.shield(self._task), timeout)
            except asyncio.TimeoutError:
                timed_out = True
                log.warning(
                    "drain deadline (%.1f s) exceeded; force-closing "
                    "with typed 'draining' rejections for %d queued "
                    "request(s)", timeout, self._queue.qsize())
                self._task.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await self._task
                self._fail_queued(
                    f"drain deadline ({timeout:g} s) exceeded")
            self._task = None
        # past the deadline a dispatch may still hold the worker thread;
        # waiting would defeat the deadline (the thread parks until the
        # device call returns)
        self._pool.shutdown(wait=not timed_out)

    def _fail_queued(self, why: str) -> None:
        while True:
            try:
                p = self._queue.get_nowait()
            except asyncio.QueueEmpty:
                break
            if p is not self._STOP and not p.future.done():
                p.future.set_exception(RequestError("draining", why))

    async def _run(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError


class MicroBatcher(_BatcherCore):
    """The window scheduler (see module docstring).
    ``dispatch(requests) -> results`` is a SYNCHRONOUS callable (it
    owns the device) returning one result per request, positionally."""

    def __init__(self, dispatch: Callable[[List[Request]], Sequence],
                 *, window_s: float = 0.010, max_batch: int = 16,
                 queue_limit: int = 1024, registry=None,
                 breaker: Optional[CircuitBreaker] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch {max_batch} must be >= 1")
        super().__init__(window_s=window_s, capacity=max_batch,
                         queue_limit=queue_limit, registry=registry,
                         breaker=breaker)
        self._dispatch = dispatch
        self._max_batch = int(max_batch)

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            first = await self._queue.get()
            if first is self._STOP:
                return
            batch = [first]
            stop_after = False
            deadline = loop.time() + self._window_s
            while len(batch) < self._max_batch:
                remaining = deadline - loop.time()
                if remaining <= 0:
                    break
                try:
                    nxt = await asyncio.wait_for(self._queue.get(),
                                                 remaining)
                except asyncio.TimeoutError:
                    break
                if nxt is self._STOP:
                    stop_after = True
                    break
                batch.append(nxt)
            await self._run_batch(batch, loop)
            if stop_after:
                return

    async def _run_batch(self, batch: List[_Pending], loop) -> None:
        now = loop.time()
        waits = [now - p.t_enq for p in batch]
        for w in waits:
            self._h_wait.observe(w)
        self._h_occupancy.observe(float(len(batch)))
        self._g_occupancy.set(len(batch))
        self._c_batches.inc()
        requests = [p.request for p in batch]
        t0 = loop.time()
        try:
            results = await loop.run_in_executor(
                self._pool, self._dispatch, requests)
        except Exception as err:
            if self.breaker is not None:
                self.breaker.record_failure()
            log.exception("scenario dispatch failed (%d requests)",
                          len(batch))
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(
                        RequestError("internal",
                                     f"dispatch failed: {err}"))
            return
        if self.breaker is not None:
            self.breaker.record_success()
        dispatch_s = loop.time() - t0
        self._h_dispatch.observe(dispatch_s)
        self._note_dispatch(dispatch_s)
        if len(results) != len(batch):  # dispatch contract violation
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(RequestError(
                        "internal",
                        f"dispatch returned {len(results)} results "
                        f"for {len(batch)} requests"))
            return
        # resolve as (result, info): the server folds the per-request
        # timings into the reply's "t" section
        for p, r, w in zip(batch, results, waits):
            if not p.future.done():
                p.future.set_result((r, {
                    "batch": len(batch),
                    "queue_s": w,
                    "dispatch_s": dispatch_s,
                }))


class ContinuousBatcher(_BatcherCore):
    """The rolling scheduler (see module docstring).  ``session`` is a
    :class:`~tmhpvsim_torch.serve.server.RollingSession`: ``bucket`` slots
    wide, with synchronous ``admit_rows`` / ``step_finish`` /
    ``recover`` methods that run on the single dispatch thread.

    Scheduling policy: each iteration backfills free slots from the
    queue (non-blocking), then dispatches the block cursor shared by
    the MOST resident rows (ties prefer the cursor closest to
    retirement, so slots free sooner).  A cursor skipped
    :data:`STARVE_LIMIT` times in a row while the oldest resident row
    waits at it is forced — no horizon mix can park a row forever.
    The window only applies while the batch is EMPTY (first fill):
    waiting for company while resident rows are runnable would stall
    them for nothing.
    """

    def __init__(self, session, *, window_s: float = 0.010,
                 queue_limit: int = 1024, registry=None,
                 breaker: Optional[CircuitBreaker] = None,
                 starve_limit: int = STARVE_LIMIT):
        super().__init__(window_s=window_s, capacity=session.bucket,
                         queue_limit=queue_limit, registry=registry,
                         breaker=breaker)
        self._session = session
        self._starve_limit = int(starve_limit)
        reg = registry or obs_metrics.get_registry()
        self._c_backfilled = reg.counter("serve.backfilled_total")
        self._g_resident = reg.gauge("serve.resident_rows")

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        s = self._session
        bucket = s.bucket
        free = list(range(bucket - 1, -1, -1))
        occupied: Dict[int, _Pending] = {}
        cursors: Dict[int, int] = {}
        need: Dict[int, int] = {}
        waits: Dict[int, float] = {}
        admit_at: Dict[int, float] = {}
        closing = False
        starve = 0
        while True:
            # ---- gather admissions -------------------------------------
            pend: List[_Pending] = []
            if not occupied:
                if closing:
                    return
                first = await self._queue.get()
                if first is self._STOP:
                    return
                pend.append(first)
                # the window protocol, empty-batch case only: a lone
                # request waits at most one window for company
                deadline = loop.time() + self._window_s
                while len(pend) < bucket and not closing:
                    remaining = deadline - loop.time()
                    if remaining <= 0:
                        break
                    try:
                        nxt = await asyncio.wait_for(self._queue.get(),
                                                     remaining)
                    except asyncio.TimeoutError:
                        break
                    if nxt is self._STOP:
                        closing = True
                        break
                    pend.append(nxt)
            else:
                # rolling: backfill free slots from the queue into the
                # very next dispatch, never waiting (resident rows are
                # runnable NOW)
                while len(pend) < len(free) and not closing:
                    try:
                        nxt = self._queue.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                    if nxt is self._STOP:
                        closing = True
                        break
                    pend.append(nxt)
                if pend:
                    self._c_backfilled.inc(len(pend))
            # ---- admit into slots --------------------------------------
            admits = []
            now = loop.time()
            for p in pend:
                if p.future.done():  # abandoned while queued
                    continue
                slot = free.pop()
                occupied[slot] = p
                cursors[slot] = 0
                need[slot] = s.blocks_for(p.request)
                waits[slot] = now - p.t_enq
                admit_at[slot] = now
                self._h_wait.observe(waits[slot])
                admits.append((slot, p.request))
            if admits:
                try:
                    await loop.run_in_executor(
                        self._pool, s.admit_rows, admits)
                except Exception as err:
                    await self._fail_resident(
                        occupied, cursors, need, waits, admit_at, free,
                        err)
                    continue
            self._g_resident.set(len(occupied))
            if not occupied:
                if closing:
                    return
                continue
            # ---- pick the cursor to advance ----------------------------
            counts: Dict[int, int] = {}
            for c in cursors.values():
                counts[c] = counts.get(c, 0) + 1
            bi = max(counts, key=lambda c: (counts[c], c))
            oldest = min(occupied, key=lambda sl: admit_at[sl])
            if starve >= self._starve_limit:
                bi = cursors[oldest]
            starve = 0 if cursors[oldest] == bi else starve + 1
            sched = sorted(sl for sl, c in cursors.items() if c == bi)
            retiring = [sl for sl in sched if cursors[sl] + 1 >= need[sl]]
            # ---- fused dispatch of block ``bi`` ------------------------
            self._h_occupancy.observe(float(len(sched)))
            self._g_occupancy.set(len(sched))
            self._c_batches.inc()
            t0 = loop.time()
            try:
                results = await loop.run_in_executor(
                    self._pool, s.step_finish, bi, sched, retiring)
            except Exception as err:
                if self.breaker is not None:
                    self.breaker.record_failure()
                log.exception(
                    "continuous dispatch failed (block %d, %d rows)",
                    bi, len(sched))
                await self._fail_resident(
                    occupied, cursors, need, waits, admit_at, free, err)
                continue
            if self.breaker is not None:
                self.breaker.record_success()
            dispatch_s = loop.time() - t0
            self._h_dispatch.observe(dispatch_s)
            self._note_dispatch(dispatch_s)
            # ---- advance & retire --------------------------------------
            for sl in sched:
                cursors[sl] += 1
            for sl, result in results.items():
                p = occupied.pop(sl)
                blocks = need.pop(sl)
                cursors.pop(sl)
                w = waits.pop(sl)
                admit_at.pop(sl)
                free.append(sl)
                if not p.future.done():
                    p.future.set_result((result, {
                        "batch": len(sched),
                        "queue_s": w,
                        "dispatch_s": dispatch_s,
                        "blocks": blocks,
                    }))
            self._g_resident.set(len(occupied))

    async def _fail_resident(self, occupied, cursors, need, waits,
                             admit_at, free, err) -> None:
        """A failed fused dispatch leaves the shared accumulator
        undefined, so the session recovers a fresh one and then every
        resident row fails typed ``internal`` (recovered first: a caller
        that sees its error finds the session usable).  Queued (not yet
        admitted) requests are untouched."""
        loop = asyncio.get_running_loop()
        try:
            await loop.run_in_executor(self._pool, self._session.recover)
        except Exception:
            log.exception("continuous session recovery failed")
        for sl, p in list(occupied.items()):
            if not p.future.done():
                p.future.set_exception(
                    RequestError("internal", f"dispatch failed: {err}"))
        free.extend(sorted(occupied))
        occupied.clear()
        cursors.clear()
        need.clear()
        waits.clear()
        admit_at.clear()
        self._g_resident.set(0)
