"""The scenario server: a warm simulation on the card answering "what-if"
queries (own copy of the JAX package's serve/server.py).

* :class:`ScenarioEngine`, the warm executor: one reduce-mode
  :class:`~tmhpvsim_torch.engine.simulation.Simulation` whose chain state
  and per-block host inputs are computed once and reused by every query.
  ``run()`` answers a batch through one dispatch chain of K10 launches
  (``Simulation.scenario_step``) over the blocks its longest horizon
  needs; each block's FleetAcc delta is merged into a run total on the
  card, and both are read once when the batch retires.
* :class:`RollingSession`, the device side of continuous batching: one
  fixed-width accumulator whose rows are re-initialised (a masked
  ``torch.where`` against a pristine accumulator) as requests are
  admitted, and whose slots retire one by one.
* :class:`ScenarioServer`, the asyncio front: subscribes the request
  exchange, validates (serve/schema.py), rejects duplicates and overload
  with typed errors, coalesces through a batcher (serve/batcher.py),
  publishes each reply to its request's ``reply_to`` exchange and records
  the SLO metrics.  SIGINT / SIGTERM start a drain.
* :class:`ScenarioClient`: request/reply correlation by request id over
  one reply-exchange subscription.

:func:`serve_main` runs one server behind ``python -m tmhpvsim_torch
serve``.  Not ported yet: the fleet tier and router, tenant quotas, the
compile cache, tracing and the run report.

Row ``i`` of a batch is bit-identical to a batch-of-1 run of scenario
``i``: every row applies its own elementwise transform to the same
per-second meter and pv (csrc/block_step.cu, K10), padding rows
(``horizon_s = 0``) fold nothing, and a row's totals are merged
elementwise.  Replies therefore do not depend on the company a request
had, and the window and continuous batchers give the same bytes.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import datetime as _dt
import logging
import signal
import uuid
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tmhpvsim_torch.config import SimConfig
from tmhpvsim_torch.obs import analytics as flt
from tmhpvsim_torch.obs import metrics as obs_metrics
from tmhpvsim_torch.runtime.broker import make_transport
from tmhpvsim_torch.runtime.resilience import (CircuitBreaker,
                                               ResiliencePolicy, forever)
from tmhpvsim_torch.serve import schema
from tmhpvsim_torch.serve.batcher import ContinuousBatcher, MicroBatcher
from tmhpvsim_torch.serve.schema import Request, RequestError

logger = logging.getLogger(__name__)

#: completed request ids remembered for duplicate rejection (an LRU)
RECENT_IDS_CAP = 4096


def _now() -> _dt.datetime:
    """Naive UTC wall time (the transports' timestamp convention)."""
    return _dt.datetime.now(_dt.timezone.utc).replace(tzinfo=None)


def default_buckets(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to ``max_batch``, plus ``max_batch`` itself: a
    partial batch pads to the next bucket."""
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(int(max_batch))
    return tuple(out)


@dataclasses.dataclass
class ServeConfig:
    """One server: the simulation it answers from and the serving knobs.

    ``sim.duration_s`` is the longest horizon a request may ask for;
    ``device`` is where the engine runs (None: the card; "cpu" runs the
    plain versions)."""

    sim: SimConfig
    url: str = "local://default"
    exchange: str = "scenario"
    #: the first pending request waits at most this long for company
    window_s: float = 0.010
    max_batch: int = 16
    #: explicit batch buckets; () -> ``default_buckets(max_batch)``
    batch_sizes: Tuple[int, ...] = ()
    #: pending requests beyond this are rejected ``busy``
    queue_limit: int = 1024
    #: per-request wall clock before a typed ``timeout`` reply
    timeout_s: float = 60.0
    #: drain deadline: past it queued requests get ``draining`` replies
    drain_timeout_s: float = 30.0
    recent_ids_cap: int = RECENT_IDS_CAP
    #: consecutive dispatch failures that open the circuit breaker
    breaker_threshold: int = 5
    breaker_reset_s: float = 30.0
    #: ``"window"`` (every row of a dispatch retires together) or
    #: ``"continuous"`` (block-granular rolling dispatch with backfill)
    batching: str = "window"
    #: continuous: dispatches the oldest row's cursor may be skipped
    #: before it is forced
    starve_limit: int = 4
    device: Optional[str] = None

    def buckets(self) -> Tuple[int, ...]:
        bs = tuple(sorted({int(b) for b in self.batch_sizes})) \
            if self.batch_sizes else default_buckets(self.max_batch)
        if any(b < 1 for b in bs):
            raise ValueError(f"batch_sizes {bs} must all be >= 1")
        return bs


def _fresh(state: dict) -> dict:
    """A state whose renewal carry the next block may update in place
    (the kernels write it; every other leaf is only read)."""
    return dict(state, carry={k: v.clone() for k, v in
                              state["carry"].items()})


def _host(tree: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in tree.items()}


class ScenarioEngine:
    """The warm scenario executor (see the module docstring).

    Thread contract: construct anywhere, then call ``run()`` (and the
    rolling session's methods) from one thread at a time (the batcher's
    dispatch worker)."""

    def __init__(self, sim_config: SimConfig, batch_sizes: Sequence[int],
                 device=None):
        from tmhpvsim_torch.engine.simulation import Simulation

        self.buckets = tuple(sorted({int(b) for b in batch_sizes}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"batch sizes {batch_sizes} must be >= 1")
        cfg = dataclasses.replace(sim_config, output="reduce",
                                  serve_batch_sizes=self.buckets)
        self.sim = Simulation(cfg, device=device)
        self.device = self.sim.device
        self.max_horizon_s = cfg.duration_s
        self.params = self.sim.scenario_fleet_params()
        # site selectors: a site index needs distinct sites (a grid or a
        # fleet), a cohort a fleet with two or more cohorts
        rcfg = self.sim.config
        fp = rcfg.fleet
        self.n_sites = (rcfg.n_chains
                        if (rcfg.site_grid is not None or fp is not None)
                        else None)
        self.n_cohorts = (fp.n_cohorts
                          if fp is not None and fp.n_cohorts > 1 else 0)
        self._state0 = self.sim.init_state()
        #: every block's host inputs, on the device, computed once
        self._inputs = [self.sim.host_inputs(bi)
                        for bi in range(self.sim.n_blocks)]
        #: chain state at each block boundary, cached as continuous
        #: batching reaches it (see :meth:`block_state`)
        self._block_states = {0: self._state0}

    def block_state(self, bi: int):
        """Chain state at the start of block ``bi``.  The chain state does
        not depend on the scenarios (the knobs only enter the fold), so a
        state computed once serves every request; the cache fills in
        dispatch order, so a resident row's cursor always finds its
        state."""
        return self._block_states[bi]

    def store_block_state(self, bi: int, state) -> None:
        """Cache the state a dispatch produced (no-op when known)."""
        if bi < self.sim.n_blocks and bi not in self._block_states:
            self._block_states[bi] = state

    def blocks_for(self, horizon_s: int) -> int:
        """Blocks a horizon needs."""
        return min(self.sim.n_blocks,
                   -(-int(horizon_s) // self.sim.config.block_s))

    def init_total(self, batch: int) -> dict:
        """The neutral FleetAcc run total of ``batch`` rows (int64 counts,
        float32 extrema): merging a row's deltas into it gives the bits
        merging them from nothing gives."""
        zero = flt.init_acc("risk", params=self.params, device=self.device)
        return flt.merge(None, {k: v.expand(batch, *v.shape).contiguous()
                                for k, v in zero.items()})

    def open_rolling(self, bucket: Optional[int] = None
                     ) -> "RollingSession":
        """The continuous-batching slot protocol over this engine (bucket:
        the largest by default)."""
        return RollingSession(
            self, max(self.buckets) if bucket is None else bucket)

    def run(self, requests: Sequence[Request]) -> List[dict]:
        """Answer a batch: one dispatch chain over the blocks the batch's
        longest horizon needs, padded to a bucket."""
        scenarios = [r.scenario for r in requests]
        bucket = schema.pick_bucket(len(scenarios), self.buckets)
        scen = schema.encode_batch(scenarios, bucket, device=self.device)
        n_blocks = self.blocks_for(max(s.horizon_s for s in scenarios))
        state = _fresh(self._state0)
        acc = self.sim.init_scenario_acc(bucket)
        total = self.init_total(bucket)
        for bi in range(n_blocks):
            state, acc, fdelta = self.sim.scenario_step(
                state, self._inputs[bi], acc, scen)
            total = flt.merge(total, fdelta)
        acc_h, tot_h = _host(acc), _host(total)
        return [self._format(req, {k: v[i] for k, v in acc_h.items()},
                             {k: v[i] for k, v in tot_h.items()})
                for i, req in enumerate(requests)]

    def _format(self, req: Request, row: dict, total: dict) -> dict:
        """One request's result (plain JSON-safe python): fixed-order
        numpy float64 reductions of the row's bits, so equal scenarios
        give equal bytes."""
        h = int(req.scenario.horizon_s)

        def sel(out):
            if req.scenario.site_index >= 0:
                out["site_index"] = int(req.scenario.site_index)
            if req.scenario.cohort >= 0:
                out["cohort"] = int(req.scenario.cohort)
            return out

        if req.mode == "fleet":
            return sel({"mode": "fleet", "horizon_s": h,
                        "fleet": flt.summarize(total, self.params)})
        if req.mode == "quantiles":
            fleet = flt.summarize(total, self.params)
            return sel({"mode": "quantiles", "horizon_s": h,
                        "count": fleet["count"],
                        "residual": fleet["residual"]})
        ns = int(row["n_seconds"].sum())

        def tot(name):
            return float(row[name].astype(np.float64).sum())

        return sel({"mode": "reduce", "horizon_s": h, "stats": {
            "n_seconds": ns,
            "pv_sum_w": tot("pv_sum"),
            "meter_sum_w": tot("meter_sum"),
            "residual_sum_w": tot("residual_sum"),
            "pv_max_w": float(row["pv_max"].max()),
            "residual_min_w": float(row["residual_min"].min()),
            "residual_max_w": float(row["residual_max"].max()),
        }})


class RollingSession:
    """Device-side slot protocol of continuous batching (the scheduler is
    :class:`~tmhpvsim_torch.serve.batcher.ContinuousBatcher`).

    One ``bucket``-wide accumulator rolls on; each resident request owns
    a slot, and each dispatch folds one block index for the slots
    scheduled at that cursor.  Rows not scheduled ride along with
    ``horizon_s = 0`` and fold nothing; scheduled rows carry their true
    horizon against the cached chain state of their own block, so they
    fold exactly what a serial batch-of-1 run folds in that block; an
    admitted slot's accumulator and run-total rows are reset by a masked
    ``torch.where`` against pristine copies, equal to fresh ones.

    Thread contract: every method runs on the batcher's dispatch thread.
    """

    def __init__(self, engine: ScenarioEngine, bucket: int):
        self.engine = engine
        self.bucket = int(bucket)
        self._cols = schema.scenario_columns([], self.bucket)
        self._horizons = np.zeros(self.bucket, np.int32)
        self._reqs: List[Optional[Request]] = [None] * self.bucket
        #: pristine accumulator and run total: the masked row reset
        #: selects from them
        self._acc0 = engine.sim.init_scenario_acc(self.bucket)
        self._total0 = engine.init_total(self.bucket)
        self.acc = {k: v.clone() for k, v in self._acc0.items()}
        self.total = {k: v.clone() for k, v in self._total0.items()}

    def blocks_for(self, request: Request) -> int:
        """Blocks this request's horizon needs (its retirement cursor)."""
        return self.engine.blocks_for(request.scenario.horizon_s)

    def admit_rows(self, items: Sequence[Tuple[int, Request]]) -> None:
        """Bind requests to free slots: write their knob columns and
        reset exactly their accumulator and total rows on the device."""
        mask = np.zeros(self.bucket, bool)
        for slot, req in items:
            row = schema.scenario_columns([req.scenario], 1)
            for k, v in row.items():
                self._cols[k][slot] = v[0]
            self._horizons[slot] = req.scenario.horizon_s
            self._reqs[slot] = req
            mask[slot] = True
        m = torch.from_numpy(mask).to(self.engine.device)

        def reset(tree, pristine):
            return {k: torch.where(m.view(-1, *(1,) * (v.dim() - 1)),
                                   pristine[k], v) for k, v in tree.items()}

        self.acc = reset(self.acc, self._acc0)
        self.total = reset(self.total, self._total0)

    def step_finish(self, bi: int, sched: Sequence[int],
                    retiring: Sequence[int]) -> dict:
        """One dispatch of block ``bi`` for the slots in ``sched``; returns
        ``{slot: result}`` for the slots in ``retiring`` (their horizon
        completes with this block)."""
        e = self.engine
        cols = dict(self._cols)
        # the dispatch's horizon column is the schedule: scheduled rows
        # fold their true horizon's share of the block, the others are
        # padding this round
        h = np.zeros(self.bucket, np.int32)
        for sl in sched:
            h[sl] = self._horizons[sl]
        cols["horizon_s"] = h
        scen = schema.to_device(cols, device=e.device)
        state, self.acc, fdelta = e.sim.scenario_step(
            _fresh(e.block_state(bi)), e._inputs[bi], self.acc, scen)
        e.store_block_state(bi + 1, state)
        # a padding row's delta is the merge's identity
        self.total = flt.merge(self.total, fdelta)
        out = {}
        if retiring:
            acc_h, tot_h = _host(self.acc), _host(self.total)
            for sl in retiring:
                out[sl] = e._format(
                    self._reqs[sl], {k: v[sl] for k, v in acc_h.items()},
                    {k: v[sl] for k, v in tot_h.items()})
                self._release(sl)
        return out

    def _release(self, slot: int) -> None:
        pad = schema.scenario_columns([], 1)
        for k, v in pad.items():
            self._cols[k][slot] = v[0]
        self._horizons[slot] = 0
        self._reqs[slot] = None

    def recover(self) -> None:
        """After a failed dispatch (the accumulator may be half-updated):
        a fresh accumulator and total, every slot back to padding."""
        self.acc = {k: v.clone() for k, v in self._acc0.items()}
        self.total = {k: v.clone() for k, v in self._total0.items()}
        for slot in range(self.bucket):
            self._release(slot)


class ScenarioServer:
    """The asyncio serving front (see the module docstring)."""

    def __init__(self, cfg: ServeConfig, *, registry=None):
        self.cfg = cfg
        self.registry = registry or obs_metrics.get_registry()
        self.engine: Optional[ScenarioEngine] = None
        self.batcher = None
        self._req_tx = None
        self._reply_tx: dict = {}
        self._consume_task: Optional[asyncio.Task] = None
        self._tasks: set = set()
        self._inflight_ids: set = set()
        self._recent_ids: OrderedDict = OrderedDict()
        self._draining = False
        self._stopped = False
        self._drain_event: Optional[asyncio.Event] = None
        reg = self.registry
        self._c_requests = reg.counter("serve.requests_total")
        self._c_replies = reg.counter("serve.replies_total")
        self._c_rejected = reg.counter("serve.rejected_total")
        self._c_timeouts = reg.counter("serve.timeouts_total")
        self._c_replay_evict = reg.counter("serve.replay_evictions_total")
        self._g_inflight = reg.gauge("serve.in_flight")
        self._h_reply = reg.histogram("serve.reply_latency_s")
        #: reconnect and resubscribe the request subscription
        self._consume_policy = ResiliencePolicy(
            attempts=forever, base_delay_s=0.1, max_delay_s=2.0,
            name="serve.consume", registry=reg)
        #: bounded retries of reply publishes
        self._reply_policy = ResiliencePolicy(
            attempts=5, base_delay_s=0.05, max_delay_s=0.5,
            name="serve.publish_reply", registry=reg)

    @property
    def draining(self) -> bool:
        return self._draining

    async def start(self) -> None:
        """Build the warm engine, open the request subscription, start
        the batcher."""
        if self.cfg.batching not in ("window", "continuous"):
            raise ValueError(
                f"batching {self.cfg.batching!r} not one of "
                "'window', 'continuous'")
        self._drain_event = asyncio.Event()
        with obs_metrics.use_registry(self.registry):
            self.engine = ScenarioEngine(self.cfg.sim, self.cfg.buckets(),
                                         device=self.cfg.device)
            breaker = CircuitBreaker(
                "serve.dispatch",
                failure_threshold=self.cfg.breaker_threshold,
                reset_s=self.cfg.breaker_reset_s,
                registry=self.registry)
            if self.cfg.batching == "continuous":
                self.batcher = ContinuousBatcher(
                    self.engine.open_rolling(),
                    window_s=self.cfg.window_s,
                    queue_limit=self.cfg.queue_limit,
                    registry=self.registry, breaker=breaker,
                    starve_limit=self.cfg.starve_limit)
            else:
                self.batcher = MicroBatcher(
                    self.engine.run, window_s=self.cfg.window_s,
                    max_batch=max(self.engine.buckets),
                    queue_limit=self.cfg.queue_limit,
                    registry=self.registry, breaker=breaker)
            self.batcher.start()
            self._req_tx = make_transport(self.cfg.url, self.cfg.exchange)
            await self._req_tx.__aenter__()
        self._consume_task = asyncio.create_task(self._consume())
        logger.info(
            "scenario server listening on %s exchange %r (buckets %s, "
            "window %.0f ms, max horizon %d s, %s batching, device %s)",
            self.cfg.url, self.cfg.exchange, list(self.engine.buckets),
            self.cfg.window_s * 1e3, self.engine.max_horizon_s,
            self.cfg.batching, self.engine.device)

    def install_signal_handlers(self) -> None:
        """SIGINT / SIGTERM -> begin draining."""
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            with contextlib.suppress(NotImplementedError):
                loop.add_signal_handler(sig, self.begin_drain)

    def begin_drain(self) -> None:
        """Stop accepting work: new requests get typed ``draining``
        replies; in-flight requests complete."""
        if not self._draining:
            logger.info("scenario server draining: rejecting new "
                        "requests, completing %d in flight",
                        len(self._inflight_ids))
        self._draining = True
        if self._drain_event is not None:
            self._drain_event.set()

    async def serve_forever(self) -> None:
        """Run until the drain starts, then stop cleanly."""
        await self._drain_event.wait()
        await self.stop()

    async def stop(self) -> None:
        """Drain and shut down (idempotent): queued batches run, replies
        publish, then the transports close."""
        if self._stopped:
            return
        self._stopped = True
        self._draining = True
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.cfg.drain_timeout_s
        if self.batcher is not None:
            await self.batcher.stop(drain=True,
                                    timeout=self.cfg.drain_timeout_s)
        if self._tasks:
            done, pending = await asyncio.wait(
                self._tasks, timeout=max(1.0, deadline - loop.time()))
            for t in pending:
                t.cancel()
            if pending:
                await asyncio.wait(pending, timeout=1.0)
        if self._consume_task is not None:
            self._consume_task.cancel()
            with contextlib.suppress(asyncio.CancelledError,
                                     ConnectionError):
                await self._consume_task
        for tx in [self._req_tx, *self._reply_tx.values()]:
            if tx is not None:
                with contextlib.suppress(Exception):
                    await tx.__aexit__(None, None, None)
        self._reply_tx.clear()

    # ------------------------------------------------------------------
    # request path
    # ------------------------------------------------------------------

    async def _consume(self) -> None:
        async def run():
            if self._req_tx is None:
                tx = make_transport(self.cfg.url, self.cfg.exchange)
                await tx.__aenter__()
                self._req_tx = tx
            try:
                async for _t, _v, meta in self._req_tx.subscribe(
                        with_meta=True):
                    self._handle(meta)
            except BaseException:
                tx, self._req_tx = self._req_tx, None
                if tx is not None:
                    with contextlib.suppress(Exception):
                        await tx.__aexit__(None, None, None)
                raise

        await self._consume_policy.call(run)

    def _handle(self, meta) -> None:
        # other traffic on a shared exchange is not ours to judge
        if not isinstance(meta, dict) or \
                meta.get("op") != schema.OP_REQUEST:
            return
        self._c_requests.inc()
        t_recv = asyncio.get_running_loop().time()
        rid = meta.get("id") if isinstance(meta.get("id"), str) else None
        reply_to = meta.get("reply_to") \
            if isinstance(meta.get("reply_to"), str) else None
        try:
            if self._draining:
                raise RequestError("draining",
                                   "server is draining; retry elsewhere")
            req = schema.parse_request(
                meta, max_horizon_s=self.engine.max_horizon_s,
                n_sites=self.engine.n_sites,
                n_cohorts=self.engine.n_cohorts)
            if req.id in self._inflight_ids or \
                    req.id in self._recent_ids:
                if req.id in self._recent_ids:
                    self._recent_ids.move_to_end(req.id)
                raise RequestError(
                    "duplicate", f"request id {req.id!r} already seen")
        except RequestError as err:
            tid = meta.get("trace_id")
            self._reject(reply_to, rid, err,
                         trace_id=tid if isinstance(tid, str) else None)
            return
        self._inflight_ids.add(req.id)
        self._g_inflight.set(len(self._inflight_ids))
        task = asyncio.create_task(self._respond(req, t_recv))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    def _reject(self, reply_to: Optional[str], rid: Optional[str],
                err: RequestError, trace_id: Optional[str] = None) -> None:
        self._c_rejected.inc()
        logger.warning("scenario request rejected (%s): %s", err.code, err)
        if reply_to:
            task = asyncio.create_task(self._publish_reply(
                reply_to, schema.error_meta(
                    rid, err.code, str(err), trace_id=trace_id,
                    retry_after_ms=err.retry_after_ms)))
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)

    async def _respond(self, req: Request, t_recv: float) -> None:
        loop = asyncio.get_running_loop()
        try:
            try:
                fut = self.batcher.submit(req)
                result, info = await asyncio.wait_for(
                    fut, timeout=self.cfg.timeout_s)
            except asyncio.TimeoutError:
                self._c_timeouts.inc()
                await self._publish_reply(req.reply_to, schema.error_meta(
                    req.id, "timeout",
                    f"no result within {self.cfg.timeout_s:g} s",
                    trace_id=req.trace_id))
                return
            except RequestError as err:
                self._c_rejected.inc()
                await self._publish_reply(req.reply_to, schema.error_meta(
                    req.id, err.code, str(err), trace_id=req.trace_id,
                    retry_after_ms=err.retry_after_ms))
                return
            except Exception as err:  # an engine bug: reply, do not wedge
                logger.exception("scenario request %s failed", req.id)
                await self._publish_reply(req.reply_to, schema.error_meta(
                    req.id, "internal", f"{type(err).__name__}: {err}",
                    trace_id=req.trace_id))
                return
            latency = loop.time() - t_recv
            await self._publish_reply(req.reply_to, schema.ok_meta(
                req.id, req.mode, result,
                timings={**info, "reply_latency_s": latency},
                trace_id=req.trace_id))
            self._c_replies.inc()
            self._h_reply.observe(latency)
        finally:
            self._inflight_ids.discard(req.id)
            self._recent_ids[req.id] = None
            while len(self._recent_ids) > self.cfg.recent_ids_cap:
                self._recent_ids.popitem(last=False)
                self._c_replay_evict.inc()
            self._g_inflight.set(len(self._inflight_ids))

    async def _publish_reply(self, exchange: str, meta: dict) -> None:
        """Publish on a per-``reply_to`` transport (cached), retried under
        the reply policy."""

        async def attempt():
            tx = self._reply_tx.get(exchange)
            if tx is None:
                tx = make_transport(self.cfg.url, exchange)
                await tx.__aenter__()
                self._reply_tx[exchange] = tx
            try:
                await tx.publish(0.0, _now(), meta=meta)
            except BaseException:
                self._reply_tx.pop(exchange, None)
                with contextlib.suppress(Exception):
                    await tx.__aexit__(None, None, None)
                raise

        await self._reply_policy.call(attempt)


class ScenarioClient:
    """Request/reply correlation: one reply exchange per client, one
    subscription, replies resolved by ``id`` (out-of-order replies, and
    other clients' replies on a shared reply exchange, route correctly).
    """

    def __init__(self, url: str, exchange: str = "scenario",
                 reply_to: Optional[str] = None):
        self._url = url
        self._exchange = exchange
        self.reply_to = reply_to or \
            f"scenario.reply.{uuid.uuid4().hex[:12]}"
        self._pending: dict = {}
        self._req_tx = None
        self._rep_tx = None
        self._task: Optional[asyncio.Task] = None
        self._consume_policy = ResiliencePolicy(
            attempts=forever, base_delay_s=0.1, max_delay_s=2.0,
            name="ScenarioClient.consume")

    async def __aenter__(self):
        self._req_tx = make_transport(self._url, self._exchange)
        await self._req_tx.__aenter__()
        self._rep_tx = make_transport(self._url, self.reply_to)
        await self._rep_tx.__aenter__()
        self._task = asyncio.create_task(self._consume())
        # the fanout exchange delivers only to bound subscribers
        await asyncio.sleep(0.05)
        return self

    async def __aexit__(self, *exc):
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError,
                                     ConnectionError):
                await self._task
        for tx in (self._rep_tx, self._req_tx):
            if tx is not None:
                with contextlib.suppress(Exception):
                    await tx.__aexit__(None, None, None)
        return False

    async def _consume(self) -> None:
        async def run():
            if self._rep_tx is None:
                tx = make_transport(self._url, self.reply_to)
                await tx.__aenter__()
                self._rep_tx = tx
            try:
                async for _t, _v, meta in \
                        self._rep_tx.subscribe(with_meta=True):
                    if not isinstance(meta, dict) or \
                            meta.get("op") != schema.OP_REPLY:
                        continue
                    fut = self._pending.pop(meta.get("id"), None)
                    if fut is not None and not fut.done():
                        fut.set_result(meta)
            except BaseException:
                tx, self._rep_tx = self._rep_tx, None
                if tx is not None:
                    with contextlib.suppress(Exception):
                        await tx.__aexit__(None, None, None)
                raise

        await self._consume_policy.call(run)

    async def request(self, scenario: Optional[dict] = None,
                      mode: str = "reduce", rid: Optional[str] = None,
                      timeout: float = 60.0) -> dict:
        """One scenario query -> the reply meta (``ok`` true or false:
        typed errors come back as values)."""
        rid = rid or uuid.uuid4().hex[:16]
        fut = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        meta = schema.request_meta(rid, self.reply_to, mode, scenario)
        try:
            await self._req_tx.publish(0.0, _now(), meta=meta)
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._pending.pop(rid, None)


async def serve_main(cfg: ServeConfig, *,
                     install_signals: bool = True) -> None:
    """One :class:`ScenarioServer` lifetime under its own metrics
    registry: start, serve until SIGINT / SIGTERM, drain."""
    registry = obs_metrics.MetricsRegistry()
    server = ScenarioServer(cfg, registry=registry)
    with obs_metrics.use_registry(registry):
        try:
            await server.start()
            if install_signals:
                server.install_signal_handlers()
            await server.serve_forever()
        finally:
            with contextlib.suppress(Exception):
                await server.stop()
