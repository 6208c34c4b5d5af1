"""``pvsim`` on the port, in two backends.

The default (the JAX package's ``pvsim --backend jax``): a multi-chain
PV + meter simulation on the card, written as CSV in the JAX package's
file formats:

* ``trace`` (the default): one chain's per-second rows ``time, meter, pv,
  residual load`` (the reference CSV format);
* ``ensemble``: the same rows for the per-second fleet means;
* ``reduce``: per-chain summary statistics plus one fleet ``ensemble`` row.

Each runs for a shared site, a per-chain ``SiteGrid`` or a heterogeneous
fleet, in the scan or the wide formulation (``block_impl``), with any
number of blocks per dispatch; reduce mode can fold the fleet analytics.
``compute_dtype='bf16'`` runs the bf16 block step (K12) watched by the
telemetry and, in reduce mode, the drift sentinel (``telemetry``,
``telemetry_strict``).  ``run_report`` writes the run report
(obs/report.py: the JAX package's RunReport schema) with the run's
config, its resolved plan, the analytics' run totals as the ``fleet``
section, the sentinel's verdict as the ``telemetry`` section and the
``precision`` section of the levers ``compute_dtype``, ``kernel_impl``,
``rng_batch`` and ``geom_stride``.

``checkpoint`` makes a run restart-safe (engine/checkpoint.py, in the JAX
package's format, so either package resumes the other's checkpoints): the
state (and in reduce mode the accumulator) is saved after every block
into rotated, integrity-checked generations, and a rerun of the same
command resumes from the newest one that verifies.  A trace or ensemble
CSV keeps its rows exactly once: a resume truncates it to the rows of the
checkpointed blocks and refuses a missing or short one.
``preempt_grace_s > 0`` makes SIGTERM a preemption notice: the run
finishes the block in flight, drains one final snapshot, prints the
resume line and returns.

The streaming backend (``pvsim_main``, ``--backend asyncio``): three
concurrent tasks, a 1 Hz PV loop on the float64 golden model
(engine/golden.py, host code by design, as in the JAX package), a meter
consumer that subscribes to the fanout exchange with forever-reconnect,
and a CSV writer, joined through a ``SynchronizingFunnel`` keyed by
timestamp into ``time, meter, pv, residual load`` rows.  On shutdown the
number of stranded half-records is warned about.
"""

from __future__ import annotations

import asyncio
import csv
import dataclasses
import datetime as _dt
import logging
import os
import signal
import time
from collections import namedtuple
from typing import Optional
from zoneinfo import ZoneInfo

import numpy as np

from tmhpvsim_torch.config import ModelOptions, SimConfig, Site
from tmhpvsim_torch.engine import checkpoint as ckpt
from tmhpvsim_torch.engine.simulation import (REDUCE_STATS, Simulation,
                                              write_csv)
from tmhpvsim_torch.obs import metrics as obs_metrics
from tmhpvsim_torch.obs.report import (simulation_report, streaming_report,
                                       write_report)
from tmhpvsim_torch.runtime import (SynchronizingFunnel, fixedclock,
                                    reconnect_policy)
from tmhpvsim_torch.runtime.broker import make_transport

logger = logging.getLogger(__name__)


def write_reduced_csv(path: str, reduced: dict, ensemble: dict,
                      chain_start: int = 0) -> None:
    """Per-chain rows plus one fleet ``ensemble`` row; columns follow
    ``REDUCE_STATS`` (``*_sum`` columns are watt-seconds)."""
    keys = list(REDUCE_STATS)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["chain"] + keys)
        n = len(reduced[keys[0]])
        for i in range(n):
            w.writerow([chain_start + i] + [reduced[k][i] for k in keys])
        w.writerow(["ensemble"] + [ensemble[k] for k in keys])


def _paced(blk, rate: float = 1.0):
    """Re-emit a BlockResult as single-row blocks on the wall-clock grid
    (``--realtime``)."""
    t0 = time.monotonic()
    for i in range(len(blk.epoch)):
        behind = (time.monotonic() - t0) - i / rate
        if behind < 0:
            time.sleep(-behind)
        yield dataclasses.replace(
            blk, offset=blk.offset + i, epoch=blk.epoch[i:i + 1],
            meter=blk.meter[:, i:i + 1], pv=blk.pv[:, i:i + 1],
            residual=blk.residual[:, i:i + 1])


def write_run_report(path: str, sim: Simulation) -> Optional[dict]:
    """The run report of a finished run (``obs.report.simulation_report``):
    config, plan and device, the ``fleet`` section as
    ``sim.fleet_summary()`` gives it (None without analytics), the
    ``telemetry`` section as ``sim.sentinel.report()`` gives it (None when
    no block was observed) and the ``precision`` section as
    ``sim.precision_doc()`` gives it (None with the levers at their
    defaults); a sharded run adds ``mesh`` and ``processes``, and only
    its process 0 writes.  Returns the document (None on the other
    processes)."""
    doc = simulation_report("pvsim", sim)
    if sim.rank != 0:
        return None
    return write_report(path, doc)


class _PreemptStop(Exception):
    """Stops the run loop at a block boundary, the block's snapshot
    taken (a SIGTERM under ``preempt_grace_s``)."""

    def __init__(self, block: int):
        super().__init__(f"preempted after block {block}")
        self.block = block


class _PreemptWatch:
    """The preemption notice of a checkpointed run: with ``grace_s > 0``
    a SIGTERM handler that only sets a flag, read at each block's end
    (``should_stop``).  A handler can only be set in the main thread;
    elsewhere SIGTERM keeps its default.  The JAX package's watcher also
    consults the fault-injection chokepoint ``signal.preempt``, which
    waits for the port's runtime/faults.py."""

    def __init__(self, grace_s: float):
        self.grace_s = grace_s
        self._flag = False
        self._old = None
        if grace_s > 0:
            try:
                self._old = signal.signal(signal.SIGTERM, self._on_term)
            except ValueError:  # not the main thread
                self._old = None

    def _on_term(self, signum, frame):
        self._flag = True
        logger.warning("SIGTERM received; finishing the current block "
                       "and snapshotting (grace %.1f s)", self.grace_s)

    def should_stop(self) -> bool:
        return self._flag

    def restore(self) -> None:
        if self._old is not None:
            signal.signal(signal.SIGTERM, self._old)
            self._old = None


def _ckpt_teardown(writer, watch, suppress: bool = False) -> None:
    """Drain and close the async writer, then restore SIGTERM (a notice
    during the drain does not cut it); ``suppress`` (an error in flight)
    only warns when the close fails."""
    try:
        if writer is None:
            return
        if not suppress:
            writer.close()
            return
        try:
            writer.close(timeout=10.0)
        except Exception as e:
            logger.warning("async checkpoint writer close failed during "
                           "error unwind: %s", e)
    finally:
        watch.restore()


def _resume_source(checkpoint, ckpt_global, sim):
    """``(path, chain_slice)`` to resume from, or ``(None, None)``: this
    process's own checkpoint (its ``.host<rank>`` file in a sharded run;
    another process count's shards count too), else the whole-run
    checkpoint of another layout, as this process's chains."""
    if ckpt.resumable(checkpoint):
        return checkpoint, None
    if ckpt_global != checkpoint and ckpt.resumable(ckpt_global):
        return ckpt_global, sim.resume_chain_slice()
    return None, None


def _truncate_csv(path: str, keep_lines: int) -> int:
    """Cut ``path`` to its first ``keep_lines`` lines; returns the lines
    there are afterwards (0 for a missing file)."""
    if not os.path.exists(path):
        return 0
    with open(path, "r+") as f:
        n = 0
        for _ in range(keep_lines):
            if not f.readline():
                return n
            n += 1
        f.truncate(f.tell())
        return n


class _Checkpointing:
    """The checkpoints of one run (``pvsim(checkpoint=...)``): where it
    resumes, each block's save (synchronous, or handed to the async
    writer as host copies) and the preemption watch."""

    def __init__(self, sim, path: str, path_global: str):
        cfg = sim.config
        self.sim, self.path, self.path_global = sim, path, path_global
        self.reg = obs_metrics.get_registry()
        self.watch = _PreemptWatch(cfg.preempt_grace_s)
        self.writer = (ckpt.AsyncCheckpointWriter(
            path, config=cfg, keep=cfg.checkpoint_keep)
            if cfg.checkpoint_async == "on" else None)

    def resume(self):
        """``(tree, start_block)`` of the checkpoint to resume from (numpy
        in the JAX layout), or ``(None, 0)``."""
        src, rsl = _resume_source(self.path, self.path_global, self.sim)
        if src is None:
            return None, 0
        tree, start_block = ckpt.load_elastic(src, self.sim.config,
                                              chain_slice=rsl)
        logger.info("resuming from %s at block %d", src, start_block)
        self.reg.counter("resilience.resumed_total").inc()
        self.reg.gauge("resilience.resumed_block").set(start_block)
        return tree, start_block

    def after_block(self, bi: int, tree) -> None:
        """Save ``tree``, the state after block ``bi``, when the run's
        state is that block's (``state_block``: under several blocks a
        dispatch only a group's last block is), then stop the run on a
        preemption notice.  The processes of a sharded run decide
        together, at every block: a notice to any stops all after the
        same block (a process that stopped alone would leave the others
        waiting in a collective, or its shard generations apart from
        theirs), and no process runs more than a block ahead of another,
        so a kill leaves the shards' synchronous generations at most one
        block apart."""
        sim = self.sim
        if sim.state_block == bi + 1:
            tree = sim.host_local_tree(tree)
            lay = sim.checkpoint_layout()
            if self.writer is not None:
                self.writer.submit(tree, bi + 1, layout=lay)
            else:
                ckpt.save(self.path, tree, bi + 1, sim.config,
                          keep=sim.config.checkpoint_keep, layout=lay)
        if sim.any_process(self.watch.should_stop()):
            raise _PreemptStop(bi)

    def finish(self, stop: Optional[_PreemptStop] = None,
               suppress: bool = False) -> None:
        """Drain the writer and restore SIGTERM; after a preemption,
        print where the run stopped."""
        _ckpt_teardown(self.writer, self.watch, suppress=suppress)
        if stop is not None:
            self.reg.counter("checkpoint.preempt_snapshots_total").inc()
            print(f"pvsim: preempted — state through block "
                  f"{stop.block + 1}/{self.sim.n_blocks} checkpointed to "
                  f"{self.path}; rerun the same command to finish")


def pvsim(file: str, duration_s: int, n_chains: int, seed: int, start: str,
          chain: int = 0, block_s: int | None = None, realtime: bool = False,
          site_grid=None, output: str = "trace",
          output_overlap: str = "auto", device: str = "cuda", fleet=None,
          analytics: str = "off", run_report: str | None = None,
          kernel_impl: str = "auto", geom_stride: int = 0,
          block_impl: str = "auto", blocks_per_dispatch: int = 0,
          rng_batch: str = "auto", compute_dtype: str = "auto",
          telemetry: str = "off",
          telemetry_strict: bool = False,
          prng_impl: str = "threefry2x32", sharded: bool = False,
          coordinator: str | None = None, num_processes: int | None = None,
          process_id: int | None = None, checkpoint: str | None = None,
          checkpoint_keep: int = 3, checkpoint_async: str = "off",
          preempt_grace_s: float = 0.0, tune: str = "off") -> Simulation:
    """Run one simulation and write ``file``; returns the Simulation.

    A site grid or a fleet sets the chain count (one chain per site).
    ``realtime`` releases trace / ensemble rows on the 1 Hz wall-clock
    grid; reduce mode has no rows to pace and refuses it.  ``analytics``
    folds the fleet-risk sketches in reduce mode (other modes ignore it,
    as the JAX package does); ``run_report`` names the JSON their run
    totals go to.  ``kernel_impl`` ('auto' | 'exact' | 'table') and
    ``geom_stride`` (0 = auto | 1 | 30 | 60) are the precision levers;
    ``block_impl`` ('auto' | 'wide' | 'scan' | 'scan2'),
    ``blocks_per_dispatch`` (0 = auto | K) and ``rng_batch`` ('auto' |
    'scan' | 'block') the plan knobs that give the same run.
    ``compute_dtype`` ('auto' = 'f32' | 'f32' | 'bf16') the compute path;
    ``telemetry`` ('off' | 'light' | 'full', reduce mode) folds the
    numerics telemetry that the drift sentinel checks every block ('off'
    becomes 'light' under bf16), and ``telemetry_strict`` turns the
    sentinel's warnings into ``DriftError``.  ``prng_impl``
    ('threefry2x32' | 'rbg') the key implementation (rbg: K13's Philox
    bits on the card).  ``tune`` ('off' | 'auto' | 'force') resolves the
    plan through the runtime autotuner (engine/autotune.py): 'auto' takes
    the plan cache's entry for this card and shape or probes the
    candidates and stores the winner, 'force' probes even on a hit.

    ``checkpoint`` saves the run after every block and resumes it from
    there when the file exists (output overlap is then off, one block at
    a time); ``checkpoint_keep`` (>= 1) generations are kept,
    ``checkpoint_async`` ('off' | 'on') writes them on a background
    thread, and ``preempt_grace_s > 0`` turns SIGTERM into a clean stop
    after the block in flight, with its snapshot drained.

    ``sharded`` runs the chains over the processes of a
    ``torch.distributed`` group (``parallel.ShardedSimulation``), joined
    from ``coordinator``, ``num_processes`` and ``process_id`` or from a
    launcher's environment (``parallel.distributed.initialize``).  With
    more than one process each writes ``{file}.host{rank}``: reduce mode
    its own chains' rows (global chain ids) and the whole run's
    ``ensemble`` row, ensemble mode the whole run's means, and trace mode
    only the process that owns ``chain`` (the others run every block,
    paced as the owner paces them, so that every process reaches each
    block's collectives on one clock, and write nothing).  ``run_report`` is
    written by process 0, with the ``mesh`` section and every process's
    metrics snapshot (``processes``).  With more than one process each
    checkpoints its own chains to ``{checkpoint}.host{rank}``; a resume
    under another process count reslices (``checkpoint.load_elastic``)."""
    if block_s is None:
        block_s = min(8640, max(60, (duration_s // 60) * 60))
    if checkpoint and output_overlap != "off":
        # the save after block N reads the state after block N; the
        # overlap dispatches block N + 1 before N is consumed
        output_overlap = "off"
        logger.info("checkpointing disables output_overlap")
    cfg = SimConfig(start=start, duration_s=duration_s, n_chains=n_chains,
                    seed=seed, block_s=block_s, site_grid=site_grid,
                    fleet=fleet, output=output,
                    output_overlap=output_overlap, analytics=analytics,
                    kernel_impl=kernel_impl, geom_stride=geom_stride,
                    block_impl=block_impl,
                    blocks_per_dispatch=blocks_per_dispatch,
                    rng_batch=rng_batch, compute_dtype=compute_dtype,
                    telemetry=telemetry, telemetry_strict=telemetry_strict,
                    prng_impl=prng_impl, checkpoint_keep=checkpoint_keep,
                    checkpoint_async=checkpoint_async,
                    preempt_grace_s=preempt_grace_s, tune=tune)
    # the run's own metrics (the report's checkpoint section reads them)
    with obs_metrics.use_registry(obs_metrics.MetricsRegistry()):
        if not sharded:
            return _run(Simulation(cfg, device=device), file, duration_s,
                        chain, realtime, output, run_report, checkpoint,
                        checkpoint)
        from tmhpvsim_torch.parallel import ShardedSimulation, distributed

        own = distributed.initialize(coordinator, num_processes,
                                     process_id, device=device)
        try:
            sim = ShardedSimulation(cfg, device=device)
            ck_own = checkpoint
            if sim.world > 1:
                file = f"{file}.host{sim.rank}"
                if checkpoint:
                    ck_own = f"{checkpoint}.host{sim.rank}"
            return _run(sim, file, duration_s, chain, realtime, output,
                        run_report, ck_own, checkpoint)
        finally:
            if own:
                distributed.shutdown()


def _run(sim, file, duration_s, chain, realtime, output, run_report,
         checkpoint=None, ckpt_global=None):
    """The run and its CSV (and run report) of ``pvsim``; ``checkpoint``
    is this process's checkpoint, ``ckpt_global`` the whole run's path."""
    cfg = sim.config  # a site grid or a fleet sets n_chains
    sl = sim.chain_slice  # this process's chains (all but in a sharded run)
    plan = sim.plan
    logger.info(
        "plan [%s]: block_impl=%s scan_unroll=%d stats_fusion=%s "
        "slab_chains=%d blocks_per_dispatch=%d compute_dtype=%s "
        "kernel_impl=%s rng_batch=%s geom_stride=%d", plan.source,
        plan.block_impl, plan.scan_unroll, plan.stats_fusion,
        plan.slab_chains, plan.blocks_per_dispatch, plan.compute_dtype,
        plan.kernel_impl, plan.rng_batch, plan.geom_stride)
    if output == "reduce" and realtime:
        raise ValueError("reduce mode has no per-second rows to pace; "
                         "drop --realtime")
    if output == "ensemble" and chain != 0:
        raise ValueError("ensemble mode writes the fleet mean; --chain "
                         "does not apply (drop it or use trace mode)")
    if output != "reduce" and not 0 <= chain < cfg.n_chains:
        raise ValueError(f"--chain {chain} out of range for "
                         f"{cfg.n_chains} chains")
    ck = None
    if checkpoint:
        # one state for the whole run: no slabs
        sim.allow_slabs = False
        ck = _Checkpointing(sim, checkpoint, ckpt_global)
    t0 = time.perf_counter()
    try:
        if output == "reduce":
            reduced = _reduce(sim, ck)
        else:
            _rows(sim, file, chain, realtime, output, ck)
    except _PreemptStop as stop:
        ck.finish(stop)
        return sim
    except BaseException:
        if ck:
            ck.finish(suppress=True)
        raise
    if ck:
        ck.finish()
    wall = time.perf_counter() - t0
    if output == "reduce":
        ensemble = sim.ensemble_stats()
        write_reduced_csv(file, reduced, ensemble, chain_start=sl.start)
        print(f"pvsim[reduce]: {cfg.n_chains} chains x {duration_s} s on "
              f"{sim.device} in {wall:.3f} s "
              f"({cfg.n_chains * duration_s / wall:.4g} site-s/s incl. "
              f"set-up); fleet pv_max {ensemble['pv_max']:.1f} W")
    else:
        print(f"pvsim[{output}]: {cfg.n_chains} chains x {duration_s} s "
              f"on {sim.device} in {wall:.3f} s "
              f"({cfg.n_chains * duration_s / wall:.4g} site-s/s incl. "
              "set-up and CSV)")
    if run_report:
        write_run_report(run_report, sim)
    return sim


def _reduce(sim, ck) -> dict:
    """Reduce mode's run, resumed from the checkpoint and saving the
    state and the accumulator after every block when ``ck`` is given."""
    tree, start_block = ck.resume() if ck else (None, 0)
    state, acc = (tree["state"], tree["acc"]) if tree else (None, None)
    on_block = None
    if ck:
        def on_block(bi, state, acc):
            ck.after_block(bi, {"state": state, "acc": acc})
    return sim.run_reduced(state=state, acc=acc, start_block=start_block,
                           on_block=on_block)


def _rows(sim, file, chain, realtime, output, ck) -> None:
    """Trace or ensemble mode's CSV rows, exactly once across a resume
    when ``ck`` is given."""
    cfg = sim.config
    sl = sim.chain_slice
    runner = sim.run_ensemble if output == "ensemble" else sim.run_blocks
    # --chain is a chain id of the whole run: in trace mode only the
    # process that holds it writes; the others take the same (paced)
    # blocks, so they join every block's collectives when the owner does
    write_trace = output != "trace" or sl.start <= chain < sl.stop
    state, start_block = ck.resume() if ck else (None, 0)
    if start_block and write_trace:
        # a crash between a block's rows and its checkpoint leaves rows
        # past the checkpoint: cut them, and refuse to append to a
        # missing or short CSV
        expect = 1 + min(cfg.duration_s, start_block * cfg.block_s)
        got = _truncate_csv(file, expect)
        if got < expect:
            raise RuntimeError(
                f"checkpoint {ck.path} expects {expect} existing lines in "
                f"{file} but found {got}; restore the CSV that belongs to "
                "this checkpoint or delete the checkpoint to restart")

    def blocks():
        for bi, blk in enumerate(runner(state=state,
                                        start_block=start_block),
                                 start=start_block):
            if realtime:
                yield from _paced(blk)
            else:
                yield blk
            # the block's rows are written when control comes back here
            if ck:
                ck.after_block(bi, sim.state)

    if not write_trace:
        logger.info("chain %d lives on another process (this one holds "
                    "%d-%d): running without a trace", chain, sl.start,
                    sl.stop - 1)
        for _ in blocks():
            pass
    else:
        write_csv(file, blocks(),
                  chain=chain - sl.start if output == "trace" else chain,
                  tz=ZoneInfo(sim.timezone), append=start_block > 0)


# ---------------------------------------------------------------------------
# the streaming backend
# ---------------------------------------------------------------------------

#: the joined record
Data = namedtuple("Data", ["meter", "pv"])


class _StreamStats:
    """Per-message latency accounting of the streaming backend.

    ``publish -> join`` uses the publisher's monotonic stamp (``pub_us``
    in the message's meta): meaningful when producer and consumer share a
    process (local://); across hosts the clocks are unrelated and the
    value is clamped at 0.  Both pending maps are bounded, so evicted or
    never-joined timestamps cannot leak memory on an unbounded run."""

    _MAX_PENDING = 20_000

    def __init__(self, registry):
        self.h_pub_join = registry.histogram("streaming.publish_to_join_s")
        self.h_join_csv = registry.histogram("streaming.join_to_csv_s")
        self.c_rows = registry.counter("pvsim.rows_written_total")
        self._pub_us: dict = {}
        self._join_ns: dict = {}

    @staticmethod
    def _cap(d: dict, cap: int) -> None:
        while len(d) >= cap:
            d.pop(next(iter(d)))  # insertion order ~ oldest timestamp

    def on_consume(self, t, meta: Optional[dict]) -> None:
        if meta and isinstance(meta.get("pub_us"), (int, float)):
            self._cap(self._pub_us, self._MAX_PENDING)
            self._pub_us[t] = meta["pub_us"]

    def on_join(self, t) -> None:
        now_ns = time.monotonic_ns()
        pub = self._pub_us.pop(t, None)
        if pub is not None:
            self.h_pub_join.observe(max(0.0, now_ns / 1e3 - pub) / 1e6)
        self._cap(self._join_ns, self._MAX_PENDING)
        self._join_ns[t] = now_ns

    def on_row(self, t) -> None:
        j = self._join_ns.pop(t, None)
        if j is not None:
            self.h_join_csv.observe(
                max(0.0, (time.monotonic_ns() - j) / 1e9))
        self.c_rows.inc()


class _JoinFront:
    """The queue handed to the funnel in place of the writer's queue: the
    funnel puts completed records only, so ``put`` is the join-complete
    instant; stamp it and forward."""

    __slots__ = ("_queue", "_stream")

    def __init__(self, queue: asyncio.Queue, stream: _StreamStats):
        self._queue = queue
        self._stream = stream

    async def put(self, item) -> None:
        self._stream.on_join(item[0])
        await self._queue.put(item)


async def read_pv_values(funnel: SynchronizingFunnel, realtime: bool,
                         seed=None, duration_s=None,
                         start: Optional[_dt.datetime] = None) -> None:
    """The 1 Hz PV loop feeding the funnel: the float64 golden model of
    the default site, seeded from ``seed``."""
    from tmhpvsim_torch.engine.golden import GoldenPVModel

    if start is None:
        start = _dt.datetime.now()
    start = start.replace(microsecond=0)
    model = GoldenPVModel(start, Site(), ModelOptions(),
                          np.random.default_rng(seed))
    async for t in fixedclock(rate=1, realtime=realtime, start=start,
                              duration_s=duration_s):
        t = t.replace(microsecond=0)
        await funnel.put(t, pv=model.next(t))


async def read_transport(funnel: SynchronizingFunnel, url, exchange,
                         counter: Optional[dict] = None,
                         stream: Optional[_StreamStats] = None) -> None:
    """The meter consumer, reconnecting forever (jittered backoff)."""

    async def run():
        async with make_transport(url, exchange) as transport:
            async for t, value, meta in transport.subscribe(with_meta=True):
                if counter is not None:
                    counter["meter"] = counter.get("meter", 0) + 1
                if stream is not None:
                    stream.on_consume(t, meta)
                await funnel.put(t, meter=value)

    await reconnect_policy(name="pvsim.read_transport").call(run)


async def _no_meter_watchdog(counter: dict, url, timeout_s: float = 10.0):
    """Warn once when no meter message arrived within ``timeout_s``: pvsim
    points at a broker no metersim publishes to, or (local://) the pair
    runs in separate processes."""
    await asyncio.sleep(timeout_s)
    if counter.get("meter", 0) == 0:
        extra = (" local:// transports are in-process only: metersim must "
                 "run inside the same process to join."
                 if (url or "local://").startswith("local://") else "")
        logger.warning("no meter messages received after %.0f s; is "
                       "metersim publishing to this exchange?%s",
                       timeout_s, extra)


async def write_file(filename: str, queue: asyncio.Queue,
                     stream: Optional[_StreamStats] = None) -> None:
    """The CSV sink, line-buffered so that it can be followed."""
    with open(filename, mode="w", newline="", buffering=1) as file:
        writer = csv.writer(file)
        writer.writerow(["time"] + list(Data._fields) + ["residual load"])
        while True:
            t, data = await queue.get()
            writer.writerow([t] + list(data) + [data.meter - data.pv])
            if stream is not None:
                stream.on_row(t)
            queue.task_done()


async def pvsim_main(file, amqp_url, exchange, realtime, seed=None,
                     duration_s=None, start=None,
                     run_report_path: Optional[str] = None) -> None:
    """The streaming app: the PV loop, the meter consumer and the CSV
    writer, joined by a funnel with a 60-second lookahead (under
    ``--no-realtime`` the local PV loop would otherwise race ahead of the
    broker-paced meter stream and every pv-only record would be evicted
    before its meter value arrives).  A bounded run (``duration_s``) ends
    when the PV loop is done and the joined rows are written.
    ``run_report_path`` writes a run report of app ``pvsim.stream`` whose
    ``streaming`` section carries the publish -> join and join -> csv
    latencies and the funnel, retry and broker counters."""
    reg = obs_metrics.get_registry()
    stream = _StreamStats(reg) if run_report_path else None
    queue: asyncio.Queue = asyncio.Queue()
    front = _JoinFront(queue, stream) if stream is not None else queue
    funnel = SynchronizingFunnel(Data, front,
                                 max_lookahead=_dt.timedelta(seconds=60))
    counter: dict = {}
    watchdog = asyncio.create_task(_no_meter_watchdog(counter, amqp_url))
    tasks = [
        asyncio.create_task(read_pv_values(funnel, realtime, seed,
                                           duration_s, start)),
        asyncio.create_task(read_transport(funnel, amqp_url, exchange,
                                           counter, stream)),
        asyncio.create_task(write_file(file, queue, stream)),
    ]
    try:
        done, _ = await asyncio.wait(tasks,
                                     return_when=asyncio.FIRST_COMPLETED)
        for t in done:
            t.result()
        await queue.join()
    finally:
        for t in tasks:
            t.cancel()
        watchdog.cancel()
        if len(funnel) > 0:
            logger.warning("%d undelivered meter_values have been lost",
                           len(funnel))
        if run_report_path:
            try:
                write_report(run_report_path,
                             streaming_report("pvsim.stream", reg))
            except Exception as e:  # must not mask the run's own outcome
                logger.warning("run report write failed: %s", e)
