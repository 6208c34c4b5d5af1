"""Runtime autotuner: probe-based plan selection with a persistent
per-device cache (own port of tmhpvsim_tpu/engine/autotune.py, with its
names, grid and cache format).

The fastest plan is not the same on every path: the formulation
(``block_impl``), the slab size, the blocks per dispatch and the
precision levers move a run's wall by amounts that only a measurement on
the card shows.  This module makes the choice a measurement:

* :func:`static_plan` — the plan without measurement
  (``config.resolve_plan``: ``tune='off'``, no probe, no cache IO);
* :func:`probe_grid` — time the structural grid (``block_impl`` x
  ``scan_unroll`` x slab size x ``blocks_per_dispatch``) with short
  real-block probes through the engine's reduce path, then the
  sentinel-gated precision variants of the winner (``compute_dtype`` x
  ``kernel_impl`` x ``rng_batch`` x ``geom_stride``).  Each candidate's
  ``Simulation`` is freed, and the caching allocator emptied, before the
  next one is built, so a candidate never times an allocator that still
  holds an earlier candidate's buffers.  Every candidate of one config
  simulates the same run (keyed construction), so the choice is a
  performance decision only;
* a JSON cache keyed by (card name, backend, n_chains, block_s, dtype,
  prng_impl, engine version, and a fleet's length and digest) under
  ``$XDG_CACHE_HOME/tmhpvsim_torch/autotune.json`` (``~/.cache`` without
  it; override: ``TMHPVSIM_AUTOTUNE_CACHE``), in the JAX package's entry
  format, so a later run at the same key probes nothing;
* :func:`resolve_plan_for_mesh` — a sharded run probes on rank 0 at the
  per-rank chain shape and broadcasts the winner over the process group,
  so every rank runs the same plan and no other rank probes.

The probes run on the device the ``Simulation`` runs on: on the card the
kernels, each launched or its candidate recorded with the error; on the
CPU their plain versions (the tests).  Under threefry2x32 'scan',
'scan2', every ``scan_unroll`` and every ``rng_batch`` run one scan
kernel with the same bits (``config.Plan``); the grid keeps the JAX
package's axes all the same, so that records and tests match its grid one
to one.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import tempfile
import time

import torch

from tmhpvsim_torch import config as config_mod
from tmhpvsim_torch.config import (Plan, SimConfig, escalate_telemetry,
                                   slice_grid)
from tmhpvsim_torch.fleet.params import slice_fleet
from tmhpvsim_torch.obs import metrics as obs_metrics

logger = logging.getLogger(__name__)

#: bump when the engine's formulations change meaning: entries under an
#: older key are ignored, never misapplied
AUTOTUNE_ENGINE_VERSION = 1

#: candidate grid (module-level so tests and callers can narrow it)
CANDIDATE_IMPLS = ("wide", "scan", "scan2")
CANDIDATE_UNROLLS = (1, 4, 8, 12)
#: slab sizes; None means n_chains (no slabbing)
CANDIDATE_SLAB_CHAINS = (None, 65536, 16384)
#: blocks per dispatch group, probed when ``SimConfig.blocks_per_dispatch``
#: is left 0 (auto)
CANDIDATE_BLOCKS_PER_DISPATCH = (1, 4)
#: the sentinel-gated stage-2 axes: probed on the structural winner only,
#: and a variant off the defaults may win only when the drift sentinel
#: passes on a strict-telemetry gate run
CANDIDATE_COMPUTE_DTYPES = ("f32", "bf16")
CANDIDATE_KERNEL_IMPLS = ("exact", "table")
CANDIDATE_RNG_BATCHES = ("scan", "block")
CANDIDATE_GEOM_STRIDES = (1, 60)

#: chains and blocks of the sentinel gate run
SENTINEL_GATE_CHAINS = 4096
SENTINEL_GATE_BLOCKS = 4

#: steady dispatches timed per probe (after the one warm-up dispatch)
PROBE_TIMED_BLOCKS = 2

#: probes performed by this process (tests assert cache hits through it)
PROBE_COUNT = 0

#: seconds of the most recent real probe's first dispatch: ``init_state``
#: and the first group's launches, with the kernels' build or load when
#: this process has not loaded them yet.  ``probe_grid`` copies it into
#: each candidate's record; None after a fake probe.
LAST_PROBE_COMPILE_S = None

#: the Plan fields a cache entry persists (``_candidate_record``'s keys)
_TUNED = ("block_impl", "scan_unroll", "stats_fusion", "slab_chains",
          "blocks_per_dispatch", "compute_dtype", "kernel_impl",
          "rng_batch", "geom_stride")
#: what an entry persisted before an axis existed means for that axis
_ENTRY_DEFAULTS = {"blocks_per_dispatch": 1, "compute_dtype": "f32",
                   "kernel_impl": "exact", "rng_batch": "scan",
                   "geom_stride": 1}


def static_plan(config: SimConfig) -> Plan:
    """The plan without measurement (``config.resolve_plan``): 'auto'
    knobs resolved as the JAX package resolves them on an accelerator,
    no slabbing, ``source='static'``."""
    return config_mod.resolve_plan(config)


def _device(device) -> torch.device:
    from tmhpvsim_torch.engine.simulation import resolve_device

    return resolve_device(device)


def _release(device: torch.device) -> None:
    """Return a freed candidate's blocks to the card (the caching
    allocator keeps them otherwise)."""
    if device.type == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------


def time_reduce_blocks(sim, n_blocks: int, n_rounds: int = 1) -> tuple:
    """``(compile_s, best_steady_s, rate)`` of ``sim``'s reduce path: one
    warm-up dispatch, then ``n_rounds`` x ``n_blocks`` timed dispatches
    through ``step_acc``, the best round kept.  A dispatch is a group of
    ``plan.blocks_per_dispatch = k`` blocks as ``run_reduced`` runs it
    (the group's inputs in one upload, its launches back to back, the
    next group's inputs computed once it is enqueued), and the rate
    credits all k blocks, so ``sim.n_blocks`` must cover ``k * (1 +
    n_blocks * n_rounds)`` blocks.  Each timed window ends in
    ``torch.cuda.synchronize`` on the card.  ``compile_s`` spans
    ``init_state`` and the first dispatch.  Rate: simulated site-seconds
    per wall second."""
    k = sim.plan.blocks_per_dispatch
    need = k * (1 + n_blocks * n_rounds)
    if sim.n_blocks < need:
        raise ValueError(f"timing {n_rounds} x {n_blocks} dispatches of "
                         f"{k} blocks needs {need} blocks, the run has "
                         f"{sim.n_blocks}")
    dev = sim.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def dispatch(bi, state, acc, group):
        for inputs in group:
            state, acc = sim.step_acc(state, inputs, acc)
        return state, acc, sim._inputs_ahead(bi + k)

    t_c = time.perf_counter()
    state, acc = sim.init_state(), sim.init_reduce_acc()
    state, acc, group = dispatch(0, state, acc, sim._inputs_ahead(0))
    sync()
    compile_s = time.perf_counter() - t_c
    best = float("inf")
    bi = k
    for _ in range(n_rounds):
        t0 = time.perf_counter()
        for _ in range(n_blocks):
            state, acc, group = dispatch(bi, state, acc, group)
            bi += k
        sync()
        best = min(best, time.perf_counter() - t0)
    cfg = sim.local_config
    return compile_s, best, cfg.n_chains * cfg.block_s * n_blocks * k / best


def probe_plan(config: SimConfig, plan: Plan,
               n_timed: int = PROBE_TIMED_BLOCKS, device=None) -> float:
    """Measure one candidate with a short real-block run on ``device``;
    returns its rate (site-seconds per wall second).

    The probe simulates ``min(n_chains, slab_chains)`` chains — the shape
    each slab of the full run executes — for ``n_timed + 1`` dispatches of
    the config's ``block_s`` through ``time_reduce_blocks``.  Its
    ``Simulation`` is freed before the next candidate is built."""
    global LAST_PROBE_COMPILE_S
    from tmhpvsim_torch.engine.simulation import Simulation

    dev = _device(device)
    n = min(config.n_chains, plan.slab_chains)
    k = max(1, plan.blocks_per_dispatch)
    pcfg = dataclasses.replace(
        config, tune="off", n_chains=n, n_chains_total=None,
        chain_offset=0, site_grid=slice_grid(config.site_grid, 0, n),
        fleet=slice_fleet(config.fleet, 0, n),
        duration_s=config.block_s * k * (n_timed + 1), output="reduce")
    obs_metrics.get_registry().counter("autotune.probes_total").inc()
    sim = Simulation(pcfg, device=dev,
                     plan=dataclasses.replace(plan, slab_chains=n))
    try:
        compile_s, _, rate = time_reduce_blocks(sim, n_timed, 1)
    finally:
        del sim
        _release(dev)
    LAST_PROBE_COMPILE_S = compile_s
    return rate


def candidate_plans(config: SimConfig, slabs: bool = True) -> list:
    """The structural grid of one config: block_impl x scan_unroll x slab
    size x blocks_per_dispatch, at the config's resolved precision.  A
    pinned (non-'auto') ``block_impl`` and a pinned ``blocks_per_dispatch``
    are respected; slab sizes at or above n_chains collapse into the
    unslabbed candidate.  ``slabs=False`` drops the slab axis (a sharded
    run probes at the fixed per-rank shape)."""
    base = static_plan(config)
    impls = (CANDIDATE_IMPLS if config.block_impl == "auto"
             else (base.block_impl,))
    slab_sizes = []
    for s in (CANDIDATE_SLAB_CHAINS if slabs else (None,)):
        n = config.n_chains if s is None else min(s, config.n_chains)
        if n > 0 and n not in slab_sizes:
            slab_sizes.append(n)
    kds = (CANDIDATE_BLOCKS_PER_DISPATCH if config.blocks_per_dispatch == 0
           else (base.blocks_per_dispatch,))
    return [dataclasses.replace(base, block_impl=impl, scan_unroll=u,
                                slab_chains=slab, blocks_per_dispatch=kd,
                                source="probe")
            for impl in impls
            for u in CANDIDATE_UNROLLS
            for slab in slab_sizes
            for kd in kds]


def _candidate_record(plan: Plan) -> dict:
    return {f: getattr(plan, f) for f in _TUNED}


def _sentinel_gate(config: SimConfig, plan: Plan, device=None) -> bool:
    """True when a short strict-telemetry ``run_reduced`` of ``plan`` (on
    ``SENTINEL_GATE_CHAINS`` chains for ``SENTINEL_GATE_BLOCKS`` blocks)
    passes the drift sentinel against the float64 golden reference.

    The probes drive ``step_acc`` and never reach the sentinel, so this
    run is what keeps a numerically unsound candidate from winning on
    speed: ``DriftError`` rejects it, and so does any other failure (a
    candidate that cannot complete the gate run must not be chosen)."""
    from tmhpvsim_torch.engine.simulation import Simulation
    from tmhpvsim_torch.obs.sentinel import DriftError

    dev = _device(device)
    n = min(config.n_chains, plan.slab_chains, SENTINEL_GATE_CHAINS)
    gcfg = dataclasses.replace(
        config, tune="off", n_chains=n, n_chains_total=None,
        chain_offset=0, site_grid=slice_grid(config.site_grid, 0, n),
        fleet=slice_fleet(config.fleet, 0, n),
        duration_s=config.block_s * SENTINEL_GATE_BLOCKS, output="reduce",
        telemetry="light", telemetry_strict=True, analytics="off",
        blocks_per_dispatch=1)
    gplan = dataclasses.replace(plan, slab_chains=n, telemetry="light",
                                blocks_per_dispatch=1)
    sim = None
    try:
        sim = Simulation(gcfg, device=dev, plan=gplan)
        sim.run_reduced()
    except DriftError as e:
        logger.warning("autotune sentinel gate REJECTED %s/%s: %s",
                       plan.compute_dtype, plan.kernel_impl, e)
        return False
    except Exception as e:
        logger.warning("autotune sentinel gate failed to run for %s/%s "
                       "(%s); candidate rejected", plan.compute_dtype,
                       plan.kernel_impl, e)
        return False
    finally:
        del sim
        _release(dev)
    return True


def _precision_variants(config: SimConfig, winner: Plan) -> list:
    """Stage-2 candidates: the structural winner with each other
    combination of the gated axes (``compute_dtype``, ``kernel_impl``,
    ``rng_batch``, ``geom_stride``) that the config leaves to the tuner
    ('auto'; an explicit pin is respected like a pinned block_impl)."""
    cdts = (CANDIDATE_COMPUTE_DTYPES if config.compute_dtype == "auto"
            else (winner.compute_dtype,))
    kis = (CANDIDATE_KERNEL_IMPLS if config.kernel_impl == "auto"
           else (winner.kernel_impl,))
    rbs = (CANDIDATE_RNG_BATCHES if config.rng_batch == "auto"
           else (winner.rng_batch,))
    gss = (CANDIDATE_GEOM_STRIDES if int(config.geom_stride) == 0
           else (winner.geom_stride,))
    base = (winner.compute_dtype, winner.kernel_impl, winner.rng_batch,
            winner.geom_stride)
    return [dataclasses.replace(
                winner, compute_dtype=cdt, kernel_impl=ki, rng_batch=rb,
                geom_stride=gs,
                telemetry=escalate_telemetry(winner.telemetry, cdt))
            for cdt in cdts for ki in kis for rb in rbs for gs in gss
            if (cdt, ki, rb, gs) != base]


def probe_grid(config: SimConfig, slabs: bool = True, device=None) -> tuple:
    """Time every candidate on ``device``; returns ``(best plan, candidate
    records)``.

    Two stages: the structural grid at the config's resolved precision,
    then the gated variants of the stage-1 winner, each of which must pass
    :func:`_sentinel_gate` before it is probed.  A candidate that fails
    to build or run is recorded with its error and skipped; when every
    candidate fails, the static plan is returned (and ``resolve_plan``
    does not cache it)."""
    best = None
    records = []

    def probe_one(plan, rec):
        global PROBE_COUNT, LAST_PROBE_COMPILE_S
        PROBE_COUNT += 1
        LAST_PROBE_COMPILE_S = None
        try:
            rate = probe_plan(config, plan, device=device)
        except Exception as e:
            logger.warning("autotune candidate %s failed: %s", rec, e)
            rec["error"] = str(e)[:200]
            records.append(rec)
            return None
        rec["rate"] = round(rate, 1)
        if LAST_PROBE_COMPILE_S is not None:
            rec["compile_s"] = round(LAST_PROBE_COMPILE_S, 3)
        records.append(rec)
        logger.info("autotune probe impl=%s unroll=%d slab=%d kd=%d "
                    "dtype=%s kernels=%s rng=%s stride=%d: %.3g site-s/s",
                    plan.block_impl, plan.scan_unroll, plan.slab_chains,
                    plan.blocks_per_dispatch, plan.compute_dtype,
                    plan.kernel_impl, plan.rng_batch, plan.geom_stride,
                    rate)
        return rate

    for plan in candidate_plans(config, slabs=slabs):
        rate = probe_one(plan, _candidate_record(plan))
        if rate is not None and (best is None or rate > best[1]):
            best = (plan, rate)
    if best is None:
        logger.warning("every autotune candidate failed; falling back to "
                       "the static plan")
        return static_plan(config), records
    for plan in _precision_variants(config, best[0]):
        rec = _candidate_record(plan)
        if not _sentinel_gate(config, plan, device=device):
            rec["sentinel"] = "fail"
            records.append(rec)
            continue
        rec["sentinel"] = "pass"
        rate = probe_one(plan, rec)
        if rate is not None and rate > best[1]:
            best = (plan, rate)
    return best[0], records


# ---------------------------------------------------------------------------
# persistent per-device cache
# ---------------------------------------------------------------------------


def cache_path() -> str:
    env = os.environ.get("TMHPVSIM_AUTOTUNE_CACHE")
    if env:
        return env
    root = os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache")
    return os.path.join(root, "tmhpvsim_torch", "autotune.json")


def plan_key(config: SimConfig, device=None) -> str:
    """Cache key: what the winning plan is conditional on — the card's
    name (``'cpu'`` on the CPU) and the backend, the shape, dtype and key
    knobs that move the optimum, the engine version, and a fleet's length
    and content digest (a plan tuned for one parameter mix is not
    replayed onto another).  The JAX package keys a (chains, scenario)
    mesh apart; the port's meshes have one axis."""
    dev = _device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    parts = [name, dev.type, config.n_chains, config.block_s, config.dtype,
             config.prng_impl, AUTOTUNE_ENGINE_VERSION]
    if config.fleet is not None:
        parts.append(f"fleet{len(config.fleet)}-{config.fleet.digest()[:12]}")
    return "|".join(str(x) for x in parts)


def _load_cache(path: str) -> dict:
    try:
        with open(path) as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else {}
    except (OSError, json.JSONDecodeError):
        return {}  # missing or corrupt: a cold cache


def _plan_from_entry(entry: dict) -> Plan:
    """The tuned fields of a cache entry (written by this module or by the
    JAX package's) as a Plan with ``source='cache'``; an axis the entry
    predates loads as its default.  Raises on a malformed entry."""
    p = entry["plan"]
    plan = Plan(
        block_impl=str(p["block_impl"]), scan_unroll=int(p["scan_unroll"]),
        stats_fusion=str(p["stats_fusion"]),
        slab_chains=int(p["slab_chains"]), source="cache",
        blocks_per_dispatch=int(p.get("blocks_per_dispatch", 1)),
        compute_dtype=str(p.get("compute_dtype", "f32")),
        kernel_impl=str(p.get("kernel_impl", "exact")),
        rng_batch=str(p.get("rng_batch", "scan")),
        geom_stride=int(p.get("geom_stride", 1)))
    if plan.block_impl not in ("wide", "scan", "scan2") or \
            plan.stats_fusion not in ("fused", "split") or \
            plan.scan_unroll < 1 or plan.slab_chains < 1 or \
            plan.blocks_per_dispatch < 1 or \
            plan.compute_dtype not in ("f32", "bf16") or \
            plan.kernel_impl not in ("exact", "table") or \
            plan.rng_batch not in ("scan", "block") or \
            plan.geom_stride not in (1, 30, 60):
        raise ValueError(f"malformed cached plan {p!r}")
    return plan


def _store_plan(path: str, key: str, plan: Plan, candidates: list) -> None:
    """Merge one entry into the cache, atomically (tmp + rename) so that a
    concurrent reader never sees a torn file.  A failed write is logged,
    not raised: the plan is already resolved."""
    try:
        cache = _load_cache(path)
        entry = {"plan": _candidate_record(plan), "candidates": candidates,
                 "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
        # the winner's first-dispatch seconds at entry level
        for c in candidates:
            if all(c.get(f, _ENTRY_DEFAULTS.get(f)) == getattr(plan, f)
                   for f in _TUNED if f != "stats_fusion") \
                    and c.get("compile_s") is not None:
                entry["compile_s"] = c["compile_s"]
                break
        cache[key] = entry
        d = os.path.dirname(path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(cache, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            os.unlink(tmp)
            raise
    except OSError as e:
        logger.warning("autotune cache write failed (%s): %s", path, e)


def cached_candidates(config: SimConfig, device=None) -> list:
    """The probe records persisted with this config's cached plan ([] when
    the key is absent)."""
    entry = _load_cache(cache_path()).get(plan_key(config, device=device))
    return list(entry.get("candidates", ())) if entry else []


# ---------------------------------------------------------------------------
# resolution entry points
# ---------------------------------------------------------------------------


def _from_cache(config: SimConfig, entry: dict) -> Plan:
    """A cache hit as this config's plan: the entry's tuned fields over
    the static plan (which carries the config's telemetry request and key
    implementation); an explicit ``blocks_per_dispatch``,
    ``compute_dtype``, ``kernel_impl``, ``rng_batch`` or ``geom_stride``
    overrides the cached value, and the telemetry escalation sees the
    final compute dtype."""
    static = static_plan(config)
    cached = _plan_from_entry(entry)
    plan = dataclasses.replace(
        static, source="cache",
        **{f: getattr(cached, f) for f in _TUNED})
    pinned = {"blocks_per_dispatch": config.blocks_per_dispatch >= 1,
              "compute_dtype": config.compute_dtype != "auto",
              "kernel_impl": config.kernel_impl != "auto",
              "rng_batch": config.rng_batch != "auto",
              "geom_stride": int(config.geom_stride) != 0}
    plan = dataclasses.replace(
        plan, **{f: getattr(static, f) for f, pin in pinned.items() if pin})
    return dataclasses.replace(plan, telemetry=escalate_telemetry(
        config.telemetry, plan.compute_dtype))


def resolve_plan(config: SimConfig, slabs: bool = True,
                 device=None) -> Plan:
    """The plan a ``Simulation`` of ``config`` on ``device`` runs.

    ``tune='off'``: the static plan (no measurement, no cache IO).
    ``tune='auto'``: the cached plan for this key if there is one, else
    probe the grid and persist the winner.  ``tune='force'``: probe and
    persist even on a hit."""
    if config.tune == "off":
        return static_plan(config)
    if config.tune not in ("auto", "force"):
        raise ValueError(
            f"tune must be 'auto', 'off' or 'force', got {config.tune!r}")
    path = cache_path()
    key = plan_key(config, device=device)
    if config.tune == "auto":
        entry = _load_cache(path).get(key)
        if entry is not None:
            try:
                return _from_cache(config, entry)
            except (KeyError, TypeError, ValueError) as e:
                logger.warning("ignoring malformed autotune cache entry "
                               "for %s: %s", key, e)
    plan, candidates = probe_grid(config, slabs=slabs, device=device)
    if plan.source == "probe":  # the all-failed fallback is not cached
        _store_plan(path, key, plan, candidates)
    return dataclasses.replace(
        plan, telemetry=escalate_telemetry(config.telemetry,
                                           plan.compute_dtype))


#: the encodings of the broadcast plan's string fields
_CODES = {"block_impl": ("wide", "scan", "scan2"),
          "stats_fusion": ("split", "fused"),
          "compute_dtype": ("f32", "bf16"),
          "kernel_impl": ("exact", "table"),
          "rng_batch": ("scan", "block")}


def broadcast_plan(plan: Plan, device=None) -> Plan:
    """Rank 0's plan on every rank of the default process group (the plan
    itself without a group): its tuned fields as one int32 tensor through
    ``torch.distributed.broadcast`` (on ``device`` under NCCL, on the CPU
    under gloo).  The other ranks' ``source`` is 'broadcast', and their
    telemetry escalates under rank 0's compute dtype."""
    from tmhpvsim_torch.parallel import distributed

    rank, size = distributed.world()
    if size == 1:
        return plan
    enc = [_CODES[f].index(getattr(plan, f)) if f in _CODES
           else int(getattr(plan, f)) for f in _TUNED]
    out = distributed.broadcast_ints(enc, device)
    fields = {f: _CODES[f][v] if f in _CODES else v
              for f, v in zip(_TUNED, out)}
    return dataclasses.replace(
        plan, **fields, source=plan.source if rank == 0 else "broadcast",
        telemetry=escalate_telemetry(plan.telemetry,
                                     fields["compute_dtype"]))


def resolve_plan_for_mesh(config: SimConfig, n_dev: int,
                          device=None) -> Plan:
    """The plan of a sharded run over ``n_dev`` ranks: probed at the
    per-rank chain shape (what each rank's ``Simulation`` holds), on rank
    0 only and without the slab axis, then broadcast, so every rank runs
    the same plan.  ``slab_chains`` is pinned to the rank's chains: the
    ranks partition the chains themselves, and each rank's ``Simulation``
    holds its share (in the JAX package one process holds every device's
    chains, and the pin is the whole run's)."""
    from tmhpvsim_torch.parallel import distributed

    n_eff = (len(config.site_grid) if config.site_grid is not None
             else config.n_chains)
    per_dev = max(1, n_eff // n_dev)
    if config.tune == "off":
        plan = static_plan(config)
    else:
        pcfg = dataclasses.replace(
            config, n_chains=per_dev, n_chains_total=None, chain_offset=0,
            site_grid=slice_grid(config.site_grid, 0, per_dev),
            fleet=slice_fleet(config.fleet, 0, per_dev))
        if distributed.world()[0] != 0:
            plan = static_plan(pcfg)  # replaced by the broadcast below
        else:
            plan = resolve_plan(pcfg, slabs=False, device=device)
        plan = broadcast_plan(plan, device)
    return dataclasses.replace(plan, slab_chains=per_dev)
