"""The run report (own copy of the parts of the JAX package's obs/report.py
that assemble and validate the sections the port writes).

A report is the JAX package's schema-versioned RunReport document: the
same ``kind`` and ``schema_version``, so the repository's readers
(``tools/fleet_report.py``, ``tools/precision_report.py``, the JAX
package's ``validate_report``) pick it out and check it.  The port fills
``device`` (from torch: platform ``gpu`` with the card's name, or
``cpu``), ``config`` (the SimConfig echo; a site grid or fleet by its
identity, not its rows), ``plan`` (the resolved plan in the JAX plan
echo's keys), ``fleet`` (``fleet_summary()``), ``precision``
(``precision_doc()``) and ``telemetry`` (the drift sentinel's report, when
telemetry observed the run), and from the run's metrics registry
``checkpoint`` (saves, restores, generations, verify failures and
fallbacks, the async writer's counts, preemption snapshots), ``slabs``
and ``resilience`` (resumes), as the JAX ``RunReport.attach_metrics``
derives them; a streaming run (``pvsim --backend asyncio``,
:func:`streaming_report`) fills ``metrics`` (the registry's snapshot),
``streaming`` (the join's latencies and the funnel, retry and broker
counters) and, paced at 1 Hz, ``realtime``; every other section is None.

``validate_report`` is the JAX validator's top level: required keys,
types, no unknown keys, the fleet section's cohort rows, and a
JSON-serialisable document.  A sharded run adds ``mesh`` (checked by
``validate_mesh_section``, the JAX validator's) and ``processes``.  The
sections the port never writes and has no validator for (``cost``,
``pod``, ``attribution``) are refused when they are not None.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Optional

import torch

from tmhpvsim_torch.obs.metrics import quantile_from_snapshot

#: the JAX package's RunReport schema version and kind (obs/report.py)
REPORT_SCHEMA_VERSION = 16
REPORT_KIND = "tmhpvsim_tpu.run_report"

_NUM = (int, float)
_OPT_DICT = (dict, type(None))

#: top-level schema: name -> (required, allowed types)
_TOP_SCHEMA = {
    "schema_version": (True, int),
    "kind": (True, str),
    "app": (True, str),
    "created_utc": (True, str),
    "device": (True, dict),
    "config": (False, _OPT_DICT),
    "plan": (False, _OPT_DICT),
    "timing": (False, _OPT_DICT),
    "checkpoint": (False, _OPT_DICT),
    "slabs": (False, _OPT_DICT),
    "realtime": (False, _OPT_DICT),
    "headline": (False, _OPT_DICT),
    "metrics": (False, _OPT_DICT),
    "profile": (False, _OPT_DICT),
    "processes": (False, (list, type(None))),
    "telemetry": (False, _OPT_DICT),
    "streaming": (False, _OPT_DICT),
    "executor": (False, _OPT_DICT),
    "fleet": (False, _OPT_DICT),
    "serving": (False, _OPT_DICT),
    "resilience": (False, _OPT_DICT),
    "precision": (False, _OPT_DICT),
    "probe": (False, _OPT_DICT),
    "cost": (False, _OPT_DICT),
    "mesh": (False, _OPT_DICT),
    "pod": (False, _OPT_DICT),
    "attribution": (False, _OPT_DICT),
}

_DEVICE_SCHEMA = {
    "platform": (True, (str, type(None))),
    "device_kind": (False, (str, type(None))),
    "n_devices": (False, int),
    "process_count": (False, int),
    "process_index": (False, int),
    "memory_stats": (False, _OPT_DICT),
}

_TIMING_SCHEMA = {
    "compile_s": (False, _NUM + (type(None),)),
    "steady_block_s": (False, _NUM + (type(None),)),
    "first_block_s": (False, _NUM + (type(None),)),
    "n_blocks_timed": (False, int),
    "site_seconds_per_s": (False, _NUM + (type(None),)),
    "rate_includes_compile": (False, bool),
}

#: sections whose validators live in JAX-only modules; the port writes
#: none of them
_UNCHECKED = ("cost", "pod", "attribution")


def _check_fields(doc: dict, schema: dict, where: str,
                  closed: bool = False) -> None:
    for key, (required, types) in schema.items():
        if key not in doc:
            if required:
                raise ValueError(f"run report {where}: missing required "
                                 f"key {key!r}")
            continue
        if not isinstance(doc[key], types):
            names = types if isinstance(types, tuple) else (types,)
            raise ValueError(
                f"run report {where}: {key!r} has type "
                f"{type(doc[key]).__name__}, expected "
                f"{'/'.join(t.__name__ for t in names)}")
    if closed:
        unknown = set(doc) - set(schema)
        if unknown:
            raise ValueError(f"run report {where}: unknown keys "
                             f"{sorted(unknown)}")


def validate_fleet_section(sec: dict) -> list:
    """Shape-check the ``fleet`` section's cohort rows; returns a list of
    error strings (empty = valid).  A section without cohorts (``cohorts``
    absent or null) is valid by construction."""
    errors = []
    co = sec.get("cohorts")
    if co is None:
        return errors
    if not isinstance(co, list):
        return [f"cohorts: expected a list or null, "
                f"got {type(co).__name__}"]
    for i, row in enumerate(co):
        if not isinstance(row, dict):
            errors.append(f"cohorts[{i}]: expected an object")
            continue
        for key in ("cohort", "count"):
            if not isinstance(row.get(key), int):
                errors.append(f"cohorts[{i}].{key}: expected an integer")
        for key in ("residual_min", "residual_max", "meter_mean",
                    "pv_mean", "residual_mean"):
            if key in row and not isinstance(
                    row[key], _NUM + (type(None),)):
                errors.append(f"cohorts[{i}].{key}: expected a number "
                              "or null")
        if "quantiles" in row and not isinstance(row["quantiles"],
                                                 _OPT_DICT):
            errors.append(f"cohorts[{i}].quantiles: expected an object "
                          "or null")
    return errors


def validate_mesh_section(sec: dict) -> list:
    """Shape-check the ``mesh`` section (the JAX package's v13 check);
    returns a list of error strings (empty = valid): the shape's product
    is ``n_devices`` and pairs with ``axis_names``, and a chain layout
    divides evenly and bounds the process's slice."""
    errors = []
    shape = sec.get("shape")
    axes = sec.get("axis_names")
    if not (isinstance(shape, list) and shape
            and all(isinstance(s, int) and s >= 1 for s in shape)):
        errors.append("shape: expected a non-empty list of ints >= 1")
        shape = None
    if not (isinstance(axes, list) and axes
            and all(isinstance(a, str) for a in axes)):
        errors.append("axis_names: expected a non-empty list of strings")
        axes = None
    if shape is not None and axes is not None and len(shape) != len(axes):
        errors.append(f"shape/axis_names: rank mismatch "
                      f"({len(shape)} vs {len(axes)})")
    n_dev = sec.get("n_devices")
    if not isinstance(n_dev, int) or n_dev < 1:
        errors.append("n_devices: expected an int >= 1")
    elif shape is not None and math.prod(shape) != n_dev:
        errors.append(f"n_devices: {n_dev} != product(shape) "
                      f"{math.prod(shape)}")
    for key in ("process_count", "process_index"):
        if key in sec and (not isinstance(sec[key], int) or sec[key] < 0):
            errors.append(f"{key}: expected an int >= 0")
    if isinstance(sec.get("process_count"), int) and \
            isinstance(sec.get("process_index"), int) and \
            sec["process_index"] >= sec["process_count"] >= 1:
        errors.append("process_index: outside [0, process_count)")
    nc = sec.get("n_chains")
    if nc is not None:
        if not isinstance(nc, int) or nc < 1:
            errors.append("n_chains: expected an int >= 1 or absent")
        elif isinstance(n_dev, int) and n_dev >= 1:
            if nc % n_dev != 0:
                errors.append(f"n_chains: {nc} not divisible by "
                              f"n_devices {n_dev}")
            cpd = sec.get("chains_per_device")
            if cpd is not None and cpd != nc // n_dev:
                errors.append(f"chains_per_device: {cpd} != "
                              f"{nc // n_dev}")
        lo, hi = sec.get("chain_start"), sec.get("chain_stop")
        if lo is not None and hi is not None and isinstance(nc, int):
            if not (isinstance(lo, int) and isinstance(hi, int)
                    and 0 <= lo <= hi <= nc):
                errors.append("chain_start/chain_stop: expected "
                              f"0 <= start <= stop <= n_chains ({nc})")
    return errors


def validate_report(doc) -> dict:
    """Validate ``doc`` against the versioned schema; returns it.

    Raises ValueError on: non-dict, wrong kind / schema_version, missing
    required fields, mistyped fields, unknown top-level keys, a section
    the port cannot check, or a document json.dumps cannot serialise."""
    if not isinstance(doc, dict):
        raise ValueError(f"run report must be a dict, got "
                         f"{type(doc).__name__}")
    _check_fields(doc, _TOP_SCHEMA, "top level", closed=True)
    if doc["kind"] != REPORT_KIND:
        raise ValueError(f"run report kind {doc['kind']!r} != "
                         f"{REPORT_KIND!r}")
    if not 1 <= doc["schema_version"] <= REPORT_SCHEMA_VERSION:
        raise ValueError(
            f"run report schema_version {doc['schema_version']!r} outside "
            f"[1, {REPORT_SCHEMA_VERSION}] (this build); newer documents "
            "need a newer reader")
    _check_fields(doc["device"], _DEVICE_SCHEMA, "device")
    if isinstance(doc.get("timing"), dict):
        _check_fields(doc["timing"], _TIMING_SCHEMA, "timing")
    if isinstance(doc.get("fleet"), dict):
        errors = validate_fleet_section(doc["fleet"])
        if errors:
            raise ValueError("run report fleet: " + "; ".join(errors))
    if isinstance(doc.get("mesh"), dict):
        errors = validate_mesh_section(doc["mesh"])
        if errors:
            raise ValueError("run report mesh: " + "; ".join(errors))
    for key in _UNCHECKED:
        if doc.get(key) is not None:
            raise ValueError(f"run report {key}: the port writes no such "
                             "section and cannot validate it")
    try:
        json.dumps(doc)
    except (TypeError, ValueError) as e:
        raise ValueError(f"run report is not JSON-serialisable: {e}") from e
    return doc


def device_info(device) -> dict:
    """The ``device`` section of a run on ``device``: platform ``gpu``
    with the card's name, the card count and its allocator's byte
    counts, or ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu",
                "device_kind": torch.cuda.get_device_name(dev),
                "n_devices": torch.cuda.device_count(),
                "process_count": 1, "process_index": 0,
                "memory_stats": {
                    "bytes_in_use": int(torch.cuda.memory_allocated(dev)),
                    "peak_bytes_in_use":
                        int(torch.cuda.max_memory_allocated(dev))}}
    return {"platform": "cpu", "device_kind": "cpu", "n_devices": 1,
            "process_count": 1, "process_index": 0, "memory_stats": None}


def _jsonable(v):
    for cast in (int, float, str):
        try:
            return cast(v)
        except (TypeError, ValueError):
            continue
    return repr(v)


def config_doc(config) -> Optional[dict]:
    """JSON-able echo of a SimConfig: a site grid by its size, a fleet by
    its identity (size, cohort width, content digest), never their rows;
    tuples as lists."""
    if config is None:
        return None
    doc = {f.name: getattr(config, f.name)
           for f in dataclasses.fields(config)}
    for name in ("site", "options"):
        doc[name] = dataclasses.asdict(doc[name])
    if config.site_grid is not None:
        doc["site_grid"] = {"n_sites": len(config.site_grid)}
    if config.fleet is not None:
        fp = config.fleet
        doc["fleet"] = {"n_sites": len(fp), "n_cohorts": fp.n_cohorts,
                        "digest": fp.digest()}
    return json.loads(json.dumps(doc, default=_jsonable))


def plan_doc(plan) -> Optional[dict]:
    """The resolved plan in the JAX plan echo's keys (the port has no
    autotuner: its source is 'static')."""
    if plan is None:
        return None
    return {"block_impl": plan.block_impl,
            "scan_unroll": int(plan.scan_unroll),
            "stats_fusion": plan.stats_fusion,
            "slab_chains": int(plan.slab_chains),
            "blocks_per_dispatch": int(plan.blocks_per_dispatch),
            "compute_dtype": plan.compute_dtype,
            "kernel_impl": plan.kernel_impl,
            "rng_batch": plan.rng_batch,
            "geom_stride": int(plan.geom_stride),
            "source": "static"}


#: the ``checkpoint`` section's keys beyond the first four, with the
#: registry metric each reads (present only when the run used it)
_CHECKPOINT_EXTRA = (
    ("generations", "gauges", "checkpoint.generations"),
    ("latest_generation", "gauges", "checkpoint.latest_generation"),
    ("verify_failures", "counters", "checkpoint.verify_fail_total"),
    ("fallbacks", "counters", "checkpoint.fallback_total"),
    ("async_saves", "counters", "checkpoint.async_saves_total"),
    ("async_dropped", "counters", "checkpoint.async_dropped_total"),
    ("async_write_failures", "counters",
     "checkpoint.async_write_failures_total"),
    ("async_queue_depth", "gauges", "checkpoint.async_queue_depth"),
    ("preempt_snapshots", "counters", "checkpoint.preempt_snapshots_total"),
)


def registry_sections(snap: dict) -> dict:
    """The ``checkpoint``, ``slabs`` and ``resilience`` sections of a
    registry snapshot (the JAX ``RunReport.attach_metrics``; each None
    when the run recorded none of its metrics)."""
    hists = snap.get("histograms", {})
    gauges = snap.get("gauges", {})
    counters = snap.get("counters", {})
    out = {"checkpoint": None, "slabs": None, "resilience": None}
    save = hists.get("checkpoint.save_s")
    restore = hists.get("checkpoint.restore_s")
    if save or restore or any(k.startswith("checkpoint.")
                              for k in list(counters) + list(gauges)):
        sec = {"saves": (save or {}).get("count", 0),
               "save_total_s": (save or {}).get("sum", 0.0),
               "restores": (restore or {}).get("count", 0),
               "restore_total_s": (restore or {}).get("sum", 0.0)}
        src = {"gauges": gauges, "counters": counters}
        for key, kind, metric in _CHECKPOINT_EXTRA:
            if metric in src[kind]:
                sec[key] = int(src[kind][metric])
        out["checkpoint"] = sec
    if "slab.total" in gauges:
        out["slabs"] = {"completed": int(gauges.get("slab.completed", 0)),
                        "total": int(gauges["slab.total"])}
    if any(k.startswith(("resilience.", "faults."))
           for k in list(counters) + list(gauges)):
        states = {0: "closed", 1: "half_open", 2: "open"}
        pre = "resilience.breaker_state."
        res = {
            "resumes": int(counters.get("resilience.resumed_total", 0)),
            "restarts": int(gauges.get("resilience.supervised_restarts",
                                       0)),
            "retries": int(counters.get("resilience.retries_total", 0)),
            "giveups": int(counters.get("resilience.giveups_total", 0)),
            "breaker": {
                "opens": int(_sum_prefixed(
                    counters, "resilience.breaker_open_total.")),
                "rejected": int(_sum_prefixed(
                    counters, "resilience.breaker_rejected_total.")),
                "states": {k[len(pre):]: states.get(int(v), str(v))
                           for k, v in gauges.items()
                           if k.startswith(pre)}},
            "faults_injected": int(counters.get("faults.injected_total", 0)),
            "faults_by_point": {k[len("faults.injected."):]: int(v)
                                for k, v in counters.items()
                                if k.startswith("faults.injected.")},
        }
        if "resilience.resumed_block" in gauges:
            res["resumed_block"] = int(gauges["resilience.resumed_block"])
        out["resilience"] = res
    return out


def simulation_report(app: str, sim) -> dict:
    """The validated report of a finished Simulation run: its device,
    config and plan, the ``fleet`` section (``fleet_summary()``), the
    ``precision`` section (``precision_doc()``) and the ``telemetry``
    section (``sim.sentinel.report()`` once the sentinel has checked a
    block); a sharded run (``parallel.ShardedSimulation``) adds ``mesh``
    (``sim.mesh_doc()``, None otherwise) and, over more than one process
    (``sim.world``), ``processes``: every process's metrics snapshot in
    rank order (a collective, so every process calls this); the
    ``checkpoint``, ``slabs`` and ``resilience`` sections come from the
    run's metrics (``registry_sections``).  Every other section is
    None."""
    doc = {k: None for k in _TOP_SCHEMA}
    doc.update(schema_version=REPORT_SCHEMA_VERSION, kind=REPORT_KIND,
               app=app,
               created_utc=time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime()),
               device=device_info(sim.device), config=config_doc(sim.config),
               plan=plan_doc(sim.plan), fleet=sim.fleet_summary(),
               precision=sim.precision_doc(),
               telemetry=(None if sim.sentinel is None
                          else sim.sentinel.report()),
               **registry_sections(sim.metrics.snapshot()))
    mesh = sim.mesh_doc()
    if mesh is not None:
        doc["mesh"] = mesh
        doc["device"].update(n_devices=mesh["n_devices"],
                             process_count=mesh["process_count"],
                             process_index=mesh["process_index"])
    if sim.world > 1:
        from tmhpvsim_torch.parallel import distributed

        doc["processes"] = distributed.gather_metrics(sim.metrics.snapshot())
    return validate_report(doc)


def _latency_doc(snap: Optional[dict]) -> Optional[dict]:
    """Quantile summary of one latency histogram's snapshot."""
    if not snap or not snap.get("count"):
        return None
    return {"count": snap["count"], "mean_s": snap.get("mean"),
            "min_s": snap.get("min"), "max_s": snap.get("max"),
            "p50_s": quantile_from_snapshot(snap, 0.50),
            "p90_s": quantile_from_snapshot(snap, 0.90),
            "p99_s": quantile_from_snapshot(snap, 0.99)}


def _sum_prefixed(counters: dict, prefix: str) -> float:
    return sum(v for k, v in counters.items() if k.startswith(prefix))


def streaming_section(snap: dict) -> Optional[dict]:
    """The ``streaming`` section from the metric names of the streaming
    runtime (funnel, retry, brokers, pvsim's join accounting); None when
    the run streamed nothing."""
    hists = snap.get("histograms", {})
    gauges = snap.get("gauges", {})
    counters = snap.get("counters", {})
    if not ("streaming.publish_to_join_s" in hists
            or "streaming.join_to_csv_s" in hists
            or any(k.startswith(("funnel.", "broker.", "retry."))
                   for k in list(counters) + list(gauges))):
        return None
    return {
        "publish_to_join": _latency_doc(
            hists.get("streaming.publish_to_join_s")),
        "join_to_csv": _latency_doc(hists.get("streaming.join_to_csv_s")),
        "rows_written": int(counters.get("pvsim.rows_written_total", 0)),
        "funnel": {
            "pending_high_water":
                int(gauges.get("funnel.pending_high_water", 0)),
            "evictions": int(counters.get("funnel.evicted_total", 0)),
            "stall_suspends":
                int(counters.get("funnel.stall_suspends_total", 0)),
            "backpressure_waits":
                int(counters.get("funnel.backpressure_waits_total", 0)),
        },
        "retry": {
            "attempts": int(_sum_prefixed(counters, "retry.attempts.")),
            "exhausted": int(_sum_prefixed(counters, "retry.exhausted.")),
        },
        "broker": {
            "connects": int(counters.get("broker.connects_total", 0)),
            "reconnects": int(counters.get("broker.reconnects_total", 0)),
            "published": int(counters.get("broker.published_total", 0)),
            "delivered": int(counters.get("broker.delivered_total", 0)),
        },
    }


def streaming_report(app: str, registry) -> dict:
    """The validated report of a streaming run (host code: device cpu):
    the registry's snapshot as ``metrics``, its ``streaming`` section and,
    when the clock paced the run, its ``realtime`` section."""
    snap = registry.snapshot()
    gauges = snap["gauges"]
    doc = {k: None for k in _TOP_SCHEMA}
    doc.update(schema_version=REPORT_SCHEMA_VERSION, kind=REPORT_KIND,
               app=app,
               created_utc=time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime()),
               device=device_info("cpu"), metrics=snap,
               streaming=streaming_section(snap))
    if "clock.pacing_lag_s" in gauges:
        doc["realtime"] = {
            "pacing_lag_s": gauges["clock.pacing_lag_s"],
            "pacing_slip_total_s": gauges.get("clock.pacing_slip_total_s",
                                              0.0)}
    return validate_report(doc)


def write_report(path: str, doc: dict) -> dict:
    """Validate and write the report JSON (atomic tmp + rename)."""
    validate_report(doc)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)
    return doc
