"""The rank entry of the port's sharded checks (tests/test_torch_sharded.py
and chip_smoke.py's sharded phase); not a way to run a simulation, which
is ``pvsim --sharded``.

    python -m tmhpvsim_torch.parallel._check \\
        JOBS.pkl OUT_DIR URL WORLD RANK DEVICE

joins the group at the rendezvous ``URL`` as rank ``RANK`` of ``WORLD`` on
``DEVICE`` ('cpu' or 'cuda'), runs every job of ``JOBS.pkl`` (a pickled
list that the check wrote: loading it runs whatever it names, as any
pickle does) through ``run_job`` and leaves the group.  A job is a dict:
``name``, ``config`` (a ``SimConfig``), ``outputs`` (any of 'reduce',
'ensemble', 'trace') and optionally ``nan`` (``((fleet leaf, global
chain), ...)``: those leaves of the initial state set to NaN, on the rank
that holds the chain).  Every rank runs every job (so every rank reaches
the same collectives) and writes ``OUT_DIR/{name}.rank{r}.npz``: the
rank's chain range, its reduce rows (``reduce.<stat>``), the whole run's
``ensemble_stats``, ``fleet_summary`` and ``tel_summary`` (JSON text),
the analytics run totals (``fleet_total.<leaf>``) and the last block's
telemetry delta (``tel_last.<leaf>``), which the checks hold leaf by leaf
against an unsharded run's, the per-second fleet means
(``ensemble.<field>``), the rank's trace rows (``trace.<field>``) with
the whole run's means (``trace.pv_mean``, ``trace.residual_mean``), the
epochs, and the ``all_reduce`` calls and bytes each output took.
"""

from __future__ import annotations

import json
import os
import pickle
import sys

import numpy as np
import torch

from tmhpvsim_torch.parallel import distributed
from tmhpvsim_torch.parallel.mesh import ShardedSimulation


def _json(doc) -> np.ndarray:
    return np.asarray(json.dumps(doc, default=float))


def _tree(prefix: str, tree) -> dict:
    if tree is None:
        return {}
    return {f"{prefix}.{k}": (v.cpu().numpy() if isinstance(v, torch.Tensor)
                              else np.asarray(v)) for k, v in tree.items()}


def run_job(job: dict, out_dir: str, device=None) -> ShardedSimulation:
    """Run one job on this rank (the default group joined, or none) and
    write its ``.npz``; returns the simulation (its last block's deltas
    and device)."""
    sim = ShardedSimulation(job["config"], device=device)
    sl = sim.chain_slice
    out = {"chain_start": np.asarray(sl.start),
           "chain_stop": np.asarray(sl.stop)}
    for what in job.get("outputs", ("reduce",)):
        distributed.reset_counts()
        if what == "reduce":
            state = None
            if job.get("nan"):
                state = sim.init_state()
                for leaf, chain in job["nan"]:
                    if sl.start <= chain < sl.stop:
                        state["fleet"][leaf][chain - sl.start] = float("nan")
            out.update(_tree("reduce", sim.run_reduced(state=state)))
            out["ensemble_stats"] = _json(sim.ensemble_stats())
            out["fleet_summary"] = _json(sim.fleet_summary())
            out["tel_summary"] = _json(sim.tel_summary)
            out.update(_tree("fleet_total", sim._fleet_total))
            out.update(_tree("tel_last", sim._tel_last))
        else:
            runner = sim.run_ensemble if what == "ensemble" else sim.run_blocks
            blocks = list(runner())
            out["epoch"] = np.concatenate([b.epoch for b in blocks])
            for f in ("meter", "pv", "residual"):
                out[f"{what}.{f}"] = np.concatenate(
                    [getattr(b, f) for b in blocks], axis=1)
            if what == "trace":
                for f in ("pv_mean", "residual_mean"):
                    out[f"trace.{f}"] = np.concatenate(
                        [b.ensemble[f] for b in blocks])
        out[f"{what}.all_reduce_calls"] = np.asarray(
            distributed.ALL_REDUCE.calls)
        out[f"{what}.all_reduce_bytes"] = np.asarray(
            distributed.ALL_REDUCE.bytes)
    np.savez(os.path.join(out_dir, f"{job['name']}.rank{sim.rank}.npz"),
             **out)
    return sim


def main(argv=None) -> int:
    jobs_path, out_dir, url, size, rank, device = \
        sys.argv[1:] if argv is None else argv
    with open(jobs_path, "rb") as f:
        jobs = pickle.load(f)
    distributed.initialize(url, int(size), int(rank), device=device)
    try:
        for job in jobs:
            run_job(job, out_dir, device=device)
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
