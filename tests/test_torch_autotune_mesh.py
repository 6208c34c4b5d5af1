"""The per-mesh autotuner over two gloo ranks (tmhpvsim_torch/engine/
autotune.py ``resolve_plan_for_mesh``, the JAX package's contract):
rank 0 probes at the per-rank chain shape and broadcasts its winner,
so both ranks hold the same plan, rank 1's with ``source='broadcast'``,
and rank 1 probes nothing.

The ranks are two processes (``python -c`` of ``RANK``) joined over a
``file://`` rendezvous (no TCP port); each builds a ``ShardedSimulation``
under ``tune='auto'`` on the CPU with the grid narrowed to two
formulations at one unroll and one block a dispatch, and stage 2
collapsed (real probes of the kernels' plain versions), and writes its
plan and probe count.
"""

import json
import os
import subprocess
import sys
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RANK = """
import dataclasses, json, sys
from tmhpvsim_torch.config import SimConfig
from tmhpvsim_torch.engine import autotune
from tmhpvsim_torch.parallel import ShardedSimulation, distributed

rdv, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
autotune.CANDIDATE_IMPLS = ("scan", "scan2")
autotune.CANDIDATE_UNROLLS = (8,)
autotune.CANDIDATE_BLOCKS_PER_DISPATCH = (1,)
autotune.CANDIDATE_COMPUTE_DTYPES = ("f32",)
autotune.CANDIDATE_KERNEL_IMPLS = ("exact",)
autotune.CANDIDATE_RNG_BATCHES = ("scan",)
autotune.CANDIDATE_GEOM_STRIDES = (1,)
distributed.initialize(rdv, 2, rank, device="cpu")
try:
    sim = ShardedSimulation(SimConfig(
        tune="auto", start="2019-09-05 11:00:00", duration_s=240,
        n_chains=8, seed=7, block_s=60, output="reduce"), device="cpu")
    with open(out, "w") as f:
        json.dump({"plan": dataclasses.asdict(sim.plan),
                   "probes": autotune.PROBE_COUNT}, f)
finally:
    distributed.shutdown()
"""


def test_two_ranks_hold_rank_zeros_plan(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               TMHPVSIM_AUTOTUNE_CACHE=str(tmp_path / "autotune.json"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, f"file://{tmp_path}/rdv", str(r),
         str(tmp_path / f"rank{r}.json")], env=env, cwd=tmp_path,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    got = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.json") as f:
            got.append(json.load(f))
    # rank 0 probed the two formulations at the rank's 4 chains (no slab
    # axis); rank 1 nothing
    assert [g["probes"] for g in got] == [2, 0]
    p0, p1 = got[0]["plan"], got[1]["plan"]
    assert (p0["source"], p1["source"]) == ("probe", "broadcast")
    assert dict(p1, source="probe") == p0
    assert p0["slab_chains"] == 4
    with open(tmp_path / "autotune.json") as f:
        (key,) = json.load(f)
    assert key == "cpu|cpu|4|60|float32|threefry2x32|1"
