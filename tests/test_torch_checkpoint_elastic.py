"""Per-process checkpoints of a sharded run and their resume under another
process count, on the CPU: two gloo ranks (``pvsim --sharded``, one
process each) write ``PATH.host<rank>``; one process resumes them (a torn
newest generation on one rank makes it a straggler: the shards align on
their newest common block); and a whole-run checkpoint is resliced to two
ranks.  On a shared site every chain row is the unsharded port run's bit
for bit (tests/test_torch_sharded.py); the sharded run's ``ensemble`` row
sums over ranks, rtol 1e-5 / atol 1e-3.

The four rank processes start together over ``file://`` rendezvous (no
TCP port), each waited for at most ``WAIT_S``.
"""

import csv
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from tmhpvsim_torch import config as tcfg
from tmhpvsim_torch.cli import main
from tmhpvsim_torch.engine import checkpoint as ckpt
from tmhpvsim_torch.engine.simulation import Simulation as TSim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START = "2019-09-05 10:00:00"
BASE = ["--device", "cpu", "--no-realtime", "--duration", "360",
        "--start", START, "--block-s", "120", "--chains", "8", "--seed",
        "11", "--output", "reduce"]
RANKS = 2
#: seconds a rank process may take before the test fails
WAIT_S = 300


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The unsharded reference CSV, a whole-run checkpoint after block 1,
    and two rank pairs: one checkpointing from scratch (``sh``), one
    resuming the whole-run checkpoint (``rs``)."""
    d = tmp_path_factory.mktemp("elastic")
    assert main(["pvsim", str(d / "whole.csv"), *BASE]) == 0

    class Stop(Exception):
        pass

    sim = TSim(tcfg.SimConfig(start=START, duration_s=360, n_chains=8,
                              seed=11, block_s=120, output="reduce"),
               device="cpu")

    def stop_after_first(bi, state, acc):
        ckpt.save(str(d / "full.npz"), {"state": state, "acc": acc},
                  bi + 1, sim.config, layout=sim.checkpoint_layout())
        raise Stop

    with pytest.raises(Stop):
        sim.run_reduced(on_block=stop_after_first)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = []
    for tag, ck in (("sh", "sh.npz"), ("rs", "full.npz")):
        for r in range(RANKS):
            log = open(d / f"{tag}{r}.log", "w")
            procs.append((f"{tag}{r}", log, subprocess.Popen(
                [sys.executable, "-m", "tmhpvsim_torch", "pvsim",
                 f"{tag}.csv", *BASE, "--sharded", "--num-processes",
                 str(RANKS), "--process-id", str(r), "--coordinator",
                 f"file://{d}/{tag}.rdv", "--checkpoint", ck],
                env=env, cwd=d, stdout=log, stderr=subprocess.STDOUT)))
    try:
        for tag, log, p in procs:
            try:
                rc = p.wait(timeout=WAIT_S)
            except subprocess.TimeoutExpired:
                rc = "timed out"
            log.close()
            assert rc == 0, (tag, (d / f"{tag}.log").read_text())
    finally:
        for _, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return d


def test_ranks_write_per_process_files(runs):
    assert not (runs / "sh.npz").exists()
    for r in range(RANKS):
        meta = ckpt.peek_meta(str(runs / f"sh.npz.host{r}"))
        lay = meta["layout"]
        assert meta["next_block"] == 3
        assert (lay["chain_start"], lay["chain_stop"]) == (4 * r, 4 * r + 4)
        assert (lay["process_count"], lay["process_index"],
                lay["n_devices"], lay["n_chains"]) == (RANKS, r, RANKS, 8)
    assert ckpt.resumable(str(runs / "sh.npz"))


def test_one_process_resumes_the_ranks(runs, tmp_path):
    """Rank 1's newest generation is torn: the shards align on block 2
    (rank 0's older generation), and one process finishes the run with
    the unsharded run's bytes."""
    for f in os.listdir(runs):
        if f.startswith("sh.npz.host"):
            shutil.copy2(runs / f, tmp_path / f)
    # the anchor and generation 3 (copies now, no longer one inode)
    for f in ("sh.npz.host1", "sh.npz.host1.g3"):
        os.truncate(tmp_path / f, 8)
    tree, nb = ckpt.load_elastic(str(tmp_path / "sh.npz"))
    assert nb == 2
    assert tree["state"]["k_arr"].shape == (8, 2)
    out = tmp_path / "resumed.csv"
    assert main(["pvsim", str(out), *BASE, "--checkpoint",
                 str(tmp_path / "sh.npz")]) == 0
    assert out.read_bytes() == (runs / "whole.csv").read_bytes()


def test_whole_checkpoint_resliced_to_two_ranks(runs):
    """The ranks of the ``rs`` pair each took their chains of the
    whole-run checkpoint: their rows are the unsharded rows."""
    whole = _rows(runs / "whole.csv")
    parts = [_rows(runs / f"rs.csv.host{r}") for r in range(RANKS)]
    assert all(p[0] == whole[0] for p in parts)
    assert parts[0][1:-1] + parts[1][1:-1] == whole[1:-1]
    for p in parts:
        assert p[-1][0] == "ensemble"
        np.testing.assert_allclose(np.asarray(p[-1][1:], float),
                                   np.asarray(whole[-1][1:], float),
                                   rtol=1e-5, atol=1e-3)
    for r in range(RANKS):
        meta = ckpt.peek_meta(str(runs / f"full.npz.host{r}"))
        assert meta["next_block"] == 3
        assert meta["layout"]["chain_start"] == 4 * r


def test_notice_to_one_rank_stops_every_rank(tmp_path):
    """A SIGTERM to rank 0 alone, under ``--preempt-grace``, stops both
    ranks of a day's reduce run in 1440 blocks after the same block: each
    exits 0 with the resume line, and their shards' newest generations
    name one resume point."""
    import signal
    import time

    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    args = ["--device", "cpu", "--no-realtime", "--duration", "86400",
            "--start", START, "--block-s", "60", "--chains", "8", "--seed",
            "11", "--output", "reduce", "--checkpoint", "ck.npz",
            "--preempt-grace", "30", "--sharded", "--num-processes",
            str(RANKS), "--coordinator", f"file://{tmp_path}/ck.rdv"]
    procs = []
    for r in range(RANKS):
        log = open(tmp_path / f"r{r}.log", "w")
        procs.append((log, subprocess.Popen(
            [sys.executable, "-m", "tmhpvsim_torch", "pvsim", "r.csv",
             *args, "--process-id", str(r)],
            env=env, cwd=tmp_path, stdout=log, stderr=subprocess.STDOUT)))
    host0 = str(tmp_path / "ck.npz.host0")
    deadline = time.monotonic() + WAIT_S
    try:
        while ckpt.read_manifest(host0) is None:
            assert procs[0][1].poll() is None, \
                (tmp_path / "r0.log").read_text()
            assert time.monotonic() < deadline, "no checkpoint from rank 0"
            time.sleep(0.01)
        procs[0][1].send_signal(signal.SIGTERM)
        for r, (log, p) in enumerate(procs):
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timed out"
            log.close()
            text = (tmp_path / f"r{r}.log").read_text()
            assert rc == 0 and "preempted" in text, (r, rc, text)
    finally:
        for log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    blocks = [ckpt.peek_meta(str(tmp_path / f"ck.npz.host{r}"))["next_block"]
              for r in range(RANKS)]
    assert blocks[0] == blocks[1] and 1 <= blocks[0] < 1440, blocks
