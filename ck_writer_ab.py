"""Time the async checkpoint writer of one tree of the port on the card, to
compare two trees (one unpacked beside the other) in one call.

    python3 ck_writer_ab.py --root DIR --rounds 3 --build-dir DIR

``--root`` is the directory that holds the ``tmhpvsim_torch`` package to
time (default: this script's own); ``--build-dir`` is where the kernels
are built (two trees with the same kernel sources share it).  The run is
path R of ``chip_smoke.py``: 65536 chains x 86400 s in 1080-s blocks,
seed 0, reduce.  After one warm-up run, each round times four runs, in
turns (the order reversed every other round):

- ``loop none`` / ``loop async``: ``Simulation.run_reduced`` with an
  ``on_block`` that does nothing or hands ``{"state", "acc"}`` to the
  tree's ``AsyncCheckpointWriter.submit`` after every block; the wall from
  a synchronised card to a synchronised card, the writer's ``close``
  (its drain) timed apart;
- ``cli none`` / ``cli async``: ``python -m tmhpvsim_torch pvsim`` called
  in process (``cli.main``), without checkpoints or with ``--checkpoint
  --checkpoint-async on``; the wall of the call, the CSV and the writer's
  start and drain included.

Prints the card's name and power limit, then one JSON line: ``{"tree":
..., "walls_s": {mode: [...]}, "drains_s": [...], "saves": [...],
"dropped": [...]}`` (the async runs' generations written and snapshots
dropped, from the metrics registry and the run reports).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HEADLINE = dict(start="2019-09-05 00:00:00", duration_s=86400,
                n_chains=65536, seed=0, block_s=1080, output="reduce")
CLI_ARGS = ["--output", "reduce", "--no-realtime", "--chains", "65536",
            "--duration", "86400", "--start", HEADLINE["start"],
            "--block-s", "1080", "--seed", "0"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--build-dir", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    from tmhpvsim_torch.cli import main as cli
    from tmhpvsim_torch.config import SimConfig
    from tmhpvsim_torch.engine import checkpoint as ckpt
    from tmhpvsim_torch.engine.simulation import Simulation
    from tmhpvsim_torch.kernels import build
    from tmhpvsim_torch.obs.metrics import MetricsRegistry, use_registry

    if not torch.cuda.is_available():
        print("ck_writer_ab: no CUDA card", file=sys.stderr)
        return 1
    if not os.path.abspath(ckpt.__file__).startswith(root + os.sep):
        print(f"ck_writer_ab: imported {ckpt.__file__}, not {root}'s",
              file=sys.stderr)
        return 1
    if args.build_dir:
        build.set_build_dir(args.build_dir)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    cfg = SimConfig(**HEADLINE)
    d = tempfile.mkdtemp(prefix="ck_writer_ab_")
    walls = {m: [] for m in ("loop none", "loop async", "cli none",
                             "cli async")}
    drains, saves, dropped = [], [], []

    def loop(mode, tag):
        sim = Simulation(cfg, device=dev)
        reg = MetricsRegistry()
        with use_registry(reg):
            w = (ckpt.AsyncCheckpointWriter(
                os.path.join(d, f"loop{tag}.npz"), config=sim.config)
                if mode == "async" else None)

            def cb(bi, state, acc):
                if w is not None:
                    w.submit({"state": state, "acc": acc}, bi + 1)

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.run_reduced(on_block=cb)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if w is not None:
                t1 = time.perf_counter()
                w.close(timeout=300)
                drains.append(time.perf_counter() - t1)
                c = reg.snapshot()["counters"]
                saves.append(c.get("checkpoint.async_saves_total", 0))
                dropped.append(c.get("checkpoint.async_dropped_total", 0))
        return wall

    def run_cli(mode, tag):
        out = os.path.join(d, f"cli{tag}.csv")
        extra = [] if mode == "none" else [
            "--checkpoint", os.path.join(d, f"cli{tag}.npz"),
            "--checkpoint-async", "on", "--run-report",
            os.path.join(d, f"cli{tag}.json")]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli(["pvsim", out, *CLI_ARGS, *extra])
        wall = time.perf_counter() - t0
        if rc != 0:
            raise SystemExit(f"ck_writer_ab: the CLI returned {rc}")
        if mode != "none":
            with open(os.path.join(d, f"cli{tag}.json")) as f:
                sec = json.load(f)["checkpoint"]
            saves.append(sec.get("saves"))
            dropped.append(sec.get("async_dropped"))
        return wall

    try:
        loop("async", "warm")
        run_cli("async", "warm")
        drains.clear(), saves.clear(), dropped.clear()
        kinds = list(walls)
        for rnd in range(args.rounds):
            for kind in (kinds if rnd % 2 == 0 else kinds[::-1]):
                where, mode = kind.split()
                fn = loop if where == "loop" else run_cli
                walls[kind].append(fn(mode, f"{mode}{rnd}"))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(json.dumps({"tree": root, "walls_s": walls, "drains_s": drains,
                      "saves": saves, "dropped": dropped,
                      "medians_s": {k: float(np.median(v))
                                    for k, v in walls.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
