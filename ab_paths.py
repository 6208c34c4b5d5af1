"""Time reduce paths of one tree of the port on the card, to compare two
trees (a parent commit unpacked beside the change) in one call.

    python3 ab_paths.py --root DIR --paths F,H8,R-H --reps 3

``--root`` is the directory that holds the ``tmhpvsim_torch`` package to
time (default: this script's own).  Each path is run once to warm up (the
kernels' build, the sentinel's first imports), then ``--reps`` times; a
run's wall is ``run_reduced`` (``run_ensemble`` for A, A-W) from a
synchronised card to a synchronised card, as ``chip_smoke.py``'s paths
measure it.  Prints one JSON line per path: ``{"tree": ..., "path": ..., "walls_s": [...]}``.  Paths (the shapes
of ``chip_smoke.py``'s paths of the same names):

- R: 65536 chains x 86400 s, shared site, float32, no observer;
- F: path R's shape on ``FleetParams.synthetic(65536, seed=0)``, telemetry
  and analytics full;
- H8: path F's fleet over 3 blocks from 11:00, telemetry full;
- R-H: path R with ``compute_dtype='bf16'`` and a strict sentinel;
- B: path R's shape over the 256 x 256 site grid of ``--site-grid
  47:55:256,6:15:256`` (the per-chain geometry);
- B-L: path B with ``geom_stride=60, kernel_impl='table'``;
- F-H: path F with ``compute_dtype='bf16'`` and a strict sentinel;
- F-L: path F with ``geom_stride=60, kernel_impl='table'``;
- F-W: path F with ``block_impl='wide'`` (the trace, then the wide fold
  with both observers);
- R-W: path R with ``block_impl='wide', stats_fusion='split'`` (the K4
  trace, then the wide fold);
- R-T: path R with ``kernel_impl='table'``;
- R-P, R-U: path R with rbg and unsafe_rbg keys;
- A, A-W: path R's shape as an ensemble (``run_ensemble``: the K4 series
  and ``series_sum``; with ``block_impl='wide'`` the K4 trace and the wide
  series);
- S: the tree's ``chip_smoke.py`` path S (an in-process scenario server,
  window batching, 16 clients x 2 requests at 65536 chains x 86400 s);
  its wall is the burst's, from the first request to the last reply, as
  that script prints it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HEADLINE = dict(start="2019-09-05 00:00:00", duration_s=86400,
                n_chains=65536, seed=0, block_s=1080, output="reduce")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--paths", default="R,F,H8,R-H")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from tmhpvsim_torch import SimConfig
    from tmhpvsim_torch.config import SiteGrid
    from tmhpvsim_torch.engine.simulation import Simulation
    from tmhpvsim_torch.fleet import FleetParams
    from tmhpvsim_torch.kernels import build

    if not torch.cuda.is_available():
        print("ab_paths: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    build.build_all()
    fleet = None
    grid = SiteGrid.regular((47, 55), (6, 15), 256, 256)

    def config(name):
        nonlocal fleet
        if name in ("F", "H8", "F-H", "F-L", "F-W") and fleet is None:
            fleet = FleetParams.synthetic(HEADLINE["n_chains"], seed=0)
        return {
            "R": lambda: dict(HEADLINE),
            "F": lambda: dict(HEADLINE, fleet=fleet, telemetry="full",
                              analytics="full"),
            "H8": lambda: dict(HEADLINE, start="2019-09-05 11:00:00",
                               duration_s=3 * HEADLINE["block_s"],
                               fleet=fleet, telemetry="full"),
            "R-H": lambda: dict(HEADLINE, compute_dtype="bf16",
                                telemetry_strict=True),
            "B": lambda: dict(HEADLINE, site_grid=grid),
            "B-L": lambda: dict(HEADLINE, site_grid=grid, geom_stride=60,
                                kernel_impl="table"),
            "F-H": lambda: dict(HEADLINE, fleet=fleet, telemetry="full",
                                analytics="full", compute_dtype="bf16",
                                telemetry_strict=True),
            "F-L": lambda: dict(HEADLINE, fleet=fleet, telemetry="full",
                                analytics="full", geom_stride=60,
                                kernel_impl="table"),
            "F-W": lambda: dict(HEADLINE, fleet=fleet, telemetry="full",
                                analytics="full", block_impl="wide"),
            "R-W": lambda: dict(HEADLINE, block_impl="wide",
                                stats_fusion="split"),
            "R-T": lambda: dict(HEADLINE, kernel_impl="table"),
            "R-P": lambda: dict(HEADLINE, prng_impl="rbg"),
            "R-U": lambda: dict(HEADLINE, prng_impl="unsafe_rbg"),
            "A": lambda: dict(HEADLINE, output="ensemble"),
            "A-W": lambda: dict(HEADLINE, output="ensemble",
                                block_impl="wide"),
        }[name]()

    for name in args.paths.split(","):
        if name == "S":
            print(json.dumps({"tree": args.root, "path": name,
                              "walls_s": serve_walls(dev, args.reps)}),
                  flush=True)
            continue
        cfg = SimConfig(**config(name))
        walls = []
        for rep in range(args.reps + 1):
            sim = Simulation(cfg, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name.startswith("A"):
                for _ in sim.run_ensemble():
                    pass
            else:
                sim.run_reduced()
            torch.cuda.synchronize()
            if rep:
                walls.append(time.perf_counter() - t0)
        print(json.dumps({"tree": args.root, "path": name, "walls_s": walls}),
              flush=True)
    return 0


def serve_walls(dev, reps):
    """Path S's burst walls (after one run to warm up), from the tree's
    ``chip_smoke.phase_path_s``."""
    import contextlib
    import io
    import re

    import chip_smoke as cs

    walls = []
    for rep in range(reps + 1):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cs.phase_path_s("S", "window", dev)
        if rep:
            walls.append(float(re.search(r"([\d.]+) s wall for",
                                         out.getvalue()).group(1)))
    return walls


if __name__ == "__main__":
    sys.exit(main())
