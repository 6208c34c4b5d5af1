"""Time ``series_sum`` and the scenario fold of one tree of the port on the
card, to compare trees (a parent commit unpacked beside the change) in one
call.

    python3 ab_kernels.py --root DIR [--rows 16] [--rounds 3]

``--root`` is the directory that holds the ``tmhpvsim_torch`` package (and
``chip_smoke.py``) to time (default: this script's own).  Prints one JSON
line per measurement, ``{"tree": ..., "kernel": ..., ...}``:

- ``series_sum`` beside ``part.sum(1)`` on seeded ``(2, 512, 1080)``
  partials (the main path's: 65536 chains in 128-chain CTAs, 1080 s
  blocks), in turns, each ``--rounds`` times: per call (CUDA events around
  20 calls, ``chip_smoke.py``'s measure) and device time (a CUDA graph of
  20 launches, no host work between them);
- where the tree has it, ``scenario_fold`` alone at ``--rows`` rows on
  ``chip_smoke.py``'s K10 check block (65536 chains x 1080 s, the noon
  block, its ``k10_rows``, with the producer's flags), with the default
  seven exceedance thresholds and with the ten of ``MANY_THR``
  (``chip_smoke.K10_MANY_THR``), per call, each ``--rounds`` times.

Run it once per tree, alternating (parent, change, change, parent), so a
slow card or a warm cache shows as a spread between a tree's runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

#: ten ascending exceedance thresholds [W]
MANY_THR = range(-4000, 6000, 1000)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--rows", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from tmhpvsim_torch.kernels import block_step as k3

    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    def per_call_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def graph_ms(fn, reps=20, rounds=5):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(rounds):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (rounds * reps)

    def emit(**kw):
        print(json.dumps({"tree": root, **kw}), flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    part = torch.rand((2, 512, 1080), generator=gen, device=dev) * 4000.0
    times = {"series_sum": ([], []), "part.sum(1)": ([], [])}
    for _ in range(args.rounds):
        for name, fn in (("series_sum", lambda: k3.series_sum(part)),
                         ("part.sum(1)", lambda: part.sum(1))):
            times[name][0].append(per_call_ms(fn))
            times[name][1].append(graph_ms(fn))
    for name, (call, device) in times.items():
        emit(kernel=name, shape=list(part.shape), ms_per_call=call,
             device_ms=device)

    if not hasattr(k3, "scenario_fold"):
        return 0
    import chip_smoke as cs
    from tmhpvsim_torch import SimConfig
    from tmhpvsim_torch.engine.simulation import Simulation
    from tmhpvsim_torch.serve import schema

    cfg = SimConfig(**cs.HEADLINE)
    sim = Simulation(cfg, device=dev)
    state = sim.init_state()
    ins = sim.host_inputs(cs.K10_BLOCK)
    tables, _ = sim._windows(state, ins)
    head = cs.head_of(state, ins, tables)
    carry = {k: v.clone() for k, v in state["carry"].items()}
    _, meter, pv, tame = k3._scenario_producer_cuda(
        *head, carry, cfg.meter_max_w, cfg.site.surface_tilt, cfg.site.albedo)
    rows = cs.k10_rows(cs.K10_BLOCK * cfg.block_s, cfg.duration_s)
    rows = (rows * -(-args.rows // len(rows)))[:args.rows]
    scen = schema.encode_batch(rows, len(rows), device=dev)
    t = head[1][0]
    params = sim.scenario_fleet_params()
    many = dataclasses.replace(params, thresholds=tuple(
        float(x) for x in MANY_THR))
    for prm in (params, many):
        acc = sim.init_scenario_acc(len(rows))
        ms = [per_call_ms(lambda: k3.scenario_fold(
            meter, pv, t, acc, cfg.duration_s, scen=scen, params=prm,
            tame=tame), reps=5) for _ in range(args.rounds)]
        emit(kernel="scenario_fold", rows=len(rows),
             thresholds=len(prm.thresholds), ms_per_call=ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
