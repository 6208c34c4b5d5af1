"""Time ``series_sum``, the scenario fold and the block step's main
instantiations of one tree of the port on the card, to compare trees (a
parent commit unpacked beside the change) in one call.

    python3 ab_kernels.py --root DIR [--rows 16] [--rounds 3]
        [--kernels K1,K1N,K2,K2P,K2U,K7R,K2M,K2H,K3,K3N,K4T,K4S,K11R,K11N,
                   K3P,K3U,K12R,K12RN,K8SL,K8SLN,K8SF,K8SFN,K12T,K6,K6s,
                   K7T,K8,K12B,K12BL,K89,K89L,K12F,K4M89,K4MF,K4MFT,KC]
        [--skip-scenario]

``--root`` is the directory that holds the ``tmhpvsim_torch`` package (and
``chip_smoke.py``) to time (default: this script's own).  Prints one JSON
line per measurement, ``{"tree": ..., "kernel": ..., ...}``:

- ``series_sum`` beside ``part.sum(1)`` on seeded ``(2, 512, 1080)``
  partials (the main path's: 65536 chains in 128-chain CTAs, 1080 s
  blocks), in turns, each ``--rounds`` times: per call (CUDA events around
  20 calls, ``chip_smoke.py``'s measure) and device time (a CUDA graph of
  20 launches, no host work between them);
- where the tree has it (and without ``--skip-scenario``),
  ``scenario_fold`` alone at ``--rows`` rows on
  ``chip_smoke.py``'s K10 check block (65536 chains x 1080 s, the noon
  block, its ``k10_rows``, with the producer's flags), with the default
  seven exceedance thresholds and with the ten of ``MANY_THR``
  (``chip_smoke.K10_MANY_THR``), per call, each ``--rounds`` times;
- each block-step launch of ``--kernels`` on its path's noon block (block
  40, 65536 chains or sites x 1080 s), per call (CUDA events around 5
  calls), each ``--rounds`` times, with ``digest``, a SHA-256 of every
  output of one launch from the same inputs (statistics, renewal carry,
  the observers' deltas), so that two trees' lines show whether their
  kernels give the same bits:

  K1   ``init_state``'s five threefry launches at 65536 chains (the
       split of the root key, the 5-way and 2-way splits, two uniforms);
  K1N  ``normal`` of 60 draws on each of 2^20 keys (the op that reaches
       ``erf_inv``);
  K2   path R's sampler windows of the noon block (threefry keys);
  K2P, K2U  the same under rbg and unsafe_rbg keys (K13 / K14 in K2);
  K7R  path F's windows with K7's per-chain regime;
  K2M, K2H  path R's windows with pieces of the work cut, to see where
       K2's time goes: K2M without the minute-noise values (no minute
       index), K2H the hours alone (the chain keys, the Markov hour loop
       and the carry; no cloudy, clear-day, windspeed or minute values);
       their outputs are not K2's, only their times count;
  K3   path R's acc launch (shared site);
  K3N  the same launch on path R's first block (00:00, night: no
       clear-sky GHI in any second);
  K4T  path R-W's trace launch (its carry, meter and pv);
  K4S  path A's series launch (the partials' sum, ``series_sum``);
  K11R path R-T's acc launch (the table set);
  K11N the same launch on path R-T's first block (00:00, night);
  K3P  path R-P's acc launch (rbg keys, K13 in K3);
  K3U  path R-U's acc launch (unsafe_rbg keys, K14 in K3);
  K12R path R-H's acc launch (bf16, telemetry light: K12 with K8);
  K12RN the same launch on path R-H's first block (00:00, night);
  K8SL, K8SLN  path R's acc launch with telemetry light (float32, K3 with
       K8 on a shared site), at noon and at 00:00;
  K8SF, K8SFN  the same with telemetry full;
  K12T path R-HW's trace launch (bf16, float32 draws);
  K6   path B's (the 256 x 256 grid of ``--site-grid
       47:55:256,6:15:256``, site geometry);
  K6s  path B-L's (that grid, ``geom_stride=60``, the table set);
  K7T  path H0's (``FleetParams.synthetic(65536, seed=0)``, no
       observer: K7's transforms with site geometry);
  K8   path H8's (that fleet, telemetry full alone: the acc launch's
       telemetry instantiation);
  K12B path B-H's (path B's grid under ``compute_dtype='bf16'``,
       telemetry light);
  K12BL path B-HL's (path B-H with ``geom_stride=60``, the table set);
  K89  path F's (that fleet, telemetry and analytics full: K7, K8 and
       K9; one fused launch on a tree before the observer fold, the acc
       producer and the observer fold on a tree with it, both with the
       collapses of ``block_step_obs``);
  K89L path F-L's (path F with ``geom_stride=60, kernel_impl='table'``);
  K12F path F-H's (path F under ``compute_dtype='bf16'``).

  K4M89 path F-W's wide fold with both observers, on the K4 trace of
       path F's noon block (the trace made once, the fold timed);
  K4MF path R-W's wide fold (the seven statistics alone), on the K4
       trace of path R's noon block;
  K4MFT path R-HW's wide fold with telemetry (light, the bf16 path's),
       on its K12 trace of that block.

  The window launches (K2, K2P, K2U, K7R, K2M, K2H) also print
  ``device_ms``: device time from a CUDA graph of 10 launches, no host
  work between them.  K2, K2P, K2U and K7R print ``attrs``: the window
  kernel's registers, CTAs an SM and its waves at 65536 chains on 132 SMs
  (where the tree has ``windows_attrs``); K4MF likewise the fold's
  (``wide_fold_attrs``).

  On a tree with the observer fold, K89, K89L and K12F also print the
  producer and the fold on their own (``ms_producer``, ``ms_fold``: the
  fold's launch without the collapses).  The launches with telemetry
  alone (K8, K12R, K8SL, ...) also print ``ms_step``: the acc launch
  without its collapse (the wrapper's collapse of the partial rows
  replaced by nothing while it is timed).  K3, K12R and K8SL (with their
  night and full twins) print ``attrs``: ``k3.step_attrs`` of their
  instantiation (registers, CTAs an SM, local bytes) and its waves at
  65536 chains on 132 SMs.

- KC, a block's chainwise collapses of the per-CTA partial rows:
  path F's three row sets (telemetry 25 leaves, analytics 15, 3
  cohorts x 6), path R-H's telemetry rows and path S's scenario rows
  (16 rows x 8 leaves), each ``(512, L)`` float64 (65536 chains in
  128-chain CTAs), seeded uniform values; through the tree's wrapper
  (``collapse_group`` where the tree has it, else ``collapse_partials``
  per set, as the tree's ``_obs_outputs`` does), per call and device
  time from a CUDA graph, beside the library's yardstick ``part.sum(0)``,
  ``part.amin(0)`` and ``part.amax(0)`` per set, with a digest of the
  wrapper's outputs.

Run it once per tree, alternating (parent, change, change, parent), so a
slow card or a warm cache shows as a spread between a tree's runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import inspect
import json
import os
import sys

#: ten ascending exceedance thresholds [W]
MANY_THR = range(-4000, 6000, 1000)
#: the paths' shape (chip_smoke.py HEADLINE) and the timed block (12:00)
HEADLINE = dict(start="2019-09-05 00:00:00", duration_s=86400,
                n_chains=65536, seed=0, block_s=1080, output="reduce")
NOON = 40
KERNELS = ("K1", "K1N", "K2", "K2P", "K2U", "K7R", "K2M", "K2H", "K3", "K3N",
           "K4T", "K4S", "K11R", "K11N", "K3P", "K3U", "K12R", "K12RN",
           "K8SL", "K8SLN", "K8SF", "K8SFN", "K12T", "K6", "K6s", "K7T", "K8",
           "K12B", "K12BL", "K89", "K89L", "K12F", "K4M89", "K4MF", "K4MFT",
           "KC")
#: the window launches (the sampler-window kernel alone)
WINDOWS = ("K2", "K2P", "K2U", "K7R", "K2M", "K2H")
#: the wide folds: each times the fold alone on its path's K4 trace
WIDE_FOLDS = ("K4M89", "K4MF", "K4MFT")
#: the cases timed on another block than the noon block
BLOCK = {"K3N": 0, "K11N": 0, "K12RN": 0, "K8SLN": 0, "K8SFN": 0}
#: the cases whose launch shape is printed: (epilogue, geometry,
#: telemetry, kernel set, compute dtype) of ``k3.step_attrs``
ATTRS = {"K3": ("acc", "shared", False, "exact", "f32"),
         "K3N": ("acc", "shared", False, "exact", "f32"),
         **{k: ("acc", "shared", True, "exact", "bf16")
            for k in ("K12R", "K12RN")},
         **{k: ("acc", "shared", True, "exact", "f32")
            for k in ("K8SL", "K8SLN", "K8SF", "K8SFN")}}
#: the CTAs of a 65536-chain launch, and the H100's SMs
CTAS_65536, SMS = 512, 132
#: KC's row sets: path F's (telemetry, analytics, 3 cohorts), path R-H's,
#: path S's (16 scenario rows); (leaves, kinds of one period)
COLLAPSE_SETS = {
    "F": ((25, (0, 0, 1, 2, 0, 0) * 4 + (0,)),
          (15, (0, 1, 2, 0, 0, 2, 2, 2, 0, 0, 0, 0, 0, 0, 0)),
          (18, (0, 0, 0, 0, 1, 2))),
    "R-H": ((25, (0, 0, 1, 2, 0, 0) * 4 + (0,)),),
    "S": ((128, (0, 1, 2, 0, 0, 2, 2, 2)),),
}


def digest(tree) -> str:
    """SHA-256 of every tensor of a (nested) dict or tuple, in key order."""
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                h.update(str(k).encode())
                walk(x[k])
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        elif x is not None:
            h.update(x.detach().cpu().contiguous().numpy().tobytes())

    walk(tree)
    return h.hexdigest()[:16]


def block_step_cases(names, dev):
    """``{name: (launch, what)}``: each a function of no argument that
    launches the block step once on its path's noon block from fresh
    copies of the same inputs and returns its outputs."""
    import torch

    from tmhpvsim_torch import SimConfig
    from tmhpvsim_torch.config import SiteGrid
    from tmhpvsim_torch.engine.simulation import Simulation
    from tmhpvsim_torch.fleet import FleetParams
    from tmhpvsim_torch.kernels import block_step as k3
    from tmhpvsim_torch.kernels import windows as k2

    grid = SiteGrid.regular((47, 55), (6, 15), 256, 256)
    from tmhpvsim_torch.kernels import wide

    fleet = FleetParams.synthetic(HEADLINE["n_chains"], seed=0) if any(
        k in names for k in ("K7R", "K7T", "K8", "K89", "K89L", "K12F",
                             "K4M89")) else None
    out = {}
    if "K1" in names or "K1N" in names:
        from tmhpvsim_torch import rng
        from tmhpvsim_torch.kernels import threefry as k1

        root = rng.split(rng.key(HEADLINE["seed"]), 2)[0].to(dev)
        keys = rng.split(rng.key(1234, device=dev), 1 << 20)

        def k1_init(root=root):
            chains = k1.split(root, HEADLINE["n_chains"])
            kr = k1.split(k1.split(chains, 5)[:, 2, :].contiguous(), 2)
            return (chains, kr, *(k1.uniform(kr[:, j, :].contiguous())
                                  for j in (0, 1)))

        if "K1" in names:
            out["K1"] = (k1_init, "init_state's threefry launches", None)
        if "K1N" in names:
            out["K1N"] = (lambda: k1.normal(keys, 60),
                          "normal on 2^20 keys x 60", None)
    configs = {
        "K2": (dict(HEADLINE), "path R's sampler windows"),
        "K2P": (dict(HEADLINE, prng_impl="rbg"), "path R-P's windows"),
        "K2U": (dict(HEADLINE, prng_impl="unsafe_rbg"),
                "path R-U's windows"),
        "K7R": (dict(HEADLINE, fleet=fleet), "path F's windows (regime)"),
        "K2M": (dict(HEADLINE), "path R's windows without minute values"),
        "K2H": (dict(HEADLINE), "path R's windows, the hours alone"),
        "K3": (dict(HEADLINE), "path R's acc launch"),
        "K3N": (dict(HEADLINE), "path R's acc launch at night"),
        "K4T": (dict(HEADLINE, block_impl="wide", stats_fusion="split"),
                "path R-W's trace launch"),
        "K4S": (dict(HEADLINE, output="ensemble"), "path A's series launch"),
        "K11R": (dict(HEADLINE, kernel_impl="table"),
                 "path R-T's acc launch"),
        "K11N": (dict(HEADLINE, kernel_impl="table"),
                 "path R-T's acc launch at night"),
        "K3P": (dict(HEADLINE, prng_impl="rbg"), "path R-P's acc launch"),
        "K3U": (dict(HEADLINE, prng_impl="unsafe_rbg"),
                "path R-U's acc launch"),
        "K12R": (dict(HEADLINE, compute_dtype="bf16", telemetry="light"),
                 "path R-H's acc launch"),
        "K12RN": (dict(HEADLINE, compute_dtype="bf16", telemetry="light"),
                  "path R-H's acc launch at night"),
        "K8SL": (dict(HEADLINE, telemetry="light"),
                 "path R's acc launch with telemetry light"),
        "K8SLN": (dict(HEADLINE, telemetry="light"),
                  "path R's acc launch with telemetry light at night"),
        "K8SF": (dict(HEADLINE, telemetry="full"),
                 "path R's acc launch with telemetry full"),
        "K8SFN": (dict(HEADLINE, telemetry="full"),
                  "path R's acc launch with telemetry full at night"),
        "K12T": (dict(HEADLINE, compute_dtype="bf16", block_impl="wide",
                      stats_fusion="split"), "path R-HW's trace launch"),
        "K6": (dict(HEADLINE, site_grid=grid), "path B's acc launch"),
        "K6s": (dict(HEADLINE, site_grid=grid, geom_stride=60,
                     kernel_impl="table"), "path B-L's acc launch"),
        "K7T": (dict(HEADLINE, fleet=fleet), "path H0's launch"),
        "K8": (dict(HEADLINE, fleet=fleet, telemetry="full"),
               "path H8's launch"),
        "K12B": (dict(HEADLINE, site_grid=grid, compute_dtype="bf16",
                      telemetry="light"), "path B-H's launch"),
        "K12BL": (dict(HEADLINE, site_grid=grid, compute_dtype="bf16",
                       telemetry="light", geom_stride=60,
                       kernel_impl="table"), "path B-HL's launch"),
        "K89": (dict(HEADLINE, fleet=fleet, telemetry="full",
                     analytics="full"), "path F's launch"),
        "K89L": (dict(HEADLINE, fleet=fleet, telemetry="full",
                      analytics="full", geom_stride=60,
                      kernel_impl="table"), "path F-L's launch"),
        "K12F": (dict(HEADLINE, fleet=fleet, telemetry="full",
                      analytics="full", compute_dtype="bf16"),
                 "path F-H's launch"),
        "K4M89": (dict(HEADLINE, fleet=fleet, telemetry="full",
                       analytics="full", block_impl="wide"),
                  "path F-W's wide fold with both observers"),
        "K4MF": (dict(HEADLINE, block_impl="wide", stats_fusion="split"),
                 "path R-W's wide fold (acc)"),
        "K4MFT": (dict(HEADLINE, compute_dtype="bf16", block_impl="wide",
                       stats_fusion="split"),
                  "path R-HW's wide fold with telemetry"),
    }
    for name in names:
        if name in ("K1", "K1N", "KC"):
            continue
        kw, what = configs[name]
        sim = Simulation(SimConfig(**kw), device=dev)
        state = sim.init_state()
        ins = sim.host_inputs(BLOCK.get(name, NOON))
        tables, _ = sim._windows(state, ins)
        tilt, alb, site = sim.geometry_args(state)
        head = (tables, ins.rows_i, ins.rows_f, state["k_scan"],
                state["k_meter"])
        tail = (sim.config.duration_s, sim.config.meter_max_w, tilt, alb)
        opts = dict(site=site, fleet=sim.fleet_leaves(state),
                    kernels=sim.plan.kernel_impl,
                    compute_dtype=sim.plan.compute_dtype,
                    layout=sim._draw_layout(), impl=sim.plan.prng_impl)
        obs = sim.observers(state)
        if name in WINDOWS:
            # the minute features on the card (no copy in a CUDA graph)
            b = ins.bounds
            mh = (ins.mh_idx.to(dev, torch.int32).contiguous(),
                  ins.mh_frac.to(dev, torch.float32).contiguous())
            if name in ("K2M", "K2H"):
                mh = (mh[0][:0], mh[1][:0])
            if name == "K2H":
                b = k2.Bounds(b.hour_lo, b.n_hours, 0, b.hour_next_lo,
                              b.cd_lo, 0, b.day_lo, 0, b.min_lo)
            regime = state["fleet"]["regime"] if sim._het_regime else None

            def windows(state=state, b=b, mh=mh, regime=regime,
                        impl=sim.plan.prng_impl):
                return k2.sampler_windows(state["k_arr"], state["k_min"],
                                          state["cc_carry"], state["cc0"], b,
                                          *mh, regime=regime, impl=impl)

            out[name] = (windows, what, None)
            continue
        if name in ("K4T", "K4S", "K12T"):
            def step(head=head, state=state, tail=tail, opts=opts,
                     trace=name != "K4S"):
                carry = {k: v.clone() for k, v in state["carry"].items()}
                if trace:
                    return k3.block_step_trace(*head, carry, *tail[1:],
                                               **opts)
                return k3.block_step_series(*head, carry, *tail[1:], **opts)

            out[name] = (step, what, None)
            continue
        if name in WIDE_FOLDS:
            _, meter, pv = k3.block_step_trace(
                *head, {k: v.clone() for k, v in state["carry"].items()},
                tail[1], tilt, alb, **opts)

            # K4MF and K4MFT merge into one accumulator, made fresh for
            # the first (the digest's) launch: no allocation in the timed
            # calls
            held = None if name == "K4M89" else sim.init_reduce_acc()

            def fold(sim=sim, meter=meter, pv=pv, ins=ins, tail=tail,
                     obs=obs, held=held):
                return wide.wide_fold(
                    meter, pv, ins.rows_i[0], tail[0],
                    sim.init_reduce_acc() if held is None else held, obs)

            out[name] = (fold, what, None)
            continue

        # a tree whose producer arrays the caller holds keeps one set, as
        # the engine does
        keep = {"held": {}} if "held" in inspect.signature(
            k3.block_step_obs).parameters else {}

        def launch(sim=sim, state=state, head=head, tail=tail, opts=opts,
                   obs=obs, keep=keep):
            carry = {k: v.clone() for k, v in state["carry"].items()}
            acc = sim.init_reduce_acc()
            if obs is None:
                return k3.block_step_acc(*head, carry, acc, *tail, **opts)
            return k3.block_step_obs(*head, carry, acc, *tail, obs=obs,
                                     **opts, **keep)

        parts = None
        if obs is not None and obs.analytics != "off" and \
                hasattr(k3, "_obs_fold_launch"):
            held = {}

            def producer(sim=sim, state=state, head=head, tail=tail,
                         opts=opts, obs=obs, held=held, keep=keep):
                carry = {k: v.clone() for k, v in state["carry"].items()}
                held["p"] = k3._obs_producer_cuda(
                    *head, carry, sim.init_reduce_acc(), *tail, obs=obs,
                    **opts, **keep)[2]

            def fold(head=head, tail=tail, obs=obs, held=held):
                return k3._obs_fold_launch(held["p"], head[1][0], tail[0],
                                           obs)

            parts = (producer, fold)
        elif obs is not None:
            def step_only(launch=launch):
                keep_outputs = k3._obs_outputs
                k3._obs_outputs = lambda obs, buf, T: buf
                try:
                    return launch()
                finally:
                    k3._obs_outputs = keep_outputs

            parts = (step_only,)
        out[name] = (launch, what, parts)
    return out


def collapse_sets(dev, gen):
    """KC's row sets: ``{path: [(part, kinds), ...]}``."""
    import torch

    return {path: [(torch.rand((CTAS_65536, L), generator=gen, device=dev,
                               dtype=torch.float64) * 4000.0 - 1000.0,
                    kinds) for L, kinds in sets]
            for path, sets in COLLAPSE_SETS.items()}


def collapse_block(k3, sets):
    """A block's collapses through the tree's wrapper: one grouped call
    where the tree has it, else one call per set."""
    if hasattr(k3, "collapse_group"):
        return k3.collapse_group(sets)
    return [k3.collapse_partials(p, k * (p.shape[1] // len(k)))
            for p, k in sets]


def library_block(sets):
    """The library's yardstick: a sum, a minimum and a maximum over the
    rows of each set."""
    return [(p.sum(0), p.amin(0), p.amax(0)) for p, _ in sets]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--rows", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--skip-scenario", action="store_true")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from tmhpvsim_torch.kernels import block_step as k3
    from tmhpvsim_torch.kernels import wide
    from tmhpvsim_torch.kernels import windows as k2

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

    names = [k for k in args.kernels.split(",") if k]
    if "KC" in names:
        for path, sets in collapse_sets(dev, gen).items():
            sums = digest(collapse_block(k3, sets))
            ms = {"wrapper": ([], []), "library": ([], [])}
            for _ in range(args.rounds):
                for key, fn in (
                        ("wrapper", lambda: collapse_block(k3, sets)),
                        ("library", lambda: library_block(sets))):
                    ms[key][0].append(per_call_ms(fn))
                    ms[key][1].append(graph_ms(fn))
            emit(kernel="KC", path=path,
                 leaves=[p.shape[1] for p, _ in sets],
                 ms_per_call=ms["wrapper"][0], device_ms=ms["wrapper"][1],
                 library_ms_per_call=ms["library"][0],
                 library_device_ms=ms["library"][1], digest=sums)
    for name, (launch, what, parts) in block_step_cases(names, dev).items():
        sums = digest(launch())
        torch.cuda.synchronize()
        ms = [per_call_ms(launch, reps=5) for _ in range(args.rounds)]
        extra = {}
        if parts is not None and len(parts) == 2:
            extra = {"ms_producer": [per_call_ms(parts[0], reps=5)
                                     for _ in range(args.rounds)],
                     "ms_fold": [per_call_ms(parts[1], reps=5)
                                 for _ in range(args.rounds)]}
        elif parts is not None:
            extra = {"ms_step": [per_call_ms(parts[0], reps=5)
                                 for _ in range(args.rounds)]}
        if name in WINDOWS:
            extra["device_ms"] = [graph_ms(launch, reps=10, rounds=3)
                                  for _ in range(args.rounds)]
        wk = {"K2": "threefry2x32", "K7R": "threefry2x32", "K2P": "rbg",
              "K2U": "unsafe_rbg"}
        if name in wk and hasattr(k2, "windows_attrs"):
            a = k2.windows_attrs(wk[name], 5)
            extra["attrs"] = dict(a, waves_65536=-(-CTAS_65536 // max(
                1, SMS * a["ctas_per_sm"])))
        if name == "K4MF" and hasattr(wide, "wide_fold_attrs"):
            a = wide.wide_fold_attrs()
            extra["attrs"] = dict(a, waves_65536=-(-CTAS_65536 // max(
                1, SMS * a["ctas_per_sm"])))
        if name in ATTRS:
            epi, geo, tel_on, ks, cdt = ATTRS[name]
            a = k3.step_attrs(epi, geo, tel_on, kernels=ks,
                              compute_dtype=cdt)
            extra["attrs"] = dict(a, waves_65536=-(-CTAS_65536 // max(
                1, SMS * a["ctas_per_sm"])))
        emit(kernel=name, launch=what, ms_per_call=ms, digest=sums, **extra)

    if args.skip_scenario or not hasattr(k3, "scenario_fold"):
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
