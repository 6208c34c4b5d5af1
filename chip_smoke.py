"""Smoke run of the torch port on one NVIDIA card: build, check, measure.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build the CUDA kernels from ``tmhpvsim_torch/csrc`` (nvcc, one process
   per source) and print the card's name and power limit;
2. K1 (threefry) against its plain torch version: bit for bit at every
   launch ``init_state`` makes (on its own keys), then on 2**20 keys for
   split, fold_in, bits and uniform bit for bit and normal to 2 float32
   ULP;
3. K2 (sampler windows) against its plain version at 65536 chains: the
   two launches ``init_state`` makes, then two consecutive blocks (the
   Markov carry crosses a block);
4. K3 (the per-second block step) against its plain version at the main
   path's shape, 65536 chains x 1080 s, on 2 daylight blocks (accumulator
   and renewal carry), on the same K2 tables;
5. the main path: ``Simulation.run_reduced`` at 65536 chains x 86400 s
   with 1080 s blocks (80 blocks, a whole day), every launch counter set
   to 0 just before and read just after; then each kernel and its plain
   version timed with CUDA events at the main path's shapes;
6. the port on the card at the JAX suite's ``small_config`` shape against
   the JAX package's statistics in ``tests/data/torch_port_reference.json``
   (n_seconds exact, the rest rtol 2e-5 / atol 1e-2).

The line before the card line is the ``{"kernels": [...]}`` record; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

try:
    import torch

    from tmhpvsim_torch import kernels, rng
    from tmhpvsim_torch.config import SimConfig
    from tmhpvsim_torch.engine.simulation import Simulation
    from tmhpvsim_torch.kernels import block_step as k3
    from tmhpvsim_torch.kernels import build
    from tmhpvsim_torch.kernels import threefry as k1
    from tmhpvsim_torch.kernels import windows as k2
except ImportError as _e:
    print(f"chip_smoke: FAIL: cannot import the port ({_e}); run it from a "
          "checkout of the repository", file=sys.stderr)
    sys.exit(1)

HERE = os.path.dirname(os.path.abspath(__file__))

#: published H100 SXM peaks (NVIDIA data sheet / Hopper white paper): HBM3
#: bandwidth, float32 outside the tensor cores (an FMA counts 2), and
#: int32 (64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_I32 = 132 * 64 * 1.98e9

#: operation counts per item, read off the kernel sources: one threefry
#: hash (20 rounds of add/rotate/xor, 5 key injections) is 80 int32 ops;
#: one accurate libm transcendental (expf, logf, log1pf, acosf, cosf,
#: sinf) is counted as 16 float32 ops and powf as 32
HASH_I = 80
TRANS_F = 16
POW_F = 32
#: XLA's erfinv + the normal's uniform: 30 float ops and XLA's log1p
#: (counted as one transcendental)
NORMAL_F = 30 + TRANS_F
UNIFORM_F = 4
#: K3 per chain-second outside the random draws: 5 table lerps, the second
#: noise, csi, the DISC / Hay-Davies / SAPM / Sandia chain (one expf, one
#: logf, ~110 float ops) and the statistics fold
K3_SECOND_F = 15 + 4 + 2 + 110 + 2 * TRANS_F + 12
K3_SECOND_I = 2 * HASH_I + 10
#: K3 per chain-minute: the four fold_in key derivations
K3_MINUTE_I = 4 * HASH_I

HEADLINE = dict(start="2019-09-05 00:00:00", duration_s=86400,
                n_chains=65536, seed=0, block_s=1080, output="reduce")
#: the JAX suite's small_config (tests/test_engine.py)
SMALL = dict(start="2019-09-05 10:00:00", duration_s=7200, n_chains=3,
             seed=7, block_s=3600)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def ulp_diff(a, b) -> int:
    ai = a.contiguous().view(torch.int32).to(torch.int64)
    bi = b.contiguous().view(torch.int32).to(torch.int64)
    return int((ai - bi).abs().max()) if a.numel() else 0


def max_abs(a, b) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def time_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events, warm)."""
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


def bound(int_ops: float, f32_ops: float, nbytes: float):
    """(least milliseconds, what bounds it)."""
    times = {"operations": max(int_ops / PEAK_I32, f32_ops / PEAK_F32),
             "bytes": nbytes / PEAK_BYTES}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------


def phase_build():
    t0 = time.perf_counter()
    paths = build.build_all()
    for src in paths:
        build.library(src)
    print(f"build: {len(paths)} libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    for src, path in paths.items():
        log = path[:-3] + ".log"
        if os.path.exists(log):
            for line in open(log):
                if "registers" in line or "spill" in line:
                    print(f"  {src}: {line.strip()}")


def phase_k1(dev):
    # the launches init_state makes, on the very keys it makes them on:
    # split(root, n_chains), the per-chain 5-way and 2-way splits and the
    # two scalar uniforms
    n = HEADLINE["n_chains"]
    root = rng.split(rng.key(HEADLINE["seed"]), 2)[0].to(dev)
    chains = k1.split(root, n)
    init = [("split(root, n)", chains, rng.split(root, n))]
    s5 = k1.split(chains, 5)
    init.append(("split(chains, 5)", s5, rng.split(chains, 5)))
    k_renew = s5[:, 2, :].contiguous()
    kr = k1.split(k_renew, 2)
    init.append(("split(k_renew, 2)", kr, rng.split(k_renew, 2)))
    for j in (0, 1):
        k = kr[:, j, :].contiguous()
        init.append((f"uniform(kr[{j}])", k1.uniform(k), rng.uniform(k, ())))
    torch.cuda.synchronize()
    for what, a, b in init:
        if not torch.equal(a, b):
            fail(f"K1 {what} at init_state's shape differs from the plain "
                 "version")
    print(f"K1 vs plain at init_state's launches ({n} chains): "
          f"{len(init)} launches bit-identical")

    keys = rng.split(rng.key(1234, device=dev), 1 << 20)
    idx = torch.arange(1 << 20, device=dev) * 7919
    errs = {}
    for op, kern, plain, exact in (
            ("split", lambda: k1.split(keys, 4), lambda: rng.split(keys, 4),
             True),
            ("fold_in", lambda: k1.fold_in(keys, idx),
             lambda: rng.fold_in(keys, idx), True),
            ("bits", lambda: k1.bits(keys, 60),
             lambda: rng.random_bits(keys, (60,)), True),
            ("uniform", lambda: k1.uniform(keys, 60),
             lambda: rng.uniform(keys, (60,)), True),
            ("normal", lambda: k1.normal(keys, 60),
             lambda: rng.normal(keys, (60,)), False)):
        a, b = kern(), plain()
        torch.cuda.synchronize()
        if exact:
            if not torch.equal(a, b):
                fail(f"K1 {op} differs from the plain version")
            errs[op] = 0.0
        else:
            u = ulp_diff(a, b)
            if u > 2:
                fail(f"K1 {op} differs from the plain version by {u} ULP")
            errs[op] = max_abs(a, b)
    print(f"K1 vs plain on 2^20 keys: split/fold_in/bits/uniform exact; "
          f"normal max abs {errs['normal']:.3g}")
    return max(errs.values())


def phase_k2(dev):
    sim = Simulation(SimConfig(**HEADLINE), device=dev)
    state = sim.init_state()
    k_arr, k_min = state["k_arr"], state["k_min"]
    ones = torch.ones(sim.config.n_chains, dtype=torch.float32, device=dev)
    no_min = (torch.zeros(0, dtype=torch.int32, device=dev),
              torch.zeros(0, dtype=torch.float32, device=dev))
    err = 0.0

    def check(what, *args):
        nonlocal err
        tk, ck = k2.sampler_windows(*args)
        tp, cp = k2.windows_plain(*args)
        torch.cuda.synchronize()
        for name in tk:
            if not torch.allclose(tk[name], tp[name], rtol=1e-6, atol=1e-6):
                fail(f"K2 table {name} differs from the plain version in "
                     f"{what}: max abs {max_abs(tk[name], tp[name])}")
            err = max(err, max_abs(tk[name], tp[name]))
        if not torch.equal(ck, cp):
            fail(f"K2 Markov carry differs from the plain version in {what}")
        return ck

    # init_state's two launches (cc at hours 0-1 with ws0; the cloudy
    # pair), then two consecutive blocks so the Markov carry crosses one
    check("init cc01/ws0", k_arr, k_min, ones, ones,
          k2.Bounds(0, 2, 0, 0, 0, 0, 0, 1), *no_min)
    check("init cloudy pair", k_arr, k_min, ones, state["cc0"],
          k2.Bounds(0, 0, 2, 0, 0, 0, 0, 0), *no_min)
    cc_carry = state["cc_carry"]
    for bi in (40, 41):
        ins = sim.host_inputs(bi)
        cc_carry = check(f"block {bi}", k_arr, k_min, cc_carry, state["cc0"],
                         ins.bounds, ins.mh_idx, ins.mh_frac)
    print(f"K2 vs plain at {sim.config.n_chains} chains, init_state's 2 "
          f"launches and blocks 40-41: max abs {err:.3g}")
    return err


def phase_k3(dev):
    # the main path's shape (65536 chains x 1080 s), two daylight blocks
    cfg = SimConfig(**dict(HEADLINE, start="2019-09-05 11:00:00"))
    sim = Simulation(cfg, device=dev)
    state = sim.init_state()
    acc_k = sim.init_reduce_acc()
    acc_p = {k: v.clone() for k, v in acc_k.items()}
    carry_k = {k: v.clone() for k, v in state["carry"].items()}
    carry_p = {k: v.clone() for k, v in state["carry"].items()}
    cc_carry = state["cc_carry"]
    site = cfg.site
    for bi in (0, 1):
        ins = sim.host_inputs(bi)
        tables, cc_carry = k2.sampler_windows(
            state["k_arr"], state["k_min"], cc_carry, state["cc0"],
            ins.bounds, ins.mh_idx, ins.mh_frac)
        common = (tables, ins.rows_i, ins.rows_f, state["k_scan"],
                  state["k_meter"])
        tail = (cfg.duration_s, cfg.meter_max_w, site.surface_tilt,
                site.albedo)
        carry_k, acc_k = k3.block_step_acc(*common, carry_k, acc_k, *tail)
        carry_p, acc_p = k3.block_step_plain(*common, carry_p, acc_p, *tail)
    torch.cuda.synchronize()
    err = 0.0
    for name in acc_k:
        a, b = acc_k[name], acc_p[name]
        if name == "n_seconds":
            if not torch.equal(a, b):
                fail("K3 n_seconds differs from the plain version")
            continue
        if not torch.allclose(a, b, rtol=2e-5, atol=1e-2):
            fail(f"K3 {name} differs from the plain version: max abs "
                 f"{max_abs(a, b)}")
        err = max(err, max_abs(a, b))
    for name in carry_k:
        if not torch.allclose(carry_k[name], carry_p[name], rtol=1e-5,
                              atol=1e-3):
            fail(f"K3 renewal carry {name} differs from the plain version")
    same = int(sum(torch.equal(acc_k[k], acc_p[k]) for k in acc_k))
    print(f"K3 vs plain on 2 blocks x {cfg.n_chains} chains: max abs "
          f"{err:.3g} "
          f"({same}/7 statistics bit-identical)")
    if float(acc_k["pv_max"].max()) <= 10.0:
        fail("K3 check blocks saw no daylight")
    return err


def phase_main(dev):
    cfg = SimConfig(**HEADLINE)
    sim = Simulation(cfg, device=dev)
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    reduced = sim.run_reduced()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.name: c.launches for c in kernels.COUNTERS}
    for name, n in launches.items():
        if n == 0:
            fail(f"the main path never launched {name}")
    if not (reduced["n_seconds"] == cfg.duration_s).all():
        fail("n_seconds != duration for some chain")
    for name, v in reduced.items():
        if not np.isfinite(v).all():
            fail(f"non-finite {name}")
    pv_max = float(reduced["pv_max"].max())
    if pv_max <= 10.0:
        fail(f"fleet pv_max {pv_max} W: no daylight generation")
    rate = cfg.n_chains * cfg.duration_s / wall
    print(f"main path: {cfg.n_chains} chains x {cfg.duration_s} s in "
          f"{sim.n_blocks} blocks: {wall:.3f} s wall, {rate:.6g} site-s/s "
          f"(incl. init and host inputs); fleet pv_max {pv_max:.2f} W; "
          f"launches {launches}")
    ens = sim.ensemble_stats()
    print(f"ensemble: {json.dumps(ens)}")
    return sim, launches


def phase_timing(sim, dev):
    """Each kernel and its plain version at the main path's shapes."""
    cfg = sim.config
    n = cfg.n_chains
    state = sim.init_state()
    out = {}
    # K1: the main path's largest launch, the per-chain 5-way split
    keys = state["k_arr"]
    ms = time_ms(lambda: k1.split(keys, 5), reps=20)
    plain = time_ms(lambda: rng.split(keys, 5), reps=5)
    # a key is two 32-bit words (8 B) read or written, although the port
    # holds each word in an int64
    n_h = n * 5
    out["K1"] = (ms, plain, *bound(n_h * HASH_I, 0, n * 8 + n_h * 8))
    # K2 and K3 on a daylight block (block 40 = 12:00 local)
    ins = sim.host_inputs(40)
    args = (state["k_arr"], state["k_min"], state["cc_carry"], state["cc0"],
            ins.bounds, ins.mh_idx, ins.mh_frac)
    b = ins.bounds
    n_min = int(ins.mh_idx.shape[0])
    ms = time_ms(lambda: k2.sampler_windows(*args))
    plain = time_ms(lambda: k2.windows_plain(*args), reps=2)
    # K2 work per chain: 4 key splits; per hour a fold_in, a split and a
    # draw (AL: 1 hash + 2 logf, or t: ~8 hashes with gamma); cloudy,
    # clear-day and windspeed draws (normal: 2 hashes; gamma: ~8); two
    # minute noises (3 hashes + a normal each)
    hashes = 4 + b.n_hours * 6 + b.n_cloudy * 6 + b.n_cd * 2 + \
        b.n_days * 8 + n_min * 5
    f32 = (b.n_hours * 30 + b.n_cloudy * 40 + b.n_cd * NORMAL_F
           + b.n_days * 60 + n_min * (2 * NORMAL_F + 12))
    nbytes = n * (8 * 2 + 8) + 4 * n * (2 * b.n_hours + b.n_cd + b.n_days
                                         + 2 * n_min + 1)
    out["K2"] = (ms, plain, *bound(n * hashes * HASH_I, n * f32, nbytes))
    tables, _ = k2.sampler_windows(*args)
    carry = {k: v.clone() for k, v in state["carry"].items()}
    acc = sim.init_reduce_acc()
    T = cfg.block_s
    k3_args = (tables, ins.rows_i, ins.rows_f, state["k_scan"],
               state["k_meter"], carry, acc, cfg.duration_s, cfg.meter_max_w,
               cfg.site.surface_tilt, cfg.site.albedo)
    ms = time_ms(lambda: k3.block_step_acc(*k3_args))
    plain = time_ms(lambda: k3.block_step_plain(*k3_args), reps=1)
    int_ops = n * (T * K3_SECOND_I + (T // 60) * K3_MINUTE_I)
    f32_ops = n * T * (K3_SECOND_F + NORMAL_F + UNIFORM_F + 1)
    table_bytes = sum(t.numel() * 4 for t in tables.values())
    nbytes = (table_bytes + n * 8 * 2 + n * 4 * 10 * 2
              + ins.rows_i.numel() * 4 + ins.rows_f.numel() * 4)
    out["K3"] = (ms, plain, *bound(int_ops, f32_ops, nbytes))
    for name, (ms, plain, bms, by) in out.items():
        print(f"timing {name}: kernel {ms:.4f} ms, plain {plain:.3f} ms, "
              f"bound {bms:.4f} ms ({by})")
    t0 = time.perf_counter()
    for bi in range(sim.n_blocks):
        sim.host_inputs(bi)
    host_ms = (time.perf_counter() - t0) * 1e3 / sim.n_blocks
    print(f"timing host_inputs: {host_ms:.3f} ms per block (host clock, "
          f"mean of {sim.n_blocks})")
    return out


def phase_reference(dev):
    path = os.path.join(HERE, "tests", "data", "torch_port_reference.json")
    with open(path) as f:
        ref = json.load(f)
    if ref["config"] != SMALL:
        fail(f"reference file config {ref['config']} != {SMALL}")
    got = Simulation(SimConfig(**SMALL), device=dev).run_reduced()
    worst = 0.0
    for name, want in ref["reduced"].items():
        want = np.asarray(want)
        have = got[name]
        if name == "n_seconds":
            if not np.array_equal(have, want):
                fail("reference: n_seconds differs from the JAX package")
            continue
        if not np.allclose(have, want, rtol=2e-5, atol=1e-2):
            fail(f"reference: {name} {have} vs JAX {want}")
        worst = max(worst, float(np.max(np.abs(have - want)
                                        / np.maximum(np.abs(want), 1e-30))))
    print(f"reference: small_config on the card matches the JAX package "
          f"(max rel err {worst:.3g})")


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    dev = torch.device("cuda", 0)
    phase_build()
    smi = smi_line()
    print(f"card: {smi}")
    err1 = phase_k1(dev)
    err2 = phase_k2(dev)
    err3 = phase_k3(dev)
    sim, launches = phase_main(dev)
    timing = phase_timing(sim, dev)
    phase_reference(dev)
    src = {"K1": ("threefry_fill", "tmhpvsim_torch/csrc/threefry.cu",
                  "tmhpvsim_tpu/models/clearsky_index.py:278", err1),
           "K2": ("sampler_windows", "tmhpvsim_torch/csrc/windows.cu",
                  "tmhpvsim_tpu/engine/simulation.py:785", err2),
           "K3": ("block_step", "tmhpvsim_torch/csrc/block_step.cu",
                  "tmhpvsim_tpu/engine/simulation.py:1276", err3)}
    rows = []
    for key, (name, source, replaces, err) in src.items():
        ms, plain, bms, by = timing[key]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": bms, "bound_by": by, "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
