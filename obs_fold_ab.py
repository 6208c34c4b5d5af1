"""The observer fold's design choices, timed against each other on one
card: the csi histogram in packed registers or with warp-aggregated
atomics, the seconds of loads in flight, the register cap.

    python3 obs_fold_ab.py [--rounds 3] [--out FILE]

Builds ``tmhpvsim_torch/csrc/wide_fold.cu`` as committed and once per
other variant of ``VARIANTS`` (a copy with the variant's text patches,
each compiled with the package's flags into its own library under the
git-ignored build directory), then times each variant's ``obs_fold``
launch (without its collapses) on the acc producer's arrays of path F's noon block (block 40,
``FleetParams.synthetic(65536, seed=0)``, telemetry and analytics full,
65536 sites x 1080 s) and of path F-H's (the bf16 producer), 5 launches a
round with CUDA events, variants in alternating order.  Every variant's
collapsed outputs must equal the default build's bit for bit (the
digest of ``ab_kernels.py``), or the script fails.  Prints one JSON line
(means, each round, registers and CTAs per SM of each variant) and writes
it to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

#: the committed fold counts the csi bins in registers (CsiRegs)
CSI_REGS = """              if (valid && isfinite(csi))
                cr.add((int)nclampf(csi / 0.25f, 0.0f,
                                    (float)(CSI_BINS - 1)));
"""
#: ... and the variant with warp-aggregated shared atomics
CSI_MATCH = """              const int b = valid && isfinite(csi)
                                ? (int)nclampf(csi / 0.25f, 0.0f,
                                               (float)(CSI_BINS - 1))
                                : -1;
              const unsigned peers = __match_any_sync(__activemask(), b);
              if (b >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
                atomicAdd(&s_csi[b], __popc(peers));
"""


def chunk(k):
    """The seconds of loads in flight (committed: 4)."""
    return ("#define OBS_CHUNK 4\n", f"#define OBS_CHUNK {k}\n")


#: the register cap (committed: 4 CTAs an SM, so at most 128 registers)
MIN3 = ("__launch_bounds__(THREADS, 4)\n    obs_fold_kernel",
        "__launch_bounds__(THREADS, 3)\n    obs_fold_kernel")
#: variant -> text patches (old, new) of csrc/wide_fold.cu, each old text
#: found exactly once; "default" is the committed source
VARIANTS = {
    "default": [],
    "csi_match": [(CSI_REGS, CSI_MATCH)],
    "chunk2": [chunk(2)],
    "csi_match_chunk2": [(CSI_REGS, CSI_MATCH), chunk(2)],
    "csi_match_chunk3": [(CSI_REGS, CSI_MATCH), chunk(3)],
    "csi_match_chunk8": [(CSI_REGS, CSI_MATCH), chunk(8)],
    "csi_match_chunk2_min3": [(CSI_REGS, CSI_MATCH), chunk(2), MIN3],
}
#: the timed block (12:00) of the paths' day
NOON = 40


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/obs_fold_ab.json")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("obs_fold_ab: needs a CUDA card")
    import ab_kernels as ab
    import chip_smoke as cs
    from tmhpvsim_torch import SimConfig
    from tmhpvsim_torch.engine.simulation import Simulation
    from tmhpvsim_torch.fleet import FleetParams
    from tmhpvsim_torch.kernels import block_step as k3
    from tmhpvsim_torch.kernels import build

    paths = build.build_all()
    header = build.consts_header()
    gen_dir = os.path.join(build.BUILD_DIR,
                           "include-" + build._digest([header]))
    source = open(os.path.join(build.CSRC, "wide_fold.cu")).read()
    procs, libs = [], {}
    for name, patches in VARIANTS.items():
        vdir = os.path.join(build.BUILD_DIR, "obs_fold_ab", name)
        os.makedirs(vdir, exist_ok=True)
        text = source
        for old, new in patches:
            if text.count(old) != 1:
                raise SystemExit(f"obs_fold_ab: variant {name}'s patch "
                                 f"does not apply:\n{old}")
            text = text.replace(old, new)
        src = os.path.join(vdir, "wide_fold.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(vdir, "wide_fold.so")
        log = open(os.path.join(vdir, "nvcc.log"), "w")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC,
               "-I", gen_dir, "-o", lib, src]
        procs.append((name, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
        libs[name] = lib
    for name, log, proc in procs:
        if proc.wait() != 0:
            log.close()
            raise SystemExit(f"obs_fold_ab: nvcc failed for {name}:\n"
                             + open(log.name).read()[-4000:])
        log.close()
    libs = {k: ctypes.CDLL(v) for k, v in libs.items()}
    assert paths["wide_fold.cu"]
    smi = cs.smi_line()
    dev = torch.device("cuda", 0)

    def use(name):
        build._libs["wide_fold.cu"] = libs[name]
        build._fns.clear()
        k3._obs_size_checked.clear()

    fleet = FleetParams.synthetic(ab.HEADLINE["n_chains"], seed=0)
    cases = {}
    for label, extra in (("F", {}), ("F-H", {"compute_dtype": "bf16"})):
        cfg = SimConfig(**dict(ab.HEADLINE, fleet=fleet, telemetry="full",
                               analytics="full", **extra))
        sim = Simulation(cfg, device=dev)
        state = sim.init_state()
        ins = sim.host_inputs(NOON)
        tables, _ = sim._windows(state, ins)
        _, _, site = sim.geometry_args(state)
        obs = sim.observers(state)
        _, _, prod = k3.obs_producer(
            tables, ins.rows_i, ins.rows_f, state["k_scan"],
            state["k_meter"], cs.clone(state["carry"]), sim.init_reduce_acc(),
            cfg.duration_s, cfg.meter_max_w, None, None, site=site,
            fleet=sim.fleet_leaves(state), obs=obs,
            compute_dtype=sim.plan.compute_dtype)
        cases[label] = (prod, ins.rows_i[0], cfg.duration_s, obs)
    shapes, digests = {}, {}
    for name in VARIANTS:
        use(name)
        label = "F"
        prod, t, dur, obs = cases[label]
        shapes[name] = k3.obs_fold_attrs(ab.HEADLINE["n_chains"], obs,
                                         t.shape[0], dev)
        for label, (prod, t, dur, obs) in cases.items():
            digests[name, label] = ab.digest(k3.obs_fold(prod, t, dur, obs))
            if digests[name, label] != digests["default", label]:
                raise SystemExit(f"obs_fold_ab: variant {name} changes the "
                                 f"fold's outputs on path {label}'s block")
    times = {f"{v} {c}": [] for v in VARIANTS for c in cases}
    order = list(VARIANTS)
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            use(name)
            for label, (prod, t, dur, obs) in cases.items():
                times[f"{name} {label}"].append(cs.time_ms(
                    lambda: k3._obs_fold_launch(prod, t, dur, obs), reps=5))
    use("default")
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    rec = {"card": smi, "rounds": args.rounds, "ms": mean, "runs": times,
           "shapes": shapes}
    for k, v in mean.items():
        print(f"obs_fold {k}: {v:.4f} ms")
    for k, v in shapes.items():
        print(f"obs_fold {k}: {v}")
    print(f"card {smi}")
    line = json.dumps(rec)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
