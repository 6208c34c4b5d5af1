"""Where the one-kernel scenario fold's time goes: K10 as it was before the
producer / fold split (commit b4e660c), timed whole and with one part
stripped at a time, on one card.

    python3 k10_split.py --root DIR [--out FILE]

``DIR`` holds a checkout of such a tree (``git archive b4e660c | tar -x -C
DIR``); its ``tmhpvsim_torch`` and ``chip_smoke.py`` are imported, not this
repository's.  The script builds that tree's kernels, then five variants of
its ``block_step.cuh`` (each a copy with one text patch, compiled into its
own library under the tree's git-ignored build directory):

* ``full``: the scenario epilogue as it is;
* ``step``: the row loop replaced by one read of the staged tile (the
  step, with its 61 KB stage, and nothing of the fold);
* ``no_leaf_io``: the row's statistics and risk leaves read from global
  memory only at the block's first tile and written only at its last (the
  per-tile round trips gone; the fold's arithmetic kept);
* ``no_sketch``: the per-row reset of the shared sketch (two barriers) and
  its flush to the row's global histograms gone;
* ``no_atomics``: the two shared atomics per valid sample gone (the bin
  and the exceedance slot still computed).

Each variant runs through the tree's own wrapper on chip_smoke's K10 check
block (65536 chains x 1080 s, the noon block, chip_smoke's ``k10_rows``),
timed with CUDA events at 1, 4 and 16 rows in alternating order, beside
K3's acc launch on the same block.  A part's share is the full kernel's
time less the time without it; the parts need not add up to the whole.
Prints one JSON line and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

#: the patches: variant -> [(text in block_step.cuh, replacement)]
PATCHES = {
    "full": [],
    "step": [(
        "      const int B = q.B;\n      for (int b = 0; b < B; ++b) {\n",
        "      const int B = q.B;\n"
        "      {\n"
        "        float keep = 0.0f;\n"
        "        for (int s = 0; s < TILE; ++s)\n"
        "          keep += stage_m[s * THREADS + threadIdx.x] +\n"
        "                  stage_a[s * THREADS + threadIdx.x];\n"
        "        if (live && base + TILE >= T) a.pv_sum[i] = keep;\n"
        "      }\n"
        "      for (int b = 0; b < 0; ++b) {\n")],
    "no_leaf_io": [(
        "          const int64_t o = (int64_t)b * n + i;\n"
        "          c.pv_sum = a.pv_sum[o];\n"
        "          c.pv_max = a.pv_max[o];\n"
        "          c.meter_sum = a.meter_sum[o];\n"
        "          c.residual_sum = a.residual_sum[o];\n"
        "          c.residual_min = a.residual_min[o];\n"
        "          c.residual_max = a.residual_max[o];\n"
        "          c.n_seconds = a.n_seconds[o];\n"
        "          const int64_t plane = (int64_t)B * n;\n"
        "          if (base > 0) {",
        "          const int64_t o = (int64_t)b * n + i;\n"
        "          const bool io = base == 0 || q.lolp_k < 0;\n"
        "          c.pv_sum = io ? a.pv_sum[o] : 0.0f;\n"
        "          c.pv_max = io ? a.pv_max[o] : 0.0f;\n"
        "          c.meter_sum = io ? a.meter_sum[o] : 0.0f;\n"
        "          c.residual_sum = io ? a.residual_sum[o] : 0.0f;\n"
        "          c.residual_min = io ? a.residual_min[o] : 0.0f;\n"
        "          c.residual_max = io ? a.residual_max[o] : 0.0f;\n"
        "          c.n_seconds = io ? a.n_seconds[o] : 0;\n"
        "          const int64_t plane = (int64_t)B * n;\n"
        "          if (base > 0 && q.lolp_k < 0) {"), (
        "          a.pv_sum[o] = c.pv_sum;\n",
        "          if (base + TILE >= T || q.lolp_k < 0) {\n"
        "          a.pv_sum[o] = c.pv_sum;\n"), (
        "            cf[(5 + k) * plane] = c.prev[k];\n"
        "          }\n"
        "        }\n",
        "            cf[(5 + k) * plane] = c.prev[k];\n"
        "          }\n"
        "          }\n"
        "        }\n")],
    "no_sketch": [(
        "        if (q.hist_shared) {\n"
        "          __syncthreads();  // the previous row's counts are flushed\n"
        "          for (int k = threadIdx.x; k < nbq + neq; k += blockDim.x)\n"
        "            s_hist[k] = 0;\n"
        "          __syncthreads();\n"
        "          hist = s_hist;\n",
        "        if (q.hist_shared) {\n"
        "          hist = s_hist;\n"), (
        "        if (q.hist_shared) {\n"
        "          __syncthreads();\n"
        "          flush_hist(s_hist, q.res_hist + (int64_t)b * nbq, nbq);\n"
        "          flush_hist(s_hist + nbq, q.exceed + (int64_t)b * neq, neq);\n"
        "        }\n", "")],
    "no_atomics": [(
        "              atomicAdd(&hist[(int)floorf(bf) + 1], 1);\n"
        "              int slot = 0;\n"
        "              for (int j = 0; j < q.n_thr; ++j) slot += q.thr[j] < r ? 1 : 0;\n"
        "              atomicAdd(&exc[slot], 1);\n",
        "              const int idx = (int)floorf(bf) + 1;\n"
        "              int slot = 0;\n"
        "              for (int j = 0; j < q.n_thr; ++j) slot += q.thr[j] < r ? 1 : 0;\n"
        "              c.lol_e += (idx == 0x7fffffff) + (slot == 0x7fffffff);\n")],
}
ROWS = (1, 4, 16)
ROUNDS = 3


def patched(text: str, patches) -> str:
    for old, new in patches:
        if text.count(old) != 1:
            raise SystemExit(f"k10_split: a patch does not match the tree's "
                             f"block_step.cuh once:\n{old}")
        text = text.replace(old, new)
    return text


def build_variants(build, header_dir: str) -> dict:
    """Compile every variant's block_step.cu (one nvcc each, together);
    returns {variant: library path}."""
    src = open(os.path.join(build.CSRC, "block_step.cuh")).read()
    procs, out = [], {}
    for name, patches in PATCHES.items():
        vdir = os.path.join(build.BUILD_DIR, "k10_split", name)
        os.makedirs(vdir, exist_ok=True)
        with open(os.path.join(vdir, "block_step.cuh"), "w") as f:
            f.write(patched(src, patches))
        shutil.copy(os.path.join(build.CSRC, "block_step.cu"), vdir)
        lib = os.path.join(vdir, "block_step.so")
        log = open(os.path.join(vdir, "nvcc.log"), "w")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", vdir, "-I",
               build.CSRC, "-I", header_dir, "-o", lib,
               os.path.join(vdir, "block_step.cu")]
        procs.append((name, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
        out[name] = lib
    return out, procs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="a checkout of the tree whose K10 is split")
    ap.add_argument("--out", default="chiprun_out/k10_split.json")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k10_split: needs a CUDA card")
    import chip_smoke as cs
    from tmhpvsim_torch.config import SimConfig
    from tmhpvsim_torch.engine.simulation import Simulation
    from tmhpvsim_torch.kernels import block_step as k3
    from tmhpvsim_torch.kernels import build
    from tmhpvsim_torch.serve import schema

    if not cs.__file__.startswith(root) or not build.__file__.startswith(
            root):
        raise SystemExit("k10_split: the tree's modules were not imported")
    # the kernels the check needs, and the variants, built together
    build.SOURCES = ("block_step.cu", "threefry.cu", "philox.cu",
                     "windows.cu")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    header = build.consts_header()
    gen_dir = os.path.join(build.BUILD_DIR,
                           "include-" + build._digest([header]))
    os.makedirs(gen_dir, exist_ok=True)
    with open(os.path.join(gen_dir, "consts.cuh"), "w") as f:
        f.write(header)
    libs, procs = build_variants(build, gen_dir)
    build.build_all()
    for name, log, proc in procs:
        if proc.wait() != 0:
            log.close()
            raise SystemExit(f"k10_split: nvcc failed for {name}:\n"
                             + open(log.name).read()[-4000:])
        log.close()
    for name, lib in libs.items():
        libs[name] = ctypes.CDLL(lib)
    smi = cs.smi_line()

    dev = torch.device("cuda", 0)
    cfg = SimConfig(**cs.HEADLINE)
    sim = Simulation(cfg, device=dev)
    state = sim.init_state()
    ins = sim.host_inputs(cs.K10_BLOCK)
    tables, _ = sim._windows(state, ins)
    head = cs.head_of(state, ins, tables)
    tail = (cfg.duration_s, cfg.meter_max_w, cfg.site.surface_tilt,
            cfg.site.albedo)
    rows = cs.k10_rows(cs.K10_BLOCK * cfg.block_s, cfg.duration_s)
    params = sim.scenario_fleet_params()

    def use(name):
        build._libs["block_step.cu"] = libs[name]
        build._fns.clear()
        k3._scen_size_checked.clear()

    def run(b):
        scen = schema.encode_batch(rows[:b], b, device=dev)
        acc = sim.init_scenario_acc(b)
        return lambda: k3.block_step_scenario(
            *head, cs.clone(state["carry"]), acc, *tail, scen=scen,
            params=params)

    times = {name: {b: [] for b in ROWS} for name in PATCHES}
    k3_ms = []
    order = list(PATCHES)
    for r in range(ROUNDS):
        for name in (order if r % 2 == 0 else order[::-1]):
            use(name)
            for b in ROWS:
                times[name][b].append(cs.time_ms(run(b), reps=5))
        use("full")
        k3_ms.append(cs.time_ms(lambda: k3.block_step_acc(
            *head, cs.clone(state["carry"]), sim.init_reduce_acc(), *tail),
            reps=5))
    mean = {name: {b: sum(v) / len(v) for b, v in t.items()}
            for name, t in times.items()}
    split = {}
    for b in ROWS:
        full = mean["full"][b]
        split[b] = {"full": full, "step": mean["step"][b],
                    "leaf_round_trips": full - mean["no_leaf_io"][b],
                    "sketch_reset_flush": full - mean["no_sketch"][b],
                    "per_sample_atomics": full - mean["no_atomics"][b]}
        split[b]["rest"] = full - sum(v for k, v in split[b].items()
                                      if k != "full")
    rec = {"card": smi, "rounds": ROUNDS, "k3_acc_ms": sum(k3_ms)
           / len(k3_ms), "ms": mean, "runs": times, "split": split}
    for b in ROWS:
        print(f"K10 at {b} rows: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in split[b].items()))
    print(f"K3 acc on the same block: {rec['k3_acc_ms']:.4f} ms; card {smi}")
    line = json.dumps(rec)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
