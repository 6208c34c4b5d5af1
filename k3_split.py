"""Where the shared-site block step's time goes: K3 (the acc launch of
path R) and K4 trace (the trace launch of path R-W) of one tree, timed
whole and with one piece of the per-second step stripped, reshaped or
taken out at a time, on one card.

    python3 k3_split.py --root DIR [--parent PDIR] [--designs]
        [--tree NAME=TDIR ...] [--rounds 3] [--out FILE]

``DIR`` holds a checkout of the tree (``git archive REV | tar -x -C
DIR``); its ``tmhpvsim_torch`` and ``chip_smoke.py`` are imported, not
this repository's.  The script builds that tree's exact-set libraries,
then variants of its headers (each a copy of ``csrc/`` with one text
patch, compiled with the tree's own nvcc flags into its own library under
the tree's git-ignored build directory).

The split (default).  Its patches match ``block_step.cuh`` of commit
78705c7 (the one-pass step before the lean step) and no later tree: DIR
must be a checkout of that commit (``git archive 78705c7``), and the
script refuses any other.  Variants:

* ``full``: as the tree has it;
* ``no_meter_hash``: the meter word a constant (no threefry hash);
* ``no_z``: z = 0 (no hash, no ``erf_inv``);
* ``no_power``: ``ac = csi * ghi_clear`` (no DISC, Hay-Davies, SAPM);
* ``no_redraw``: the renewal branch never taken;
* ``hoisted_tables``: each per-chain table pair loaded only when the
  tile's hour, day or minute index differs from the previous second's (a
  uniform branch: the indices are the CTA's);
* ``unroll2``: ``#pragma unroll 2`` on the per-second loop.

The stripped variants' outputs are wrong: only their times count.
``hoisted_tables`` and ``unroll2`` must give the full variant's bits.

``--designs`` (the patches match the lean step, this repository's):
each piece of that design taken out of the tree, every variant keeping
the bits -- ``no_night_skip``, ``no_hoisted_tables`` (the table
pairs loaded every second), ``erfinv_select`` (a select per coefficient
of ``erf_inv``'s polynomials, not a branch) and ``no_lean`` (no
instantiation takes the lean step); the acc launch is also timed on path
R's first block (``acc_night``, 00:00).

Each variant runs through the tree's own wrapper on the noon block (block
40, 65536 chains x 1080 s) of path R (``acc``) and of path R-W
(``trace``), timed with CUDA events (5 launches a round) in alternating
order over ``--rounds`` rounds.  ``--parent PDIR`` builds PDIR's step too
and times it beside the variants, which must then give its bits.  For
each variant the script prints registers, CTAs an SM (``step_attrs``) and
the spill bytes ptxas reports; ``--tree NAME=TDIR`` (repeatable) times
another checkout's unpatched step beside them, which must give the same
bits; "saved" is the reference's time (the
parent's, else ``full``) less the variant's, and ``same_bits`` compares a
SHA-256 of every output (as ``ab_kernels.py``).  Prints one JSON line and
writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys

#: the patches: variant -> [(text, replacement)] of block_step.cuh, or
#: [(header, text, replacement)] of another header of csrc/
PATCHES = {
    "full": [],
    "no_meter_hash": [("mb = tf::bits(km, (uint32_t)s);",
                       "mb = 0x9E3779B9u ^ (uint32_t)s;")],
    "no_z": [("z = tf::normal_from_bits(zb);", "z = 0.0f;")],
    "no_power": [("ac = power<KS>(csi, *P, cos_tilt, albedo);",
                  "ac = csi * P->ghi_clear;")],
    "no_redraw": [("if (sec >= total_end) {",
                   "if (sec >= total_end && sec < -1.0f) {")],
    "hoisted_tables": [
        ("  for (int base = 0; base < T; base += TILE) {\n",
         "  // the per-chain table pairs of the last indices seen\n"
         "  int ld_h = -1, ld_d = -1, ld_m = -1;\n"
         "  float cc0 = 0.0f, cc1 = 0.0f, cl0 = 0.0f, cl1 = 0.0f, "
         "ws0 = 0.0f, ws1 = 0.0f;\n"
         "  float cd0 = 0.0f, cd1 = 0.0f, ml0 = 0.0f, ml1 = 0.0f, "
         "mc0 = 0.0f, mc1 = 0.0f;\n"
         "  for (int base = 0; base < T; base += TILE) {\n"),
        ("      const float cc_t = a.t_cc[S.h * n + ii] * S.one_m_hf +\n"
         "                         a.t_cc[(S.h + 1) * n + ii] * S.hf;\n",
         "      if (S.h != ld_h || S.d != ld_d) {\n"
         "        if (S.h != ld_h) {\n"
         "          cc0 = a.t_cc[S.h * n + ii];\n"
         "          cc1 = a.t_cc[(S.h + 1) * n + ii];\n"
         "          cl0 = a.t_cloudy[S.h * n + ii];\n"
         "          cl1 = a.t_cloudy[(S.h + 1) * n + ii];\n"
         "        }\n"
         "        if (S.d != ld_d) {\n"
         "          ws0 = a.t_ws[S.d * n + ii];\n"
         "          ws1 = a.t_ws[(S.d + 1) * n + ii];\n"
         "        }\n"
         "        cd0 = a.t_cd[(S.h + S.d) * n + ii];\n"
         "        cd1 = a.t_cd[(S.h + S.d + 1) * n + ii];\n"
         "        ld_h = S.h;\n"
         "        ld_d = S.d;\n"
         "      }\n"
         "      if (S.m != ld_m) {\n"
         "        ml0 = a.t_ml[S.m * n + ii];\n"
         "        ml1 = a.t_ml[(S.m + 1) * n + ii];\n"
         "        mc0 = a.t_mc[S.m * n + ii];\n"
         "        mc1 = a.t_mc[(S.m + 1) * n + ii];\n"
         "        ld_m = S.m;\n"
         "      }\n"
         "      const float cc_t = cc0 * S.one_m_hf + cc1 * S.hf;\n"),
        ("        const float ws_t = a.t_ws[S.d * n + ii] * S.one_m_df +\n"
         "                           a.t_ws[(S.d + 1) * n + ii] * S.df;\n",
         "        const float ws_t = ws0 * S.one_m_df + ws1 * S.df;\n"),
        ("        const int cd = S.h + S.d;\n"
         "        base_v = a.t_cd[cd * n + ii] * S.one_m_df +\n"
         "                 a.t_cd[(cd + 1) * n + ii] * S.df;\n"
         "        nmin = a.t_ml[S.m * n + ii] * S.one_m_mf +\n"
         "               a.t_ml[(S.m + 1) * n + ii] * S.mf;\n"
         "      } else {\n"
         "        base_v = a.t_cloudy[S.h * n + ii] * S.one_m_hf +\n"
         "                 a.t_cloudy[(S.h + 1) * n + ii] * S.hf;\n"
         "        nmin = a.t_mc[S.m * n + ii] * S.one_m_mf +\n"
         "               a.t_mc[(S.m + 1) * n + ii] * S.mf;\n",
         "        base_v = cd0 * S.one_m_df + cd1 * S.df;\n"
         "        nmin = ml0 * S.one_m_mf + ml1 * S.mf;\n"
         "      } else {\n"
         "        base_v = cl0 * S.one_m_hf + cl1 * S.hf;\n"
         "        nmin = mc0 * S.one_m_mf + mc1 * S.mf;\n")],
    "unroll2": [("    for (int s = 0; s < TILE; ++s) {\n",
                 "#pragma unroll 2\n    for (int s = 0; s < TILE; ++s) {\n")],
}
ERFINV_BRANCH = """  float p;
  if (w < 5.0f) {
    const float ww = w - 2.5f;
    p = ERFINV_LT5[0];
#pragma unroll
    for (int i = 1; i < 9; ++i) p = fmaf(p, ww, ERFINV_LT5[i]);
  } else {
    const float ww = sqrtf(w) - 3.0f;
    p = ERFINV_GE5[0];
#pragma unroll
    for (int i = 1; i < 9; ++i) p = fmaf(p, ww, ERFINV_GE5[i]);
  }
"""
ERFINV_SELECT = """  const bool lt = w < 5.0f;
  const float ww = lt ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = lt ? ERFINV_LT5[0] : ERFINV_GE5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i)
    p = fmaf(p, ww, lt ? ERFINV_LT5[i] : ERFINV_GE5[i]);
"""
#: the ablation of the lean step (``--designs``, on a tree that has it):
#: variant -> patches taking one piece out (every variant keeps the bits)
DESIGNS = {
    "full": [],
    "no_night_skip": [("constexpr bool NIGHT_SKIP = PSO > 0.0f;",
                       "constexpr bool NIGHT_SKIP = false;")],
    "no_hoisted_tables": [
        ("if constexpr (LEAN) {  // the pairs of an index that changed",
         "if constexpr (false) {"),
        ("const float cc_t = LEAN ? cc0", "const float cc_t = false ? cc0"),
        ("if constexpr (LEAN) {\n          base_v = (covered ? cd0",
         "if constexpr (false) {\n          base_v = (covered ? cd0")],
    "erfinv_select": [("threefry.cuh", ERFINV_BRANCH, ERFINV_SELECT)],
    "no_lean": [("  return geo == SHARED && (epi == ACC",
                 "  return false && (epi == ACC")],
}
#: variants whose outputs must be the full variant's bits
SAME_BITS = ("hoisted_tables", "unroll2")
#: the timed launches: case -> (Epilogue code of step_attrs, the mangled
#: names' tails of its kernel in ptxas's log: the step's template, and the
#: two-pass kernel of a tree that has one)
CASES = {"acc": (0, ("block_step_kernelI5Exact3F322TFLi0ELi0ELb0E",
                     "block_step_two_pass_kernelI5Exact3F322TFLi0EE")),
         "trace": (2, ("block_step_kernelI5Exact3F322TFLi2ELi0ELb0E",
                       "block_step_two_pass_kernelI5Exact3F322TFLi2EE"))}
#: with ``--designs`` also path R's acc launch on its first block (00:00:
#: no clear-sky GHI in any second)
NIGHT = 0
HEADLINE = dict(start="2019-09-05 00:00:00", duration_s=86400,
                n_chains=65536, seed=0, block_s=1080, output="reduce")
NOON = 40
#: the H100's SMs, and the main path's CTAs (65536 chains / 128)
SMS, CTAS = 132, 512


def patched(text: str, patches) -> str:
    for old, new in patches:
        if text.count(old) != 1:
            raise SystemExit(f"k3_split: a patch does not match the tree "
                             f"once:\n{old}")
        text = text.replace(old, new)
    return text


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


def spills(log_path: str) -> dict:
    """ptxas's spill stores / loads of the shared-geometry acc and trace
    kernels (no telemetry) from a build log."""
    out, cur = {}, None
    for line in open(log_path):
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = next((c for c, (_, tags) in CASES.items()
                        if any(tag in m.group(1) for tag in tags)), None)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            out[cur] = {"spill_stores": int(m.group(1)),
                        "spill_loads": int(m.group(2))}
            cur = None
    return out


def build_variants(build, header_dir: str, variants):
    """Compile every variant's exact-set library (one nvcc each,
    together); ``variants``: name -> (csrc directory, patches, defines).
    Returns ({variant: (library, log)}, processes)."""
    procs, out = [], {}
    for name, (csrc, patches, defines) in variants.items():
        vdir = os.path.join(build.BUILD_DIR, "k3_split", name)
        os.makedirs(vdir, exist_ok=True)
        by_file = {}
        for p in patches:
            hdr, old, new = p if len(p) == 3 else ("block_step.cuh", *p)
            by_file.setdefault(hdr, []).append((old, new))
        # every header, so that each is included from one directory
        for hdr in (f for f in os.listdir(csrc) if f.endswith(".cuh")):
            text = open(os.path.join(csrc, hdr)).read()
            with open(os.path.join(vdir, hdr), "w") as f:
                f.write(patched(text, by_file.get(hdr, [])))
        shutil.copy(os.path.join(csrc, "block_step.cu"), vdir)
        lib = os.path.join(vdir, "block_step.so")
        log_path = os.path.join(vdir, "block_step.nvcc.log")
        log = open(log_path, "w")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, *defines, "-I", vdir,
               "-I", csrc, "-I", header_dir, "-o", lib,
               os.path.join(vdir, "block_step.cu")]
        procs.append((name, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
        out[name] = (lib, log_path)
    return out, procs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="a checkout of the tree whose step is split")
    ap.add_argument("--designs", action="store_true",
                    help="time the ablation of the tree's lean step "
                         "(DESIGNS) instead of the split, whose patches "
                         "need DIR to be a checkout of 78705c7")
    ap.add_argument("--parent", default=None,
                    help="a checkout whose unpatched step is timed beside "
                         "the variants, and whose bits they must give")
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=TDIR",
                    help="another checkout whose unpatched step is timed "
                         "beside the variants (must give the same bits)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/k3_split.json")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k3_split: needs a CUDA card")
    import chip_smoke as cs
    from tmhpvsim_torch import SimConfig
    from tmhpvsim_torch.engine.simulation import Simulation
    from tmhpvsim_torch.kernels import block_step as k3
    from tmhpvsim_torch.kernels import build

    if not (cs.__file__.startswith(root)
            and build.__file__.startswith(root)):
        raise SystemExit("k3_split: the tree's modules were not imported")
    build.SOURCES = ("block_step.cu", "threefry.cu", "windows.cu")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    header = build.consts_header()
    gen_dir = os.path.join(build.BUILD_DIR,
                           "include-" + build._digest([header]))
    os.makedirs(gen_dir, exist_ok=True)
    with open(os.path.join(gen_dir, "consts.cuh"), "w") as f:
        f.write(header)
    cases = dict(CASES)
    if args.designs:
        variants = {k: (build.CSRC, p, []) for k, p in DESIGNS.items()}
        must_match = list(DESIGNS)
        cases["acc_night"] = CASES["acc"]
    else:
        text = open(os.path.join(build.CSRC, "block_step.cuh")).read()
        if any(text.count(old) != 1 for p in PATCHES.values()
               for old, _ in p):
            raise SystemExit("k3_split: the split's patches match the "
                             "one-pass step of commit 78705c7 only; pass "
                             "--root a checkout of it (git archive 78705c7 "
                             "| tar -x -C DIR), or --designs")
        variants = {k: (build.CSRC, p, []) for k, p in PATCHES.items()}
        must_match = list(SAME_BITS)
    ref = "full"
    if args.parent is not None:
        ref = "parent"
        variants = {"parent": (os.path.join(os.path.abspath(args.parent),
                                            "tmhpvsim_torch", "csrc"),
                               [], []), **variants}
        must_match = [k for k in variants if k != "parent"
                      and (args.designs or k in SAME_BITS or k == "full")]
    else:
        must_match = [k for k in must_match if k != "full"]
    for spec in args.tree:
        name, tdir = spec.split("=", 1)
        variants[name] = (os.path.join(os.path.abspath(tdir),
                                       "tmhpvsim_torch", "csrc"), [], [])
        must_match.append(name)
    libs, procs = build_variants(build, gen_dir, variants)
    build.build_all()
    for name, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            raise SystemExit(f"k3_split: nvcc failed for {name}:\n"
                             + open(log.name).read()[-4000:])
    loaded = {k: ctypes.CDLL(lib) for k, (lib, _) in libs.items()}
    smi = cs.smi_line()
    dev = torch.device("cuda", 0)

    def use(name):
        build._libs["block_step.cu"] = loaded[name]
        build._fns.clear()

    launches = {}
    for case in cases:
        extra = {} if case != "trace" else dict(block_impl="wide",
                                                stats_fusion="split")
        cfg = SimConfig(**HEADLINE, **extra)
        sim = Simulation(cfg, device=dev)
        state = sim.init_state()
        ins = sim.host_inputs(NIGHT if case == "acc_night" else NOON)
        tables, _ = sim._windows(state, ins)
        tilt, alb, _ = sim.geometry_args(state)
        head = (tables, ins.rows_i, ins.rows_f, state["k_scan"],
                state["k_meter"])
        if case != "trace":
            def fn(sim=sim, state=state, head=head, cfg=cfg, tilt=tilt,
                   alb=alb):
                carry = {k: v.clone() for k, v in state["carry"].items()}
                return k3.block_step_acc(*head, carry, sim.init_reduce_acc(),
                                         cfg.duration_s, cfg.meter_max_w,
                                         tilt, alb)
        else:
            def fn(state=state, head=head, cfg=cfg, tilt=tilt, alb=alb):
                carry = {k: v.clone() for k, v in state["carry"].items()}
                return k3.block_step_trace(*head, carry, cfg.meter_max_w,
                                           tilt, alb)
        launches[case] = fn

    attrs, sums = {}, {}
    for name, (_, log_path) in libs.items():
        use(name)
        sp = spills(log_path)
        for case, (epi, _) in cases.items():
            fn = loaded[name].step_attrs
            fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p,
                                                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            out = (ctypes.c_int * 3)()
            rc = fn(epi, 0, 0, out, None)
            if rc:
                raise SystemExit(f"k3_split: step_attrs {rc}")
            per_sm = out[1]
            attrs[f"{name} {case}"] = {
                "regs": out[0], "ctas_per_sm": per_sm,
                "local_bytes": out[2],
                "waves": math.ceil(CTAS / (SMS * per_sm)) if per_sm else None,
                **sp.get(case.split("_")[0], {})}
            sums[f"{name} {case}"] = digest(launches[case]())
            torch.cuda.synchronize()
    runs = [(v, c) for v in variants for c in cases]
    times = {f"{v} {c}": [] for v, c in runs}
    for r in range(args.rounds):
        for v, c in (runs if r % 2 == 0 else runs[::-1]):
            use(v)
            times[f"{v} {c}"].append(cs.time_ms(launches[c], reps=5))
    use(ref)
    mean = {k: sum(t) / len(t) for k, t in times.items()}
    split = {f"{v} {c}": mean[f"{ref} {c}"] - mean[f"{v} {c}"]
             for v, c in runs if v != ref}
    same = {f"{v} {c}": sums[f"{v} {c}"] == sums[f"{ref} {c}"]
            for v in must_match for c in cases}
    rec = {"card": smi, "rounds": args.rounds, "ms": mean, "runs": times,
           "saved_ms": split, "attrs": attrs, "digest": sums,
           "same_bits": same}
    for k, v in mean.items():
        print(f"{k}: {v:.4f} ms  {attrs[k]}")
    for k, v in split.items():
        print(f"saved by {k}: {v:.4f} ms")
    for k, v in same.items():
        print(f"{k} same bits as {ref}: {v}")
    print(f"card {smi}")
    line = json.dumps(rec)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    print(line)
    if not all(same.values()):
        print("k3_split: a variant that must keep the bits does not",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
