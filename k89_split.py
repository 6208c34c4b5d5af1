"""Where the fused fleet observers' time goes: the acc launch with both
observers (K8 + K9 in one launch) as it was before the observers got a
fold kernel of their own (commit ba67451), timed whole, under a register
cap, and with one per-sample piece stripped at a time, on one card.

    python3 k89_split.py --root DIR [--out FILE]

``DIR`` holds a checkout of such a tree (``git archive ba67451 | tar -x -C
DIR``); its ``tmhpvsim_torch``, ``chip_smoke.py`` and ``ab_kernels.py``
are imported, not this repository's.  The script builds that tree's
block-step libraries (the exact, table, bf16 and bf16 table sets) with an
added entry that reads each acc instantiation's registers
(``cudaFuncGetAttributes``) and CTAs per SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at 128 threads and the
launch's shared memory), then variants of ``block_step.cuh`` and
``fold.cuh`` (each a copy with one text patch, compiled into its own
library under the tree's git-ignored build directory):

* ``full``: as the tree has them;
* ``lb4``: ``__launch_bounds__(THREADS, 4)`` on the step, which caps it
  at 128 registers (4 CTAs an SM) and spills the rest;
* ``no_exc_atomic``: the exceedance slot's shared atomic gone (the slot
  still computed);
* ``no_res_coh_atomics``: the residual bin's and the cohort bin's shared
  atomics gone (the bin still computed);
* ``no_csi_atomic``: K8's csi-bin shared atomic gone;
* ``no_ramp_mod``: the three ramp grids' ``(t + 1) % w`` replaced by a
  mask test (wrong grids, the same branches).

The stripped variants' outputs are wrong: only their times count.  Each
runs through the tree's own wrapper on ``ab_kernels.py``'s noon block
(block 40, 65536 sites x 1080 s) of paths F (exact set, site geometry),
F-L (table set, stride 60) and F-H (bf16, site geometry); ``lb4`` on all
three, the strips on F's.  Timed with CUDA events (5 launches a round) in
alternating order over ``ROUNDS`` rounds.  A piece's share is the full
launch's time less the time without it.  Prints one JSON line and writes
it to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import shutil
import subprocess
import sys

#: an entry appended to every variant's block_step.cuh: the registers and
#: CTAs per SM of the acc instantiation (geo, tel, flt) at smem bytes
ATTRS = r"""
template <int GEO, bool TEL, bool FLT>
static int split_attr_one(int smem, int* out) {
  auto kernel = block_step_kernel<KSET, CDTYPE, PRNG, ACC, GEO, TEL, FLT>;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    THREADS, smem);
  out[0] = fa.numRegs;
  out[1] = per_sm;
  out[2] = (int)fa.localSizeBytes;
  return (int)e;
}

template <int GEO>
static int split_attr_geo(int tel, int flt, int smem, int* out) {
  switch ((tel ? 2 : 0) + (flt ? 1 : 0)) {
    case 0: return split_attr_one<GEO, false, false>(smem, out);
    case 1: return split_attr_one<GEO, false, true>(smem, out);
    case 2: return split_attr_one<GEO, true, false>(smem, out);
    default: return split_attr_one<GEO, true, true>(smem, out);
  }
}

extern "C" int split_attrs(int geo, int tel, int flt, int smem, int* out) {
  return geo == SHARED ? split_attr_geo<SHARED>(tel, flt, smem, out)
         : geo == SITE ? split_attr_geo<SITE>(tel, flt, smem, out)
                       : split_attr_geo<STRIDED>(tel, flt, smem, out);
}
"""

#: the patches: variant -> [(file, text, replacement)]
PATCHES = {
    "full": [],
    "lb4": [("block_step.cuh",
             "__global__ void __launch_bounds__(THREADS) block_step_kernel(",
             "__global__ void __launch_bounds__(THREADS, 4) "
             "block_step_kernel(")],
    "no_exc_atomic": [("fold.cuh", "    atomicAdd(&exc[slot], 1);\n",
                       "    if (slot == 0x7fffffff) atomicAdd(&exc[slot], "
                       "1);\n")],
    "no_res_coh_atomics": [
        ("fold.cuh", "    atomicAdd(&hist[idx], 1);\n",
         "    if (idx == 0x7fffffff) atomicAdd(&hist[idx], 1);\n"),
        ("fold.cuh",
         "    if (coh_hist != nullptr) atomicAdd(&coh_hist[cohort * (o.bins "
         "+ 2) + idx], 1);\n",
         "    if (coh_hist != nullptr && cohort == 0x7fffffff) "
         "atomicAdd(&coh_hist[idx], 1);\n")],
    "no_csi_atomic": [("block_step.cuh",
                       "            if (valid && isfinite(csi))\n",
                       "            if (valid && isfinite(csi) && "
                       "csi == 1e30f)\n")],
    "no_ramp_mod": [("fold.cuh", "if (w == 1 || (t + 1) % w == 0) {",
                     "if (w == 1 || ((t + 1) & 63) == 0) {")],
}
#: the sources each variant builds (the strips need path F's set only)
SOURCES = {"full": ("block_step.cu", "block_step_table.cu",
                    "block_step_bf16.cu", "block_step_bf16_table.cu"),
           "lb4": ("block_step.cu", "block_step_table.cu",
                   "block_step_bf16.cu")}
#: the timed launches: ab_kernels.py's case -> (library source, geometry)
CASES = {"K89": ("block_step.cu", 1), "K89L": ("block_step_table.cu", 2),
         "K12F": ("block_step_bf16.cu", 1)}
ROUNDS = 3
#: the H100's SMs, and the main path's CTAs (65536 chains / 128)
SMS, CTAS = 132, 512


def patched(text: str, patches) -> str:
    for old, new in patches:
        if text.count(old) != 1:
            raise SystemExit(f"k89_split: a patch does not match the tree "
                             f"once:\n{old}")
        text = text.replace(old, new)
    return text


def build_variants(build, header_dir: str):
    """Compile every variant's libraries (one nvcc each, together);
    returns ({(variant, source): library path}, processes)."""
    procs, out = [], {}
    for name, patches in PATCHES.items():
        vdir = os.path.join(build.BUILD_DIR, "k89_split", name)
        os.makedirs(vdir, exist_ok=True)
        for hdr in ("block_step.cuh", "fold.cuh"):
            text = open(os.path.join(build.CSRC, hdr)).read()
            text = patched(text, [(o, r) for f, o, r in patches if f == hdr])
            if hdr == "block_step.cuh":
                text += ATTRS
            with open(os.path.join(vdir, hdr), "w") as f:
                f.write(text)
        for src in SOURCES.get(name, ("block_step.cu",)):
            shutil.copy(os.path.join(build.CSRC, src), vdir)
            lib = os.path.join(vdir, src[:-3] + ".so")
            log = open(os.path.join(vdir, src[:-3] + ".nvcc.log"), "w")
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", vdir, "-I",
                   build.CSRC, "-I", header_dir, "-o", lib,
                   os.path.join(vdir, src)]
            procs.append((name, src, log, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT)))
            out[name, src] = lib
    return out, procs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="a checkout of the tree whose fused launch is split")
    ap.add_argument("--out", default="chiprun_out/k89_split.json")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k89_split: needs a CUDA card")
    import ab_kernels as ab
    import chip_smoke as cs
    from tmhpvsim_torch.kernels import block_step as k3
    from tmhpvsim_torch.kernels import build

    if not (cs.__file__.startswith(root) and build.__file__.startswith(root)
            and ab.__file__.startswith(root)):
        raise SystemExit("k89_split: the tree's modules were not imported")
    build.SOURCES = ("block_step.cu", "block_step_table.cu",
                     "block_step_bf16.cu", "block_step_bf16_table.cu",
                     "threefry.cu", "philox.cu", "windows.cu")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    header = build.consts_header()
    gen_dir = os.path.join(build.BUILD_DIR,
                           "include-" + build._digest([header]))
    os.makedirs(gen_dir, exist_ok=True)
    with open(os.path.join(gen_dir, "consts.cuh"), "w") as f:
        f.write(header)
    libs, procs = build_variants(build, gen_dir)
    build.build_all()
    for name, src, log, proc in procs:
        if proc.wait() != 0:
            log.close()
            raise SystemExit(f"k89_split: nvcc failed for {name} {src}:\n"
                             + open(log.name).read()[-4000:])
        log.close()
    libs = {k: ctypes.CDLL(v) for k, v in libs.items()}
    smi = cs.smi_line()
    dev = torch.device("cuda", 0)
    cases = ab.block_step_cases(list(CASES), dev)

    def use(name, src):
        build._libs[src] = libs[name, src]
        build._fns.clear()
        k3._obs_size_checked.clear()

    # registers and CTAs per SM of every acc instantiation of the full
    # variant's four libraries (path F's launch: 3 cohorts, 2048 bins)
    smem_f = 4 * (2048 + 2 + 8) + 4 * 3 * 2050
    attrs = {}
    for (name, src), lib in libs.items():
        if name not in ("full", "lb4"):
            continue
        fn = lib.split_attrs
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for geo in (0, 1, 2):
            for tel in (0, 1):
                for flt in (0, 1):
                    out = (ctypes.c_int * 3)()
                    rc = fn(geo, tel, flt, smem_f if flt else 0, out)
                    if rc:
                        raise SystemExit(f"k89_split: split_attrs {rc}")
                    per_sm = out[1]
                    attrs[f"{name} {src} geo{geo} tel{tel} flt{flt}"] = {
                        "regs": out[0], "ctas_per_sm": per_sm,
                        "local_bytes": out[2],
                        "waves": math.ceil(CTAS / (SMS * per_sm))
                        if per_sm else None}
    runs = [(v, c) for v in PATCHES for c in CASES
            if v in ("full", "lb4") or c == "K89"]
    times = {f"{v} {c}": [] for v, c in runs}
    for r in range(ROUNDS):
        for v, c in (runs if r % 2 == 0 else runs[::-1]):
            src = CASES[c][0]
            use(v, src)
            times[f"{v} {c}"].append(cs.time_ms(cases[c][0], reps=5))
            use("full", src)
    mean = {k: sum(t) / len(t) for k, t in times.items()}
    full = mean["full K89"]
    split = {v: full - mean[f"{v} K89"] for v in PATCHES
             if v not in ("full", "lb4")}
    rec = {"card": smi, "rounds": ROUNDS, "ms": mean, "runs": times,
           "split_k89": split, "attrs": attrs}
    for k, v in mean.items():
        print(f"{k}: {v:.4f} ms")
    for k, v in split.items():
        print(f"K89 share of {k}: {v:.4f} ms")
    for k, v in attrs.items():
        print(f"{k}: {v}")
    print(f"card {smi}")
    line = json.dumps(rec)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
