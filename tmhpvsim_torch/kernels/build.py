"""Build and load the hand-written CUDA kernels (nvcc into shared libraries,
bound with ctypes).

Each source of ``SOURCES`` — ``threefry.cu`` (K1), ``philox.cu`` (K13 and
K14's standalone derivations), ``windows.cu`` (K2, K7's regime gather,
K13's and K14's windows),
``block_step.cu`` and ``block_step_table.cu`` (the block-step template of
``block_step.cuh`` for the exact and the table kernel set),
``block_step_bf16.cu`` and ``block_step_bf16_table.cu`` (the same under
``compute_dtype='bf16'``, K12), the four ``block_step_rbg*.cu`` (the same
four under ``prng_impl='rbg'``, K13), the four ``block_step_urbg*.cu`` (under
``prng_impl='unsafe_rbg'``, K14), ``tables.cu`` (K11 on its own),
``wide_fold.cu`` (the K4 merges) and ``meter.cu`` (K15, the metersim
producer's block) — compiles, in parallel with the
others, into its own shared
library with a plain C interface, for ``sm_90a``; the headers of
``HEADERS`` key every library's hash.  The model
constants the kernels use are not copied into the sources: they are
generated from the Python models as exact float32 hex literals into
``consts.cuh`` in the build directory, so the kernels and their plain torch
versions read the same numbers.  Libraries are named by a hash of their
sources and of that header and are rebuilt only when one changes; the
build directory is ``tmhpvsim_torch/_build`` (git-ignored) unless
``set_build_dir`` (the CLI's ``--compile-cache DIR``) chooses another,
so that an installed, read-only package can build.

Compile flags: ``-fmad=false`` keeps every float multiply and add rounded
on its own, in the order the plain versions (and float32 jax) compute
them; without ``--use_fast_math`` division and square root are IEEE and
``expf`` / ``logf`` / ``powf`` / ``acosf`` are CUDA's accurate versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from tmhpvsim_torch.obs import metrics as obs_metrics

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
#: the default build directory, inside the package (git-ignored)
DEFAULT_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                 "_build")
BUILD_DIR = DEFAULT_BUILD_DIR
SOURCES = ("block_step.cu", "block_step_table.cu", "block_step_bf16.cu",
           "block_step_bf16_table.cu", "block_step_rbg.cu",
           "block_step_rbg_table.cu", "block_step_rbg_bf16.cu",
           "block_step_rbg_bf16_table.cu", "block_step_urbg.cu",
           "block_step_urbg_table.cu", "block_step_urbg_bf16.cu",
           "block_step_urbg_bf16_table.cu", "threefry.cu", "philox.cu",
           "windows.cu", "tables.cu", "wide_fold.cu", "meter.cu")
HEADERS = ("threefry.cuh", "philox.cuh", "block_step.cuh", "tables.cuh",
           "fold.cuh", "bf16.cuh", "nanminmax.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
_fns: dict = {}


class LaunchCounter:
    """How often a kernel's wrapper launched it (plain integer)."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


def set_build_dir(path) -> str:
    """Build and load the kernels' libraries under ``path`` (created when
    missing; None: the default inside the package).  Libraries already
    loaded stay loaded.  Returns the directory now in use."""
    global BUILD_DIR
    BUILD_DIR = (DEFAULT_BUILD_DIR if path is None
                 else os.path.abspath(os.path.expanduser(str(path))))
    return BUILD_DIR


def f32_literal(x) -> str:
    """An exact float32 C literal (hex) for ``x`` rounded to float32."""
    v = float(np.float32(x))
    if v == 0.0:
        return "0.0f"
    return float.hex(v) + "f"


def consts_header() -> str:
    """``consts.cuh``: every model constant the kernels read."""
    from tmhpvsim_torch import rng
    from tmhpvsim_torch.kernels import block_step, tables, windows

    lines = ["// generated from the Python models by kernels/build.py",
             "#pragma once"]
    for table in (rng.kernel_constants(), windows.kernel_constants(),
                  block_step.kernel_constants(),
                  tables.kernel_constants()):
        for name, value in table.items():
            if isinstance(value, (list, tuple)):
                vals = ", ".join(f32_literal(v) for v in value)
                lines.append(f"__constant__ float {name}[{len(value)}] "
                             f"= {{{vals}}};")
            else:
                lines.append(f"#define {name} ({f32_literal(value)})")
    return "\n".join(lines) + "\n"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(put the CUDA toolkit's bin directory on PATH)")


def _digest(parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p if isinstance(p, bytes) else p.encode())
    return h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every missing library (one nvcc per source, all at once)
    and return ``{source: path}``.  The libraries found already built
    count into ``executor.compile_warm_total``, those built here into
    ``executor.compile_cold_total`` (the current metrics registry; the
    run report's ``executor`` section, engine/compilecache.py)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    header = consts_header()
    hdr_texts = [open(os.path.join(CSRC, h), "rb").read() for h in HEADERS]
    gen_dir = os.path.join(BUILD_DIR, "include-" + _digest([header]))
    os.makedirs(gen_dir, exist_ok=True)
    # published whole, as the libraries are: a process building beside
    # this one (the ranks of a sharded run) never reads it half written
    consts = os.path.join(gen_dir, "consts.cuh")
    tmp = f"{consts}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(header)
    os.replace(tmp, consts)
    paths, procs = {}, []
    for src in SOURCES:
        text = open(os.path.join(CSRC, src), "rb").read()
        tag = _digest([text, header, *hdr_texts, " ".join(NVCC_FLAGS)])
        out = os.path.join(BUILD_DIR, f"{src[:-3]}-{tag}.so")
        paths[src] = out
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        log = open(f"{out[:-3]}.{os.getpid()}.log", "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-I", gen_dir, "-o", tmp,
               os.path.join(CSRC, src)]
        procs.append((src, out, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for src, out, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        # the log too is published whole under its one name
        os.replace(log.name, out[:-3] + ".log")
        if rc != 0:
            failed.append((src, out[:-3] + ".log"))
            continue
        os.replace(tmp, out)
    if failed:
        msgs = []
        for src, logp in failed:
            with open(logp) as f:
                msgs.append(f"--- {src} ---\n{f.read()[-4000:]}")
        raise RuntimeError("nvcc failed:\n" + "\n".join(msgs))
    reg = obs_metrics.get_registry()
    if len(paths) > len(procs):
        reg.counter("executor.compile_warm_total").inc(
            len(paths) - len(procs))
    if procs:
        reg.counter("executor.compile_cold_total").inc(len(procs))
    return paths


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source`` (building everything on first use)."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            paths = build_all()
            for src, path in paths.items():
                _libs[src] = ctypes.CDLL(path)
            lib = _libs[source]
        return lib


def entry(source: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``name`` of ``source``'s library, typed once on first
    use: ``argtypes`` followed by the trailing ``cudaStream_t``, returning
    an ``int`` (a ``cudaError_t``)."""
    fn = _fns.get((source, name))
    if fn is None:
        fn = getattr(library(source), name)
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[(source, name)] = fn
    return fn


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> int:
    """The address of ``device``'s current CUDA stream (a ``cudaStream_t``),
    read without building a ``torch.cuda.Stream`` (a launch of a few
    microseconds is bounded by its wrapper's host work).  The kernels
    launch on the thread's current device, so a ``device`` that is not
    the current one is refused: its tensors live on another card (a
    rank's card is made current by ``parallel.distributed``)."""
    import torch

    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index != current:
        raise RuntimeError(
            f"a kernel for cuda:{index} would launch on the current device "
            f"cuda:{current}; make it current first "
            f"(torch.cuda.set_device({index}))")
    return torch._C._cuda_getCurrentRawStream(index)
