"""K15: the metersim producer's block of demand values (``meter_block``,
csrc/meter.cu).

Replaces the JAX package's device meter producer, ``block_vals`` of
tmhpvsim_tpu/apps/metersim.py:84-86 (``ci.meter_block`` of one root key,
models/clearsky_index.py:256-275): ``block_s`` uniform [0, ``max_w``)
values for the run's seconds ``sec0 .. sec0 + block_s - 1``, one
``fold_in`` key per minute and 60 draws per key, under each key
implementation's batching (tmhpvsim_torch/models/clearsky_index.py
``meter_block``, the plain version).

On a CPU key the wrapper runs the plain version; on a CUDA key it
launches the kernel (one launch per block) or raises.  ``K15.launches``
counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from tmhpvsim_torch import rng
from tmhpvsim_torch.kernels import build
from tmhpvsim_torch.models import clearsky_index as ci

K15 = build.LaunchCounter("meter_block")

_IMPLS = {"threefry2x32": 0, "rbg": 1, "unsafe_rbg": 2}


def meter_block(key: torch.Tensor, sec0: int, block_s: int, max_w: float,
                impl: str = "threefry2x32") -> torch.Tensor:
    """``(block_s,)`` float32 demand values of the seconds ``sec0 ..
    sec0 + block_s - 1`` (counted from the run's start) from the root
    ``key`` (``(w,)`` int64 key data of ``impl``), on ``key``'s device."""
    rng.check_keys(key, impl)
    if key.dim() != 1:
        raise ValueError(f"meter_block takes one root key, got "
                         f"{tuple(key.shape)}")
    sec0, block_s = int(sec0), int(block_s)
    if sec0 < 0 or block_s < 1:
        raise ValueError(f"need sec0 >= 0 and block_s >= 1, got {sec0}, "
                         f"{block_s}")
    if key.device.type == "cpu":
        t = sec0 + torch.arange(block_s, dtype=torch.int64)
        return ci.meter_block(key, t, max_w, impl)
    if key.device.type != "cuda":
        raise ValueError(f"unsupported device {key.device}")
    key = key.contiguous()
    out = torch.empty(block_s, dtype=torch.float32, device=key.device)
    fn = build.entry("meter.cu", "meter_block",
                     [ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32,
                      ctypes.c_uint32, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    g0 = sec0 // 60
    rc = fn(_IMPLS[impl], build.ptr(key), g0 & rng.MASK32, sec0 - 60 * g0,
            block_s, float(max_w), build.ptr(out),
            build.stream_ptr(key.device))
    build.check(rc, "meter_block")
    K15.launches += 1
    return out
