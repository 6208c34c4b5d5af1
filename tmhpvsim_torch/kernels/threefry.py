"""K1 wrappers: threefry2x32 split / fold_in / bits / uniform / normal.

On a CPU tensor each wrapper runs its plain torch version
(tmhpvsim_torch/rng.py); on a CUDA tensor it launches ``threefry_fill``
(csrc/threefry.cu) or raises.  ``K1.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from tmhpvsim_torch import rng
from tmhpvsim_torch.kernels import build

K1 = build.LaunchCounter("threefry_fill")

_OPS = {"split": 0, "fold_in": 1, "bits": 2, "uniform": 3, "normal": 4}


def _fill(op: str, keys: torch.Tensor, count: int, data=None):
    if keys.dtype != torch.int64 or keys.shape[-1:] != (2,):
        raise ValueError("keys must be an int64 (..., 2) tensor")
    keys = keys.contiguous()
    lead = keys.shape[:-1]
    m = keys[..., 0].numel()
    if op in ("split", "fold_in"):
        shape = lead + ((2,) if op == "fold_in" else (count, 2))
        out = torch.empty(shape, dtype=torch.int64, device=keys.device)
    else:
        dt = torch.int64 if op == "bits" else torch.float32
        out = torch.empty(lead + (count,), dtype=dt, device=keys.device)
    fn = build.entry("threefry.cu", "threefry_fill",
                     [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
    data_p = build.ptr(data) if data is not None else ctypes.c_void_p(0)
    rc = fn(_OPS[op], build.ptr(keys), data_p, m, count, build.ptr(out),
            build.stream_ptr(keys.device))
    build.check(rc, "threefry_fill")
    K1.launches += 1
    return out


def _on_card(keys: torch.Tensor) -> bool:
    if keys.device.type == "cuda":
        return True
    if keys.device.type != "cpu":
        raise ValueError(f"unsupported device {keys.device}")
    return False


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``(..., 2) -> (..., num, 2)``."""
    if _on_card(keys):
        return _fill("split", keys, num)
    return rng.split(keys, num)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """One ``fold_in`` per key; ``data`` an int or a tensor of
    ``keys.shape[:-1]``."""
    if _on_card(keys):
        d = torch.as_tensor(data, dtype=torch.int64, device=keys.device)
        d = d.expand(keys.shape[:-1]).contiguous()
        return _fill("fold_in", keys, 1, d)
    return rng.fold_in(keys, data)


def bits(keys: torch.Tensor, count: int) -> torch.Tensor:
    """32-bit draws ``(..., count)`` held in int64."""
    if _on_card(keys):
        return _fill("bits", keys, count)
    return rng.random_bits(keys, (count,))


def uniform(keys: torch.Tensor, count: int = 0) -> torch.Tensor:
    """``uniform(key, (count,))``; ``count=0`` draws one scalar per key."""
    if _on_card(keys):
        out = _fill("uniform", keys, max(count, 1))
        return out if count else out[..., 0]
    return rng.uniform(keys, (count,) if count else ())


def normal(keys: torch.Tensor, count: int = 0) -> torch.Tensor:
    """``normal(key, (count,))``; ``count=0`` draws one scalar per key."""
    if _on_card(keys):
        out = _fill("normal", keys, max(count, 1))
        return out if count else out[..., 0]
    return rng.normal(keys, (count,) if count else ())
