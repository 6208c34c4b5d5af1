"""K1 and K13 wrappers: split / fold_in / bits / uniform / normal.

K1 is threefry2x32 (``threefry_fill``, csrc/threefry.cu).  K13 is the
Philox4x32-10 bits of ``prng_impl='rbg'`` keys (``philox_fill``,
csrc/philox.cu with csrc/philox.cuh; replaces the XLA ``RngBitGenerator``
behind ``jax.random.key(seed, impl='rbg')``, tmhpvsim_tpu/engine/
simulation.py:333): rbg keys are ``(..., 4)``, split and folded by K1 on
each 2-word half, their draws taken under jax's batching rule (the first
key's stream, flat) unless ``per_key``.

On a CPU tensor each wrapper runs its plain torch version
(tmhpvsim_torch/rng.py); on a CUDA tensor it launches its kernel or
raises.  ``K1.launches`` and ``K13.launches`` count the launches.
"""

from __future__ import annotations

import ctypes

import torch

from tmhpvsim_torch import rng
from tmhpvsim_torch.kernels import build

K1 = build.LaunchCounter("threefry_fill")
K13 = build.LaunchCounter("philox_fill")

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
    """``(..., 2) -> (..., num, 2)``; rbg ``(..., 4) -> (..., num, 4)``
    (K1 on each half)."""
    if _on_card(keys):
        if rng.is_rbg(keys):
            h = split(keys.reshape(*keys.shape[:-1], 2, 2), num)
            return h.transpose(-3, -2).reshape(*keys.shape[:-1], num, 4)
        return _fill("split", keys, num)
    return rng.split(keys, num)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """One ``fold_in`` per key; ``data`` an int or a tensor of
    ``keys.shape[:-1]``; rbg keys fold it into each half (K1)."""
    if _on_card(keys):
        d = torch.as_tensor(data, dtype=torch.int64, device=keys.device)
        d = d.expand(keys.shape[:-1]).contiguous()
        if rng.is_rbg(keys):
            h = keys.reshape(*keys.shape[:-1], 2, 2)
            f = _fill("fold_in", h,
                      1, d[..., None].expand(h.shape[:-1]).contiguous())
            return f.reshape(*keys.shape[:-1], 4)
        return _fill("fold_in", keys, 1, d)
    return rng.fold_in(keys, data)


_PH_OPS = {"bits": 0, "uniform": 1, "normal": 2}


def philox_fill(op: str, keys: torch.Tensor, count: int,
                per_key: bool = False, word0: int = 0) -> torch.Tensor:
    """K13 on the card: ``count`` draws per key row (``per_key``: word
    ``word0 + j`` of each key's own stream) or the batch ``(..., count)``
    flat from the first key (words ``word0 + idx``, jax's batching rule);
    ``op`` 'bits' (int64), 'uniform' or 'normal' (float32)."""
    if keys.device.type != "cuda":
        raise ValueError("philox_fill launches on the card only")
    if keys.dtype != torch.int64 or keys.shape[-1:] != (4,):
        raise ValueError("keys must be an int64 (..., 4) tensor")
    keys = keys.contiguous()
    lead = keys.shape[:-1]
    m = keys[..., 0].numel()
    dt = torch.int64 if op == "bits" else torch.float32
    out = torch.empty(lead + (count,), dtype=dt, device=keys.device)
    fn = build.entry("philox.cu", "philox_fill",
                     [ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_void_p])
    rc = fn(_PH_OPS[op], build.ptr(keys), m, count, int(per_key),
            int(word0), build.ptr(out), build.stream_ptr(keys.device))
    build.check(rc, "philox_fill")
    K13.launches += 1
    return out


def bits(keys: torch.Tensor, count: int) -> torch.Tensor:
    """32-bit draws ``(..., count)`` held in int64 (rbg keys: the batch's
    draw, as jax's vmap makes it)."""
    if _on_card(keys):
        if rng.is_rbg(keys):
            return philox_fill("bits", keys, count)
        return _fill("bits", keys, count)
    return rng.random_bits(keys, (count,))


def uniform(keys: torch.Tensor, count: int = 0) -> torch.Tensor:
    """``uniform(key, (count,))``; ``count=0`` draws one scalar per key
    (rbg keys: the batch's draw, as jax's vmap makes it)."""
    if _on_card(keys):
        if rng.is_rbg(keys):
            out = philox_fill("uniform", keys, max(count, 1))
            return out if count else out[..., 0]
        out = _fill("uniform", keys, max(count, 1))
        return out if count else out[..., 0]
    return rng.uniform(keys, (count,) if count else ())


def normal(keys: torch.Tensor, count: int = 0) -> torch.Tensor:
    """``normal(key, (count,))``; ``count=0`` draws one scalar per key
    (rbg keys: the batch's draw, as jax's vmap makes it)."""
    if _on_card(keys):
        if rng.is_rbg(keys):
            out = philox_fill("normal", keys, max(count, 1))
            return out if count else out[..., 0]
        out = _fill("normal", keys, max(count, 1))
        return out if count else out[..., 0]
    return rng.normal(keys, (count,) if count else ())
