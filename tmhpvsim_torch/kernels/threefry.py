"""K1, K13 and K14 wrappers: split / fold_in / bits / uniform / normal.

K1 is threefry2x32 (``threefry_fill``, csrc/threefry.cu).  K13 is the
Philox4x32-10 bits of ``prng_impl='rbg'`` and ``'unsafe_rbg'`` keys
(``philox_fill``, csrc/philox.cu with csrc/philox.cuh; replaces the XLA
``RngBitGenerator`` behind ``jax.random.key(seed, impl='rbg')``,
tmhpvsim_tpu/engine/simulation.py:333): those keys are ``(..., 4)``, their
draws taken under jax's batching rule (the first key's stream, flat)
unless ``per_key``.  rbg keys are split and folded by K1 on each 2-word
half; unsafe_rbg keys by K14 (``philox_derive``, csrc/philox.cu), whose
split and fold_in are Philox rows themselves (jax/_src/prng.py
``_unsafe_rbg_split`` / ``_unsafe_rbg_fold_in``), batched as jax's vmap
batches them (tmhpvsim_torch/rng.py).

Every wrapper takes the key implementation ``impl`` (the run's
``prng_impl``) and refuses keys of another width.  On a CPU tensor each
wrapper runs its plain torch version (tmhpvsim_torch/rng.py); on a CUDA
tensor it launches its kernel or raises.  ``K1.launches``,
``K13.launches`` and ``K14.launches`` count the launches.
"""

from __future__ import annotations

import ctypes

import torch

from tmhpvsim_torch import rng
from tmhpvsim_torch.kernels import build

K1 = build.LaunchCounter("threefry_fill")
K13 = build.LaunchCounter("philox_fill")
K14 = build.LaunchCounter("philox_derive")

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


_TF = "threefry2x32"


def _derive(op: str, keys: torch.Tensor, num: int = 1, batched: bool = True,
            data: torch.Tensor = None, pos: torch.Tensor = None
            ) -> torch.Tensor:
    """K14 on the card: unsafe_rbg ``split`` of ``(m, 4)`` keys into
    ``(m, num, 4)`` (``batched``: every row from the first key at counter
    ``10 (row num + i)``; else each key's own rows ``10 i``), or
    ``fold_in``: ``keys[r] ^`` row ``10 pos[r] + 9`` of the seed of
    ``data[0]``."""
    keys = keys.contiguous()
    m = keys.shape[0]
    if op == "split":
        out = torch.empty((m, num, 4), dtype=torch.int64, device=keys.device)
    else:
        out = torch.empty_like(keys)
    fn = build.entry("philox.cu", "philox_derive",
                     [ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p])
    null = ctypes.c_void_p(0)
    rc = fn(0 if op == "split" else 1, build.ptr(keys), m, num,
            int(batched),
            build.ptr(data) if data is not None else null,
            build.ptr(pos) if pos is not None else null, build.ptr(out),
            build.stream_ptr(keys.device))
    build.check(rc, "philox_derive")
    K14.launches += 1
    return out


def split(keys: torch.Tensor, num: int = 2, impl: str = _TF,
          per_key: bool = False) -> torch.Tensor:
    """``(..., w) -> (..., num, w)``: threefry (K1), rbg (K1 on each
    half) or unsafe_rbg (K14, batched over the leading dims unless
    ``per_key``)."""
    rng.check_keys(keys, impl)
    if not _on_card(keys):
        return rng.split(keys, num, impl, per_key)
    lead = keys.shape[:-1]
    if impl == "unsafe_rbg":
        batched = bool(lead) and not per_key
        out = _derive("split", keys.reshape(-1, 4), num, batched)
        return out.reshape(*lead, num, 4)
    if impl == "rbg":
        h = split(keys.reshape(*lead, 2, 2), num)
        return h.transpose(-3, -2).reshape(*lead, num, 4)
    return _fill("split", keys, num)


def fold_in(keys: torch.Tensor, data, impl: str = _TF) -> torch.Tensor:
    """One ``fold_in`` per key; ``data`` an int or a tensor broadcasting
    against ``keys.shape[:-1]``; rbg keys fold it into each half (K1);
    unsafe_rbg keys take a row of the datum's seed (K14; a batch of data
    from the first datum's, at its flat position)."""
    rng.check_keys(keys, impl)
    if not _on_card(keys):
        return rng.fold_in(keys, data, impl)
    d = torch.as_tensor(data, dtype=torch.int64, device=keys.device)
    shape = torch.broadcast_shapes(keys.shape[:-1], d.shape)
    if impl == "unsafe_rbg":
        pos = rng.positions(d.shape, d.device).expand(shape)
        k = keys.expand(*shape, 4).reshape(-1, 4)
        out = _derive("fold_in", k, data=d.reshape(-1)[:1].contiguous(),
                      pos=pos.reshape(-1).contiguous())
        return out.reshape(*shape, 4)
    d = d.expand(shape).contiguous()
    keys = keys.expand(*shape, keys.shape[-1])
    if impl == "rbg":
        h = keys.reshape(*shape, 2, 2)
        f = _fill("fold_in", h,
                  1, d[..., None].expand(h.shape[:-1]).contiguous())
        return f.reshape(*shape, 4)
    return _fill("fold_in", keys, 1, d)


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


def _draw(op: str, keys: torch.Tensor, count: int, impl: str):
    rng.check_keys(keys, impl)
    if impl == _TF:
        return _fill(op, keys, count)
    return philox_fill(op, keys, count)


def bits(keys: torch.Tensor, count: int, impl: str = _TF) -> torch.Tensor:
    """32-bit draws ``(..., count)`` held in int64 (rbg / unsafe_rbg keys:
    the batch's draw, as jax's vmap makes it)."""
    if _on_card(keys):
        return _draw("bits", keys, count, impl)
    return rng.random_bits(keys, (count,), impl=impl)


def uniform(keys: torch.Tensor, count: int = 0, impl: str = _TF
            ) -> torch.Tensor:
    """``uniform(key, (count,))``; ``count=0`` draws one scalar per key
    (rbg / unsafe_rbg keys: the batch's draw, as jax's vmap makes it)."""
    if _on_card(keys):
        out = _draw("uniform", keys, max(count, 1), impl)
        return out if count else out[..., 0]
    return rng.uniform(keys, (count,) if count else (), impl=impl)


def normal(keys: torch.Tensor, count: int = 0, impl: str = _TF
           ) -> torch.Tensor:
    """``normal(key, (count,))``; ``count=0`` draws one scalar per key
    (rbg / unsafe_rbg keys: the batch's draw, as jax's vmap makes it)."""
    if _on_card(keys):
        out = _draw("normal", keys, max(count, 1), impl)
        return out if count else out[..., 0]
    return rng.normal(keys, (count,) if count else (), impl=impl)
