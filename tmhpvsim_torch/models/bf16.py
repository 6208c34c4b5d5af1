"""bfloat16 arithmetic as the JAX package's ``compute_dtype='bf16'`` path
runs it (the plain half of K12; csrc/bf16.cuh is the kernel's).

The JAX models are written once for every dtype, so which of their
operations round to bfloat16 follows from JAX's type promotion:

* an array typed bf16 combined with another bf16 array, or with a weakly
  typed value (a python float, or a weak float32 array such as
  ``jnp.cos`` of a python float), is a bf16 operation;
* bf16 combined with a float32 array is a float32 operation (the bf16
  operand widens exactly);
* two python floats combine in python double precision.

XLA on the CPU computes every bf16 operation in float32 and rounds the
result to bfloat16 once (round to nearest even); a weak operand is rounded
to bfloat16 first, from its float32 value.  One exception, which its
algebraic simplifier makes under the default ``xla_allow_excess_precision``:
where the graph converts a bf16 result straight to float32 (a bf16 operand
of a float32 operation, an ``astype``), the rounding and the widening
cancel and the float32 operation reads the unrounded float32 result.  A
bf16 array stored between computations (a host input, the engine's
narrowed per-chain geometry) is read rounded everywhere
(:func:`bf16_input`).

:class:`M` reproduces that on torch tensors: a value holds a float32
tensor ``v`` (for bf16, a value bfloat16 represents exactly), its JAX kind
(``BF16``, ``F32`` or ``WEAK``) and, for a bf16 result, the unrounded
float32 ``raw`` it came from.  Every arithmetic operator, comparison and
function below resolves the kind of its result as JAX does, rounds where
XLA rounds, and hands a float32 operation the raw value.

``kernel_set`` wraps a kernel set of models/tables.py: the exact set's
functions keep the kind of their argument (a bf16 ``cos`` is float32
``cos`` rounded to bf16, as XLA computes it), the table set's compute and
return float32 whatever their input, as the JAX table set does.
"""

from __future__ import annotations

import operator

import numpy as np
import torch

from tmhpvsim_torch.models.tables import EXACT, KernelSet, get_kernels
from tmhpvsim_torch.rng import sqrt_rn

BF16, F32, WEAK = "bf16", "f32", "weak"


def rnd(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest bfloat16 (ties to even), held
    in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def round_const(c: float) -> float:
    """A python float as a bf16 operand: through float32, as JAX converts
    it (the double rounding included)."""
    return float(rnd(torch.tensor(np.float32(c))))


class M:
    """A value of the JAX graph: a float32 tensor ``v`` and its kind."""

    __slots__ = ("v", "kind", "raw")

    def __init__(self, v: torch.Tensor, kind: str, raw=None):
        self.v = v
        self.kind = kind
        #: a bf16 result's unrounded float32 value (None: ``v``)
        self.raw = raw

    # arithmetic: JAX's promotion, XLA's rounding
    def __add__(self, o):
        return _bin(self, o, torch.add)

    def __radd__(self, o):
        return _bin(o, self, torch.add)

    def __sub__(self, o):
        return _bin(self, o, torch.sub)

    def __rsub__(self, o):
        return _bin(o, self, torch.sub)

    def __mul__(self, o):
        return _bin(self, o, torch.mul)

    def __rmul__(self, o):
        return _bin(o, self, torch.mul)

    def __truediv__(self, o):
        return _bin(self, o, torch.div)

    def __rtruediv__(self, o):
        return _bin(o, self, torch.div)

    # comparisons give bool tensors (a bf16 operand against a weak one
    # compares with the weak value rounded to bf16)
    def __lt__(self, o):
        return _cmp(self, o, operator.lt)

    def __gt__(self, o):
        return _cmp(self, o, operator.gt)


def bf16(v: torch.Tensor) -> M:
    """``v.astype(bfloat16)`` inside the graph: rounded for bf16
    operations, ``v`` itself where it is widened again."""
    v = v.to(torch.float32)
    return M(rnd(v), BF16, v)


def bf16_input(v: torch.Tensor) -> M:
    """A bf16 array handed to the graph (a bf16 buffer): ``v`` rounded."""
    return M(rnd(v.to(torch.float32)), BF16)


def f32(v: torch.Tensor) -> M:
    return M(v.to(torch.float32), F32)


def weak(v) -> M:
    """A weakly typed float32 array (a python float once it is an array)."""
    return M(torch.as_tensor(v, dtype=torch.float32), WEAK)


def _kind(x) -> str:
    return x.kind if isinstance(x, M) else WEAK


def _result_kind(*xs) -> str:
    kinds = {_kind(x) for x in xs}
    return F32 if F32 in kinds else BF16 if BF16 in kinds else WEAK


def _as(x, kind: str, like: torch.Tensor) -> torch.Tensor:
    """``x``'s value as an operand of a ``kind`` operation."""
    if isinstance(x, M):
        v = x.v
        if x.kind == WEAK and kind == BF16:
            v = rnd(v)
        elif x.kind == BF16 and kind == F32 and x.raw is not None:
            v = x.raw
        return v.to(like.device)
    v = torch.tensor(np.float32(x), dtype=torch.float32, device=like.device)
    return rnd(v) if kind == BF16 else v


def _ref(*xs) -> torch.Tensor:
    return next(x.v for x in xs if isinstance(x, M))


def _bin(a, b, fn):
    kind = _result_kind(a, b)
    ref = _ref(a, b)
    r = fn(_as(a, kind, ref), _as(b, kind, ref))
    return M(rnd(r), kind, r) if kind == BF16 else M(r, kind)


def _cmp(a, b, op):
    kind = _result_kind(a, b)
    ref = _ref(a, b)
    return op(_as(a, kind, ref), _as(b, kind, ref))


def _unary(x, fn):
    """``fn`` of ``x`` in ``x``'s kind (bf16 rounds)."""
    if not isinstance(x, M):
        x = weak(x)
    r = fn(x.v)
    return M(rnd(r), BF16, r) if x.kind == BF16 else M(r, x.kind)


def maximum(a, b) -> M:
    return _bin(a, b, torch.maximum)


def minimum(a, b) -> M:
    return _bin(a, b, torch.minimum)


def clip(x: M, lo: float, hi: float) -> M:
    """``jnp.clip``: the bounds take ``x``'s dtype."""
    ref = x.v
    return M(torch.minimum(torch.maximum(x.v, _as(lo, x.kind, ref)),
                           _as(hi, x.kind, ref)), x.kind)


def widen(x) -> torch.Tensor:
    """``x.astype(float32)``: a bf16 result's unrounded value."""
    if not isinstance(x, M):
        return torch.tensor(np.float32(x))
    return x.raw if x.kind == BF16 and x.raw is not None else x.v


def ipow(x, k: int):
    """``x**k`` as jax's integer_pow multiplies it (each product rounds)."""
    acc = None
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k:
            x = x * x
    return acc


class _MixedSet:
    """A kernel set of models/tables.py over :class:`M` values."""

    def __init__(self, ks: KernelSet):
        self.ks = ks
        self.exact = ks is EXACT

    def _call(self, fn, x):
        if self.exact:
            return _unary(x, fn)
        # the table set widens its argument on entry (an astype)
        return M(fn(widen(x) if isinstance(x, M) else x), F32)

    def cos(self, x):
        return self._call(self.ks.cos, x)

    def arccos(self, x):
        """The exact set's bf16 ``arccos`` is XLA's decomposition,
        ``atan2(sqrt((1 - x) * (1 + x)), x)``, every step rounded."""
        if self.exact and isinstance(x, M) and x.kind == BF16:
            s = (1.0 - x) * (x + 1.0)
            r = rnd(sqrt_rn(s.v))
            a = torch.atan2(r, x.v)
            return M(rnd(a), BF16, a)
        return self._call(self.ks.arccos, x)

    def powc(self, x: M, p: float) -> M:
        """``x ** p`` for a python-float exponent: the exact set's
        ``jnp.power`` with the exponent in ``x``'s dtype (rounded to bf16
        for a bf16 ``x``), the table set's ``exp(f32(p) * log(x))``."""
        if not self.exact:
            return M(self.ks.powc(widen(x), p), F32)
        e = round_const(p) if x.kind == BF16 else float(np.float32(p))
        r = torch.pow(x.v, torch.tensor(e, dtype=torch.float32,
                                        device=x.v.device))
        return M(rnd(r), BF16, r) if x.kind == BF16 else M(r, x.kind)


_SETS: dict = {}


def kernel_set(kernels) -> _MixedSet:
    """The mixed-precision view of a kernel set (a name or a KernelSet)."""
    ks = get_kernels(kernels) if isinstance(kernels, str) else \
        (kernels or EXACT)
    s = _SETS.get(ks.name)
    if s is None:
        s = _SETS[ks.name] = _MixedSet(ks)
    return s
