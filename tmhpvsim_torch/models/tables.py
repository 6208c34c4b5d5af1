"""Tabulated / minimax transcendental kernels for the solar -> pv chain
(own copy of tmhpvsim_tpu/models/tables.py in torch): the plain version
of kernel K11 (csrc/tables.cuh).

Two interchangeable kernel sets behind ``SimConfig.kernel_impl``:

* :func:`exact_kernels` — every field is the torch op the models called
  before the axis existed (``torch.sin``, ``x ** p``, ...), so the exact
  set computes the same bits as the historical code;
* :func:`table_kernels` — low-degree minimax polynomials (Cody–Waite
  argument reduction, cephes-derived coefficients) plus a 366-entry
  day-of-year lookup table for the Spencer extraterrestrial-radiation
  series.  Arithmetic is float32 whatever the input dtype.

The polynomials follow the JAX package's operation order as float32 XLA
runs it on the CPU, which contracts each single-use multiply feeding an
add or subtract into one fused multiply-add: those steps are written
``rng.fma`` here and ``fmaf`` in the kernel (tests/test_torch_tables.py
holds each function against the JAX package's jitted one).

``MAX_ULP`` maps kernel name -> the published maximum error against a
float64 reference in float32 ULPs at the reference value, floored at one
ULP of 1.0; the bounds hold over ``ARG_RANGES``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from tmhpvsim_torch.rng import fma, sqrt_rn

__all__ = ["KernelSet", "exact_kernels", "table_kernels", "get_kernels",
           "MAX_ULP", "ARG_RANGES", "SPENCER_LUT", "KERNEL_IMPLS"]

#: the values of SimConfig.kernel_impl once resolved
KERNEL_IMPLS = ("exact", "table")

#: published max error (float32 ULPs at the float64 reference, floored at
#: one ULP of 1.0) of each table kernel
MAX_ULP = {
    "sin": 4,
    "cos": 4,
    "tan": 64,
    "arcsin": 24,
    "arccos": 24,
    "arctan2": 8,
    "exp": 4,
    "log": 4,
    "powc": 64,
    "spencer_factor": 4,
}

#: argument ranges over which the ``MAX_ULP`` bounds are published — the
#: ranges the solar/pv chain produces
ARG_RANGES = {
    "sin": (-400.0, 400.0),
    "cos": (-400.0, 400.0),
    "tan": (-1.5, 1.5),
    "arcsin": (-1.0, 1.0),
    "arccos": (-1.0, 1.0),
    "arctan2": None,             # all quadrants, |x|,|y| <= 1e3
    "exp": (-87.0, 40.0),
    "log": (1e-6, 1e4),
    "powc": (0.5, 100.0),        # exponents in [-1.7, 0)
    "spencer_factor": (1.0, 366.0),
}


def _f32c(v) -> float:
    """``v`` rounded to float32, as a python float."""
    return float(np.float32(v))


def _spencer_factor64(doy: np.ndarray) -> np.ndarray:
    """Float64 Spencer (1971) Fourier series for Rav^2 — LUT source."""
    b = 2.0 * np.pi * (np.asarray(doy, np.float64) - 1.0) / 365.0
    return (1.00011 + 0.034221 * np.cos(b) + 0.00128 * np.sin(b)
            + 0.000719 * np.cos(2.0 * b) + 0.000077 * np.sin(2.0 * b))


#: 366-entry day-of-year lookup table of the Spencer factor, built in
#: float64 and rounded once to float32
SPENCER_LUT = _spencer_factor64(np.arange(1, 367)).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class KernelSet:
    """The transcendental ops the solar/pv models consume.  ``powc(x, p)``
    is pow with a constant exponent (the airmass laws); ``spencer_factor``
    is None for the exact set (the model computes the Fourier series) and
    the LUT gather for the table set."""

    name: str
    sin: Callable[..., Any]
    cos: Callable[..., Any]
    tan: Callable[..., Any]
    arcsin: Callable[..., Any]
    arccos: Callable[..., Any]
    arctan2: Callable[..., Any]
    exp: Callable[..., Any]
    log: Callable[..., Any]
    powc: Callable[..., Any]
    spencer_factor: Optional[Callable[..., Any]] = None


def _pow_const(x, p):
    return x ** p


EXACT = KernelSet(name="exact", sin=torch.sin, cos=torch.cos, tan=torch.tan,
                  arcsin=torch.asin, arccos=torch.acos, arctan2=torch.atan2,
                  exp=torch.exp, log=torch.log, powc=_pow_const)


def exact_kernels() -> KernelSet:
    """The libm set: every field is the torch op."""
    return EXACT


# ---------------------------------------------------------------------------
# table / minimax implementations (float32)
# ---------------------------------------------------------------------------

_LOG2E = _f32c(1.44269504088896341)
# Cody–Waite split of ln(2)
_LN2_HI = _f32c(0.693359375)
_LN2_LO = _f32c(-2.12194440e-4)
# Cody–Waite split of pi/2 for the quadrant reduction
_PI2_HI = _f32c(1.5703125)
_PI2_MID = _f32c(4.837512969970703125e-4)
_PI2_LO = _f32c(7.549789948768648e-8)
_TWO_OVER_PI = _f32c(2.0 / math.pi)

_HALF_PI = _f32c(math.pi / 2.0)
_PI = _f32c(math.pi)
_QUARTER_PI = _f32c(math.pi / 4.0)
_TAN_PI8 = _f32c(0.4142135623730951)
_ATAN_TINY = _f32c(1e-30)
_SQRT_HALF = _f32c(0.7071067811865476)

#: polynomial coefficients, highest degree first (float32)
EXP_P = tuple(_f32c(c) for c in (1.9875691500e-4, 1.3981999507e-3,
                                 8.3334519073e-3, 4.1665795894e-2,
                                 1.6666665459e-1, 5.0000001201e-1))
LOG_W = tuple(_f32c(c) for c in (0.14798198280, 0.15313838550,
                                 0.20000714765, 0.33333331174))
SIN_W = tuple(_f32c(c) for c in (-1.9515295891e-4, 8.3321608736e-3,
                                 -1.6666654611e-1))
COS_W = tuple(_f32c(c) for c in (2.443315711809948e-5,
                                 -1.388731625493765e-3,
                                 4.166664568298827e-2))
ACOS_P = tuple(_f32c(c) for c in (-0.0012624911, 0.0066700901,
                                  -0.0170881256, 0.0308918810,
                                  -0.0501743046, 0.0889789874,
                                  -0.2145988016, 1.5707963050))
ATAN_W = tuple(_f32c(c) for c in (8.05374449538e-2, -1.38776856032e-1,
                                  1.99777106478e-1, -3.33329491539e-1))


def _f32(x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(x, dtype=torch.float32)
    return x.to(torch.float32)


def _horner(coeffs, x):
    """``((c0 * x + c1) * x + c2) ...``, each step one multiply-add."""
    p = fma(torch.full_like(x, coeffs[0]), x, coeffs[1])
    for c in coeffs[2:]:
        p = fma(p, x, c)
    return p


def _exp2i(k: torch.Tensor) -> torch.Tensor:
    """2**k for integer-valued float32 ``k`` in [-126, 127], by building
    the float32 exponent field."""
    return ((k.to(torch.int32) + 127) << 23).view(torch.float32)


def _fast_exp(x):
    """Minimax expf: |rel err| ~ 2e-7 on the clamped domain."""
    x = torch.clamp(_f32(x), -87.0, 88.0)
    kf = torch.round(x * _LOG2E)
    r = fma(-kf, _LN2_LO, fma(-kf, _LN2_HI, x))
    p = _horner(EXP_P, r)
    p = fma(p * r, r, r) + 1.0
    return p * _exp2i(kf)


def frexp(x: torch.Tensor):
    """``jnp.frexp`` on float32: ``x = m * 2**e`` with ``m`` in [0.5, 1)
    (subnormals normalised first; 0, inf and nan give ``(x, 0)``)."""
    tiny = float(np.finfo(np.float32).tiny)
    sub = x.abs() < tiny
    x1 = torch.where(sub, x * float(1 << 23), x).view(torch.int32)
    e = torch.where(sub, -23, 0).to(torch.int32) + ((x1 >> 23) & 0xFF) - 126
    m = ((x1 & ~(0xFF << 23)) | (126 << 23)).view(torch.float32)
    special = torch.isinf(x) | torch.isnan(x) | (x == 0)
    return torch.where(special, x, m), torch.where(special, 0, e)


def _fast_log(x):
    """Minimax logf via frexp + an atanh-style series."""
    m, e = frexp(_f32(x))
    lo = m < _SQRT_HALF
    m = torch.where(lo, m + m, m)
    e = torch.where(lo, e - 1, e).to(torch.float32)
    f = m - 1.0
    s = f / (f + 2.0)
    z = s * s
    w = _horner(LOG_W, z)
    return fma(e, _LN2_LO, fma(s, fma(z * 2.0, w, 2.0), e * _LN2_HI))


def _sin_poly(r, z):
    """cephes sinf core on |r| <= pi/4 (``z = r * r``)."""
    w = _horner(SIN_W, z)
    return fma(w * z, r, r)


def _cos_poly(z):
    """cephes cosf core on |r| <= pi/4 (``z = r * r``)."""
    w = _horner(COS_W, z)
    return fma(w * z, z, -(z * 0.5)) + 1.0


def _reduce_quadrant(x):
    x = _f32(x)
    nf = torch.round(x * _TWO_OVER_PI)
    r = fma(-nf, _PI2_LO, fma(-nf, _PI2_MID, fma(-nf, _PI2_HI, x)))
    q = nf.to(torch.int32) & 3
    return r, q


def _fast_sin(x):
    r, q = _reduce_quadrant(x)
    z = r * r
    sp, cp = _sin_poly(r, z), _cos_poly(z)
    v = torch.where((q & 1) == 0, sp, cp)
    return torch.where(q >= 2, -v, v)


def _fast_cos(x):
    r, q = _reduce_quadrant(x)
    z = r * r
    sp, cp = _sin_poly(r, z), _cos_poly(z)
    v = torch.where((q & 1) == 0, cp, sp)
    return torch.where(((q + 1) & 3) >= 2, -v, v)


def _fast_tan(x):
    r, q = _reduce_quadrant(x)
    z = r * r
    sp, cp = _sin_poly(r, z), _cos_poly(z)
    even = (q & 1) == 0
    return torch.where(even, sp, cp) / torch.where(even, cp, -sp)


def _fast_arccos(x):
    """Hastings-style arccos: sqrt(1 - |x|) * P(|x|), mirrored for x < 0."""
    x = torch.clamp(_f32(x), -1.0, 1.0)
    a = x.abs()
    v = sqrt_rn(1.0 - a) * _horner(ACOS_P, a)
    return torch.where(x < 0.0, _PI - v, v)


def _fast_arcsin(x):
    return _HALF_PI - _fast_arccos(x)


def _atan_poly(u):
    """cephes atanf core on |u| <= tan(pi/8)."""
    z = u * u
    w = _horner(ATAN_W, z)
    return fma(w * z, u, u)


def _fast_arctan2(y, x):
    y, x = _f32(y), _f32(x)
    ax, ay = x.abs(), y.abs()
    mx = torch.maximum(ax, ay)
    mn = torch.minimum(ax, ay)
    t = mn / torch.clamp_min(mx, _ATAN_TINY)
    big = t > _TAN_PI8
    u = torch.where(big, (t - 1.0) / (t + 1.0), t)
    a = _atan_poly(u)
    a = torch.where(big, a + _QUARTER_PI, a)
    a = torch.where(ay > ax, _HALF_PI - a, a)
    a = torch.where(x < 0.0, _PI - a, a)
    a = torch.where(y < 0.0, -a, a)
    return torch.where(mx == 0.0, a * 0.0, a)


def _fast_powc(x, p):
    """x**p for positive x and constant real p: exp(p * log(x))."""
    return _fast_exp(_fast_log(x) * _f32c(p))


def _spencer_factor(doy):
    """The Spencer factor at the integral day of year (LUT gather)."""
    d = _f32(doy)
    lut = torch.from_numpy(SPENCER_LUT).to(d.device)
    idx = torch.clamp(d.to(torch.int32) - 1, 0, 365)
    return lut[idx.long()]


TABLE = KernelSet(name="table", sin=_fast_sin, cos=_fast_cos, tan=_fast_tan,
                  arcsin=_fast_arcsin, arccos=_fast_arccos,
                  arctan2=_fast_arctan2, exp=_fast_exp, log=_fast_log,
                  powc=_fast_powc, spencer_factor=_spencer_factor)


def table_kernels() -> KernelSet:
    """The minimax / LUT set (float32 in and out)."""
    return TABLE


def get_kernels(impl: str) -> KernelSet:
    """Resolve a ``kernel_impl`` value to a :class:`KernelSet`."""
    if impl == "table":
        return TABLE
    if impl == "exact":
        return EXACT
    raise ValueError(f"unknown kernel_impl: {impl!r}")
