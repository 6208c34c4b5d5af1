"""Threefry2x32 key API in plain torch — the reference for kernel K1.

Reproduces ``jax.random`` with ``jax_threefry_partitionable=True`` draw for
draw: the same keys, the same counters, the same float conversions, so a
chain keyed from a seed here walks the identical random stream the JAX
package walks (tests/test_torch_rng.py holds the two side by side).

Keys are ``(..., 2)`` tensors of 32-bit words stored in int64 and masked
with ``0xFFFFFFFF`` (the layout of ``jax.random.key_data``): torch's
unsigned 32-bit arithmetic is too thin on the CPU to lean on.

What jax computes, and this module copies:

* ``threefry2x32(k, (x0, x1))``: 20 rounds, rotations (13, 15, 26, 6) /
  (17, 29, 16, 24), key schedule ``k0 ^ k1 ^ 0x1BD11BDA``;
* ``split(k, n)[i] = threefry2x32(k, (0, i))``;
* ``fold_in(k, d) = threefry2x32(k, (0, d))``;
* 32-bit ``random_bits(k, shape)[i] = x0 ^ x1`` of ``threefry2x32(k, (0, i))``
  over the flattened draw index ``i``;
* ``uniform = f32(bits >> 9 | 0x3F800000) - 1``, then
  ``max(minval, u * (maxval - minval) + minval)``;
* ``normal = f32(sqrt 2) * erfinv(uniform(nextafter(-1, 0), 1))`` with
  XLA's own f32 ``erf_inv`` polynomial (``erfinv_f32`` below);
* ``gamma``: Marsaglia–Tsang with jax's per-iteration key splits and the
  ``a < 1`` boost (``jax._src.random._gamma_one``);
* ``t = normal(k_n) * sqrt(df/2 / gamma(k_g, df/2))`` with
  ``k_n, k_g = split(k)``.

The draws are the ones jax computes on the CPU, where XLA evaluates
``log`` and ``log1p`` with its own Cephes-style polynomials and contracts
each single-use multiply feeding an add into one fused multiply-add.
``xla_log``, ``xla_log1p`` and ``fma`` reproduce that (read off XLA's
generated code), so normals, gamma and t draws are bit-exact too.

Every function here works on tensors of any device; the CUDA kernels in
``tmhpvsim_torch/csrc/threefry.cuh`` implement the same arithmetic.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

#: XLA's f32 erf_inv coefficients (the chlo decomposition), w < 5 / w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)

_F32 = torch.float32
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))
#: the bfloat16 draws' constants: nextafter(-1, 0) and sqrt 2 in bf16
_NORMAL_LO_BF16 = -(1.0 - 2.0 ** -8)
_SQRT2_BF16 = 1.4140625
_TINY_F32 = float(np.finfo(np.float32).tiny)


#: XLA's CPU log: Cephes logf coefficients p0..p8, ln2 split q1/q2
_LOG_P = (0.070376836292, -0.11514610310, 0.11676998740, -0.12420140846,
          0.14249322787, -0.16668057665, 0.20000714765, -0.24999993993,
          0.33333331174)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_SQRTHF = 0.70710678118654752
#: XLA's CPU log1p for |x| < sqrt(2) - 1: x - x^2/2 + x^3 * P(x)/Q(x)
_LOG1P_Q = (1.0, 15.062909126281738, 83.04756927490234, 221.7624053955078,
            309.0987243652344, 216.42788696289062, 60.11865997314453)
_LOG1P_P = (4.527000055531971e-05, 0.4985410273075104, 6.578732490539551,
            29.91191864013672, 60.949668884277344, 57.11296463012695,
            20.039552688598633)
_LOG1P_SMALL = 0.41421356237309504880


def _f32c(v: float) -> float:
    """``v`` rounded to float32, as a python float."""
    return float(np.float32(v))


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a*b + c`` with one rounding (CUDA's fmaf, XLA's contracted
    multiply-add).  Computed in float64, where ``a*b`` is exact; the one
    case where float64 rounding would decide the float32 rounding — the
    float64 sum exactly halfway between two floats — is settled by the
    sum's exact error term."""
    ref = next(v for v in (a, b, c) if isinstance(v, torch.Tensor))
    a, b, c = (torch.as_tensor(v, dtype=torch.float32, device=ref.device)
               .double() for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.float()
    rd = r.double()
    inf = torch.tensor(math.inf, dtype=torch.float32, device=ref.device)
    other = torch.nextafter(r, torch.where(s > rd, inf, -inf))
    tie = (s != rd) & (s == (rd + other.double()) * 0.5) & (err != 0)
    fixed = torch.where(err > 0, torch.maximum(r, other),
                        torch.minimum(r, other))
    return torch.where(tie, fixed, r)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt (torch's CPU kernel is not always)."""
    return torch.sqrt(x.double()).float()


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log``: Cephes logf on the mantissa in
    [sqrt(1/2), sqrt(2)), every single-use multiply-add fused."""
    P = [_f32c(v) for v in _LOG_P]
    tiny = _f32c(1.17549435e-38)
    xc = torch.where(x > tiny, x, torch.full_like(x, tiny))
    bits = xc.view(torch.int32)
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    low = m < _f32c(_SQRTHF)
    e = e - low.to(torch.float32)
    xm = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    x2 = xm * xm
    x3 = x2 * xm
    y = fma(fma(xm, P[0], P[1]), xm, P[2])
    y1 = fma(fma(xm, P[3], P[4]), xm, P[5])
    y2 = fma(fma(xm, P[6], P[7]), xm, P[8])
    y = fma(fma(y, x3, y1), x3, y2)
    y = fma(y, x3, _f32c(_LOG_Q1) * e)
    r = fma(_f32c(_LOG_Q2), e, fma(-x2, 0.5, xm) + y)
    # XLA's CPU code treats subnormal inputs as zero
    r = torch.where(x.abs() < tiny, torch.full_like(r, -math.inf), r)
    r = torch.where(x == math.inf, x, r)
    return torch.where((x < 0) | torch.isnan(x),
                       torch.full_like(r, math.nan), r)


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log1p``: a Cephes rational approximation for
    |x| < sqrt(2) - 1, else ``xla_log(1 + x)``."""
    Q = [_f32c(v) for v in _LOG1P_Q]
    P = [_f32c(v) for v in _LOG1P_P]
    x2 = x * x
    q = x + Q[1]
    for c in Q[2:]:
        q = fma(q, x, c)
    p = torch.full_like(x, P[0])
    for c in P[1:]:
        p = fma(p, x, c)
    small = x + fma(x2, -0.5, (x * x2) * (p / q))
    return torch.where(x.abs() < _f32c(_LOG1P_SMALL), small,
                       xla_log(x + 1.0))


def rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """``c / x`` rounded once, as jax divides.  torch's ``float / tensor``
    is ``x.reciprocal() * c`` — two roundings — so the port never writes it.
    """
    return torch.div(torch.tensor(c, dtype=x.dtype, device=x.device), x)


def cdiv(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded once.  On the card torch divides by a python
    scalar as ``x * (1/c)``; a divisor tensor on ``x``'s device divides."""
    return torch.div(x, torch.tensor(c, dtype=x.dtype, device=x.device))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block function (20 rounds) on int64-held words.

    All four arguments broadcast against each other; returns ``(y0, y1)``.
    """
    ks = (k0, k1, (k0 ^ k1 ^ _KS_PARITY) & MASK32)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """The raw threefry key of ``jax.random.key(seed)``: ``(hi, lo)``."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    return torch.tensor([seed >> 32, seed & MASK32], dtype=torch.int64,
                        device=device)


def _counter(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=like.device)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2) -> (..., num, 2)``."""
    k0 = keys[..., 0, None]
    k1 = keys[..., 1, None]
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(k0), _counter(num, keys))
    return torch.stack([y0, y1], dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` is an int or an integer tensor that
    broadcasts against ``keys[..., 0]`` (taken modulo 2**32, as jax's
    uint32 cast does)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & MASK32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def random_bits(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """32-bit ``jax.random.bits``: ``(..., 2) -> (..., *shape)`` int64."""
    shape = tuple(shape)
    n = math.prod(shape)
    k0 = keys[..., 0, None]
    k1 = keys[..., 1, None]
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(k0), _counter(n, keys))
    return (y0 ^ y1).reshape(*keys.shape[:-1], *shape)


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """``[0, 1)`` floats from 32-bit words, jax's mantissa trick."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(_F32) - 1.0


def uniform(keys: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0, dtype=_F32) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``, dtype
    float32 or bfloat16.

    bfloat16 takes jax's 8-bit ``random_bits``: the low 8 bits of the word
    the float32 draw uses, whose upper 7 become the mantissa of a bf16 in
    [1, 2); the affine steps are bf16 operations, each rounded."""
    if dtype == torch.bfloat16:
        return _uniform_bf16(keys, shape, minval, maxval)
    lo = torch.tensor(minval, dtype=_F32, device=keys.device)
    hi = torch.tensor(maxval, dtype=_F32, device=keys.device)
    f = bits_to_unit(random_bits(keys, shape))
    return torch.maximum(lo, f * (hi - lo) + lo)


def _bf(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to bfloat16 (ties to even), held in float32."""
    return x.to(torch.bfloat16).to(_F32)


def _uniform_bf16(keys, shape, minval, maxval):
    dev = keys.device
    lo = _bf(torch.tensor(minval, dtype=_F32, device=dev))
    hi = _bf(torch.tensor(maxval, dtype=_F32, device=dev))
    k = (random_bits(keys, shape) & 0xFF) >> 1
    f = k.to(_F32) * (1.0 / 128.0)           # (1 + k/128) - 1, exact
    r = torch.maximum(lo, _bf(_bf(f * _bf(hi - lo)) + lo))
    return r.to(torch.bfloat16)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv``: ``w = -log1p(-x*x)``, a degree-8 polynomial
    (fused multiply-adds) in ``w - 2.5`` (w < 5) or ``sqrt(w) - 3``, times
    ``x``; ±inf at ±1."""
    w = -xla_log1p(x * -x)
    lt = w < 5.0
    ww = torch.where(lt, w - 2.5, sqrt_rn(w) - 3.0)
    lt5 = torch.tensor(_ERFINV_LT5, dtype=_F32, device=x.device)
    ge5 = torch.tensor(_ERFINV_GE5, dtype=_F32, device=x.device)
    p = torch.where(lt, lt5[0], ge5[0])
    for i in range(1, 9):
        p = fma(p, ww, torch.where(lt, lt5[i], ge5[i]))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(keys: torch.Tensor, shape=(), dtype=_F32) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)``, dtype float32 or
    bfloat16 (``sqrt 2`` and ``nextafter(-1, 0)`` in bf16, and XLA's bf16
    ``erf_inv``: the float32 one, rounded)."""
    if dtype == torch.bfloat16:
        u = uniform(keys, shape, _NORMAL_LO_BF16, 1.0, dtype).to(_F32)
        return _bf(_SQRT2_BF16 * _bf(erfinv_f32(u))).to(torch.bfloat16)
    u = uniform(keys, shape, _NORMAL_LO, 1.0)
    return _SQRT2_F32 * erfinv_f32(u)


def normal_bf16_table() -> np.ndarray:
    """The 128 values a bf16 ``normal`` takes: entry k is the draw whose
    8-bit word has upper bits k (its uniform is ``(4k - 255) / 256``)."""
    u = torch.tensor([(4.0 * k - 255.0) / 256.0 for k in range(128)],
                     dtype=_F32)
    return _bf(_SQRT2_BF16 * _bf(erfinv_f32(u))).numpy()


def gamma(keys: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """One ``jax.random.gamma(key, alpha, (), float32)`` draw per key.

    ``alpha`` broadcasts against ``keys[..., 0]``.  jax first gives every
    element its own key ``split(key, 1)[0]``, then runs Marsaglia–Tsang
    (boosting ``alpha < 1`` to ``alpha + 1``) with a fresh three-way split
    per outer iteration and a two-way split per inner normal redraw.  The
    loops run on masks, so each element sees exactly its scalar loop.
    """
    keys = split(keys, 1)[..., 0, :]
    alpha = torch.as_tensor(alpha, dtype=_F32, device=keys.device)
    alpha = alpha.expand(keys.shape[:-1]).contiguous()
    boost = alpha >= 1.0
    a = torch.where(boost, alpha, alpha + 1.0)
    d = a - float(np.float32(1.0 / 3.0))
    # XLA rewrites (1/3) / sqrt(d) as (1/3) * rsqrt(d), rsqrt = 1 / sqrt
    c = float(np.float32(1.0 / 3.0)) * rdiv(1.0, sqrt_rn(d))
    ks = split(keys, 2)
    key_, subkey = ks[..., 0, :], ks[..., 1, :]
    X = torch.zeros_like(a)
    V = torch.ones_like(a)
    U = torch.full_like(a, 2.0)

    def cond(X, V, U):
        return ((U >= fma(-0.0331, X * X, 1.0))
                & (xla_log(U) >= fma(X, 0.5, d * ((1.0 - V) + xla_log(V)))))

    active = cond(X, V, U)
    while bool(active.any()):
        k3 = split(key_, 3)
        key_n, x_key, u_key = k3[..., 0, :], k3[..., 1, :], k3[..., 2, :]
        k, x, v = x_key, torch.zeros_like(a), torch.full_like(a, -1.0)
        inner = active.clone()
        while bool(inner.any()):
            k2 = split(k, 2)
            xn = normal(k2[..., 1, :])
            vn = fma(xn, c, 1.0)
            k = torch.where(inner[..., None], k2[..., 0, :], k)
            x = torch.where(inner, xn, x)
            v = torch.where(inner, vn, v)
            inner = inner & (v <= 0.0)
        un = uniform(u_key)
        key_ = torch.where(active[..., None], key_n, key_)
        X = torch.where(active, x * x, X)
        V = torch.where(active, (v * v) * v, V)
        U = torch.where(active, un, U)
        active = active & cond(X, V, U)
    samples = 1.0 - uniform(subkey)
    boost_f = torch.where(boost, torch.ones_like(a),
                          torch.pow(samples, rdiv(1.0, alpha)))
    return (d * V) * boost_f


def t(keys: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """One ``jax.random.t(key, df, (), float32)`` draw per key."""
    ks = split(keys, 2)
    n = normal(ks[..., 0, :])
    half_df = torch.as_tensor(df, dtype=_F32, device=keys.device) / 2.0
    g = gamma(ks[..., 1, :], half_df)
    return n * sqrt_rn(half_df / g)


def kernel_constants() -> dict:
    """The constants csrc/threefry.cuh reads."""
    return {
        "LOG_P": list(_LOG_P), "LOG_Q1": _LOG_Q1, "LOG_Q2": _LOG_Q2,
        "LOG_SQRTHF": _SQRTHF, "LOG1P_Q": list(_LOG1P_Q),
        "LOG1P_P": list(_LOG1P_P), "LOG1P_SMALL": _LOG1P_SMALL,
        "ERFINV_LT5": list(_ERFINV_LT5), "ERFINV_GE5": list(_ERFINV_GE5),
    }


def asymmetric_laplace_uniform(keys: torch.Tensor) -> torch.Tensor:
    """``uniform(key, (), float32, minval=finfo(float32).tiny, maxval=1)``,
    the draw behind ``distributions.asymmetric_laplace``."""
    return uniform(keys, (), _TINY_F32, 1.0)
