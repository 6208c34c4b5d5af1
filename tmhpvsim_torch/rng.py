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

``prng_impl='rbg'`` keys are ``(..., 4)`` (``jax.random.key(seed,
impl='rbg')``: ``[hi, lo, hi, lo]`` of the seed).  jax derives them with
threefry, one hash per 2-word half (``split`` and ``fold_in`` with
``impl='rbg'``), and draws their bits with XLA's ``RngBitGenerator``, which
is Philox4x32-10 on the CPU: for key data ``[w0, w1, w2, w3]`` the 32-bit
stream is ``philox4x32_10(counter=(w2, w3, w0, w1) + q, key=(w0, w1))``,
four words per 128-bit counter value ``q``, in flat order; 8- and 16-bit
draws take the low bits of the same words.  Under ``vmap`` jax draws the
whole batch from its FIRST key (``_rng_bit_generator_batching_rule``):
``random_bits`` of a ``(*B, 4)`` key array is the ``(*B, *shape)`` block
of ``keys[0, ..., 0]``'s stream, the batch dims in vmap nesting order,
outermost first.  ``gamma`` alone draws per key (jax maps it serially
over its keys for a non-threefry impl), as ``per_key=True`` does.

``prng_impl='unsafe_rbg'`` keys are rbg key data with rbg bits, but
``split`` and ``fold_in`` are draws themselves (``jax/_src/prng.py``
``_unsafe_rbg_split`` / ``_unsafe_rbg_fold_in``): ``split(k, n)[i]`` is
row ``10 i`` of a ``(10 n, 4)`` draw from ``k``, i.e. the four words of
Philox counter value ``10 i``; ``fold_in(k, d)`` is ``k ^`` row 9 of a
``(10, 4)`` draw from ``_rbg_seed(d) = [0, d, 0, d]``.  Under ``vmap``
those draws follow the same first-key rule: a split of a batch of keys
takes member ``p``'s rows from the first key at counter ``10 (p n + i)``,
a fold of a batch of data takes datum ``p``'s row from the first datum's
seed at counter ``10 p + 9``.  So here, as for rbg bits, the leading
dims of a key (or data) tensor are the vmap batch dims in nesting order,
and a dim of size 1 is one the call is not batched over; ``per_key=True``
asks for each key's own unbatched derivation.  jax's gamma splits its
flattened keys under ``vmap`` before mapping them serially, so under
unsafe_rbg its entry split is batched (over the broadcast of the keys'
and ``alpha``'s batch) and the rest runs per key.

Nothing here infers the key implementation from a key's shape: every
function that derives or draws takes ``impl=`` (the run's ``prng_impl``)
and refuses keys whose width is not that implementation's.

Every function here works on tensors of any device; the CUDA kernels in
``tmhpvsim_torch/csrc/threefry.cuh`` and ``philox.cuh`` implement the
same arithmetic.
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


def rbg_key(seed: int, device=None) -> torch.Tensor:
    """The key data of ``jax.random.key(seed, impl='rbg')`` (and of
    'unsafe_rbg', which shares ``_rbg_seed``): the threefry key twice,
    ``[hi, lo, hi, lo]``."""
    k = key(seed, device)
    return torch.cat([k, k])


#: the key implementations (SimConfig.prng_impl) and their key widths
IMPLS = ("threefry2x32", "rbg", "unsafe_rbg")
KEY_WIDTH = {"threefry2x32": 2, "rbg": 4, "unsafe_rbg": 4}


def root_key(seed: int, prng_impl: str = "threefry2x32", device=None):
    """The root key of a run under ``prng_impl``."""
    if prng_impl in ("rbg", "unsafe_rbg"):
        return rbg_key(seed, device)
    if prng_impl != "threefry2x32":
        raise ValueError(f"unsupported prng_impl {prng_impl!r}")
    return key(seed, device)


def check_keys(keys: torch.Tensor, impl: str) -> None:
    """Refuse ``keys`` whose last dim is not ``impl``'s key width."""
    if impl not in KEY_WIDTH:
        raise ValueError(f"unsupported prng_impl {impl!r}")
    if keys.shape[-1:] != (KEY_WIDTH[impl],):
        raise ValueError(f"{impl} keys are (..., {KEY_WIDTH[impl]}), got "
                         f"{tuple(keys.shape)}")


def _halves(keys: torch.Tensor) -> torch.Tensor:
    return keys.reshape(*keys.shape[:-1], 2, 2)


def positions(shape, device) -> torch.Tensor:
    """Each member's flat index in a batch of ``shape`` (row-major: the
    vmap nesting order, outermost first)."""
    return torch.arange(math.prod(shape), dtype=torch.int64,
                        device=device).reshape(shape)


def split(keys: torch.Tensor, num: int = 2, impl: str = "threefry2x32",
          per_key: bool = False) -> torch.Tensor:
    """``jax.random.split``: ``(..., w) -> (..., num, w)``.  threefry
    hashes each key; rbg splits each 2-word half by threefry; unsafe_rbg
    takes Philox rows, batched over the leading dims (the first key's
    rows, member ``p`` at counter ``10 (p num + i)``) unless ``per_key``
    (each key's own rows ``10 i``)."""
    check_keys(keys, impl)
    if impl == "unsafe_rbg":
        return _urbg_split(keys, num, per_key)
    if impl == "rbg":
        s = split(_halves(keys), num)                   # (..., 2, num, 2)
        return s.transpose(-3, -2).reshape(*keys.shape[:-1], num, 4)
    k0 = keys[..., 0, None]
    k1 = keys[..., 1, None]
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(k0), _counter(num, keys))
    return torch.stack([y0, y1], dim=-1)


def fold_in(keys: torch.Tensor, data, impl: str = "threefry2x32"
            ) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` is an int or an integer tensor that
    broadcasts against ``keys[..., 0]`` (taken modulo 2**32, as jax's
    uint32 cast does).  rbg keys fold ``data`` into each half; unsafe_rbg
    keys are XORed with a row drawn from the datum's seed, a batch of data
    (its dims of size > 1) from the first datum's at ``10 p + 9``."""
    check_keys(keys, impl)
    d = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & MASK32
    if impl == "unsafe_rbg":
        return keys ^ urbg_fold_rows(d)
    if impl == "rbg":
        f = fold_in(_halves(keys), d[..., None] if d.dim() else d)
        return f.reshape(*f.shape[:-2], 4)
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m: int, x: torch.Tensor):
    """``(hi, lo)`` 32-bit words of the 64-bit product ``m * x`` (``m`` a
    32-bit constant, ``x`` int64-held 32-bit words), in 16-bit pieces so
    that no int64 intermediate overflows."""
    mid = m * (x >> 16)                     # < 2**48
    lo = m * (x & 0xFFFF) + ((mid & 0xFFFF) << 16)
    return (mid >> 16) + (lo >> 32), lo & MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """The Philox-4x32 block function, 10 rounds, on int64-held words
    (broadcasting); returns the four output words."""
    for r in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        if r < 9:
            k0 = (k0 + _PHILOX_W[0]) & MASK32
            k1 = (k1 + _PHILOX_W[1]) & MASK32
    return c0, c1, c2, c3


def _philox_at(keys: torch.Tensor, q: torch.Tensor):
    """The four words of counter value ``q`` (int64, broadcasting against
    ``keys[..., 0]``) of rbg keys: counter ``(w2, w3, w0, w1) + q`` as one
    128-bit add, keyed ``(w0, w1)``."""
    w0, w1, w2, w3 = (keys[..., j] for j in range(4))
    c0 = w2 + (q & MASK32)
    c1 = w3 + (q >> 32) + (c0 >> 32)
    c2 = w0 + (c1 >> 32)
    c3 = (w1 + (c2 >> 32)) & MASK32
    return philox4x32_10(c0 & MASK32, c1 & MASK32, c2 & MASK32, c3, w0, w1)


def rbg_words(keys: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Word ``words`` (int64 index, broadcasting against ``keys[..., 0]``)
    of each rbg key's 32-bit stream."""
    out = torch.stack(_philox_at(keys, words >> 2), dim=-1)
    return out.gather(-1, (words & 3).expand(out.shape[:-1])[..., None]
                      )[..., 0]


def rbg_stream(key4: torch.Tensor, count: int) -> torch.Tensor:
    """Words ``[0, count)`` of one rbg key's stream, ``(count,)`` int64
    (one Philox call per four words)."""
    q = torch.arange((count + 3) // 4, dtype=torch.int64,
                     device=key4.device)
    return torch.stack(_philox_at(key4, q), dim=-1).reshape(-1)[:count]


def _rows(keys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Row ``q`` (int64, broadcasting against ``keys[..., 0]``) of a
    ``(rows, 4)`` uint32 draw from rbg key data: Philox counter value
    ``q``'s four words, ``(..., 4)``."""
    return torch.stack(_philox_at(keys, q), dim=-1)


def _rbg_seed(d: torch.Tensor) -> torch.Tensor:
    """``_rbg_seed`` of uint32 data: ``[0, d, 0, d]`` (threefry_seed of a
    32-bit datum puts it in the low word, the high word zero), ``(...,
    4)``."""
    z = torch.zeros_like(d)
    return torch.stack([z, d, z, d], dim=-1)


def urbg_fold_rows(d: torch.Tensor) -> torch.Tensor:
    """The rows unsafe_rbg's ``fold_in`` XORs into keys for uint32 data
    ``d``: row 9 of ``_rbg_seed(d)``'s draw for a scalar; for a batch, the
    first datum's rows ``10 p + 9`` (``(*d.shape, 4)``)."""
    if d.dim() == 0:
        return _rows(_rbg_seed(d), torch.tensor(9, device=d.device))
    if d.numel() == 0:
        return torch.zeros((*d.shape, 4), dtype=torch.int64,
                           device=d.device)
    p = positions(d.shape, d.device)
    return _rows(_rbg_seed(d.reshape(-1)[0]), 10 * p + 9)


def _urbg_split(keys: torch.Tensor, num: int, per_key: bool
                ) -> torch.Tensor:
    lead = keys.shape[:-1]
    i = torch.arange(num, dtype=torch.int64, device=keys.device)
    if per_key or not lead or keys.numel() == 0:
        return _rows(keys[..., None, :], 10 * i)
    p = positions(lead, keys.device)[..., None]
    return _rows(keys.reshape(-1, 4)[0], 10 * (p * num + i))


def rbg_bits_batched(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """``random_bits`` of rbg ``keys`` ``(*B, 4)`` under ``vmap`` over
    the batch dims ``B`` (jax's batching rule): the ``(*B, *shape)``
    block of the first key's stream."""
    shape = tuple(shape)
    lead = keys.shape[:-1]
    if keys.numel() == 0:
        return torch.zeros((*lead, *shape), dtype=torch.int64,
                           device=keys.device)
    first = keys.reshape(-1, 4)[0]
    return rbg_stream(first, math.prod(lead) * math.prod(shape)).reshape(
        (*lead, *shape))


def rbg_bits_per_key(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """Each rbg key's own draw of ``shape`` (the unbatched draw, per key,
    as jax's serial ``lax.map`` makes it): ``(..., *shape)``."""
    shape = tuple(shape)
    w = torch.arange(math.prod(shape), dtype=torch.int64,
                     device=keys.device)
    return rbg_words(keys[..., None, :], w).reshape(
        (*keys.shape[:-1], *shape))


def rbg_bits(key4: torch.Tensor, shape=(), width: int = 32) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint{width})`` of one rbg key, width
    8, 16 or 32: the low ``width`` bits of the stream's words."""
    if width not in (8, 16, 32):
        raise ValueError(f"width must be 8, 16 or 32, got {width}")
    return rbg_bits_batched(key4, shape) & ((1 << width) - 1)


def random_bits(keys: torch.Tensor, shape=(), per_key: bool = False,
                impl: str = "threefry2x32") -> torch.Tensor:
    """32-bit ``jax.random.bits``: ``(..., w) -> (..., *shape)`` int64.

    rbg and unsafe_rbg keys follow jax's batching rule (the first key's
    stream, ``rbg_bits_batched``) unless ``per_key`` (each key its own
    stream, ``rbg_bits_per_key``); a threefry draw is per key either way.
    """
    check_keys(keys, impl)
    shape = tuple(shape)
    if impl != "threefry2x32":
        return (rbg_bits_per_key(keys, shape) if per_key
                else rbg_bits_batched(keys, shape))
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
            maxval: float = 1.0, dtype=_F32, per_key: bool = False,
            impl: str = "threefry2x32") -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``, dtype
    float32 or bfloat16.

    bfloat16 takes jax's 8-bit ``random_bits``: the low 8 bits of the word
    the float32 draw uses, whose upper 7 become the mantissa of a bf16 in
    [1, 2); the affine steps are bf16 operations, each rounded."""
    if dtype == torch.bfloat16:
        return _uniform_bf16(keys, shape, minval, maxval, per_key, impl)
    lo = torch.tensor(minval, dtype=_F32, device=keys.device)
    hi = torch.tensor(maxval, dtype=_F32, device=keys.device)
    f = bits_to_unit(random_bits(keys, shape, per_key, impl))
    return torch.maximum(lo, f * (hi - lo) + lo)


def _bf(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to bfloat16 (ties to even), held in float32."""
    return x.to(torch.bfloat16).to(_F32)


def _uniform_bf16(keys, shape, minval, maxval, per_key=False,
                  impl="threefry2x32"):
    dev = keys.device
    lo = _bf(torch.tensor(minval, dtype=_F32, device=dev))
    hi = _bf(torch.tensor(maxval, dtype=_F32, device=dev))
    k = (random_bits(keys, shape, per_key, impl) & 0xFF) >> 1
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


def normal(keys: torch.Tensor, shape=(), dtype=_F32, per_key: bool = False,
           impl: str = "threefry2x32") -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)``, dtype float32 or
    bfloat16 (``sqrt 2`` and ``nextafter(-1, 0)`` in bf16, and XLA's bf16
    ``erf_inv``: the float32 one, rounded)."""
    if dtype == torch.bfloat16:
        u = uniform(keys, shape, _NORMAL_LO_BF16, 1.0, dtype,
                    per_key, impl).to(_F32)
        return _bf(_SQRT2_BF16 * _bf(erfinv_f32(u))).to(torch.bfloat16)
    u = uniform(keys, shape, _NORMAL_LO, 1.0, per_key=per_key, impl=impl)
    return _SQRT2_F32 * erfinv_f32(u)


def normal_bf16_table() -> np.ndarray:
    """The 128 values a bf16 ``normal`` takes: entry k is the draw whose
    8-bit word has upper bits k (its uniform is ``(4k - 255) / 256``)."""
    u = torch.tensor([(4.0 * k - 255.0) / 256.0 for k in range(128)],
                     dtype=_F32)
    return _bf(_SQRT2_BF16 * _bf(erfinv_f32(u))).numpy()


def gamma(keys: torch.Tensor, alpha: torch.Tensor,
          impl: str = "threefry2x32") -> torch.Tensor:
    """One ``jax.random.gamma(key, alpha, (), float32)`` draw per key.

    ``alpha`` broadcasts against ``keys[..., 0]``.  jax first gives every
    element its own key ``split(key, 1)[0]``, then runs Marsaglia–Tsang
    (boosting ``alpha < 1`` to ``alpha + 1``) with a fresh three-way split
    per outer iteration and a two-way split per inner normal redraw.  The
    loops run on masks, so each element sees exactly its scalar loop.
    After the entry split every draw is the key's own (jax maps non-
    threefry keys' gamma serially); under unsafe_rbg that entry split is
    a batched draw over the keys' and ``alpha``'s broadcast batch.
    """
    check_keys(keys, impl)
    alpha = torch.as_tensor(alpha, dtype=_F32, device=keys.device)
    batch = torch.broadcast_shapes(keys.shape[:-1], alpha.shape)
    keys = keys.expand(*batch, keys.shape[-1])
    keys = split(keys, 1, impl)[..., 0, :]
    alpha = alpha.expand(batch).contiguous()
    boost = alpha >= 1.0
    a = torch.where(boost, alpha, alpha + 1.0)
    d = a - float(np.float32(1.0 / 3.0))
    # XLA rewrites (1/3) / sqrt(d) as (1/3) * rsqrt(d), rsqrt = 1 / sqrt
    c = float(np.float32(1.0 / 3.0)) * rdiv(1.0, sqrt_rn(d))
    ks = split(keys, 2, impl, per_key=True)
    key_, subkey = ks[..., 0, :], ks[..., 1, :]
    X = torch.zeros_like(a)
    V = torch.ones_like(a)
    U = torch.full_like(a, 2.0)

    def cond(X, V, U):
        return ((U >= fma(-0.0331, X * X, 1.0))
                & (xla_log(U) >= fma(X, 0.5, d * ((1.0 - V) + xla_log(V)))))

    active = cond(X, V, U)
    while bool(active.any()):
        k3 = split(key_, 3, impl, per_key=True)
        key_n, x_key, u_key = k3[..., 0, :], k3[..., 1, :], k3[..., 2, :]
        k, x, v = x_key, torch.zeros_like(a), torch.full_like(a, -1.0)
        inner = active.clone()
        while bool(inner.any()):
            k2 = split(k, 2, impl, per_key=True)
            xn = normal(k2[..., 1, :], per_key=True, impl=impl)
            vn = fma(xn, c, 1.0)
            k = torch.where(inner[..., None], k2[..., 0, :], k)
            x = torch.where(inner, xn, x)
            v = torch.where(inner, vn, v)
            inner = inner & (v <= 0.0)
        un = uniform(u_key, per_key=True, impl=impl)
        key_ = torch.where(active[..., None], key_n, key_)
        X = torch.where(active, x * x, X)
        V = torch.where(active, (v * v) * v, V)
        U = torch.where(active, un, U)
        active = active & cond(X, V, U)
    samples = 1.0 - uniform(subkey, per_key=True, impl=impl)
    boost_f = torch.where(boost, torch.ones_like(a),
                          torch.pow(samples, rdiv(1.0, alpha)))
    return (d * V) * boost_f


def t(keys: torch.Tensor, df: torch.Tensor, impl: str = "threefry2x32"
      ) -> torch.Tensor:
    """One ``jax.random.t(key, df, (), float32)`` draw per key (rbg and
    unsafe_rbg: the split and the normal under the batching rule, the
    gamma as ``gamma`` draws it)."""
    ks = split(keys, 2, impl)
    n = normal(ks[..., 0, :], impl=impl)
    half_df = torch.as_tensor(df, dtype=_F32, device=keys.device) / 2.0
    g = gamma(ks[..., 1, :], half_df, impl)
    return n * sqrt_rn(half_df / g)


def kernel_constants() -> dict:
    """The constants csrc/threefry.cuh reads."""
    return {
        "LOG_P": list(_LOG_P), "LOG_Q1": _LOG_Q1, "LOG_Q2": _LOG_Q2,
        "LOG_SQRTHF": _SQRTHF, "LOG1P_Q": list(_LOG1P_Q),
        "LOG1P_P": list(_LOG1P_P), "LOG1P_SMALL": _LOG1P_SMALL,
        "ERFINV_LT5": list(_ERFINV_LT5), "ERFINV_GE5": list(_ERFINV_GE5),
    }


def asymmetric_laplace_uniform(keys: torch.Tensor,
                               impl: str = "threefry2x32") -> torch.Tensor:
    """``uniform(key, (), float32, minval=finfo(float32).tiny, maxval=1)``,
    the draw behind ``distributions.asymmetric_laplace``."""
    return uniform(keys, (), _TINY_F32, 1.0, impl=impl)
