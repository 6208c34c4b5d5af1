"""Keyed samplers for the weather models, batched over leading dims
(own copy of tmhpvsim_tpu/models/distributions.py in torch).

Every sampler takes keys of the run's implementation ``impl``
(tmhpvsim_torch/rng.py: ``(..., 2)`` threefry, ``(..., 4)`` rbg or
unsafe_rbg, whose leading dims are the vmap batch dims) and parameters
that broadcast against ``keys[..., 0]``; each key yields one scalar draw,
exactly the draw the JAX function makes from that key on the CPU. Where
XLA's CPU code contracts a multiply into an add (the Student-t and
asymmetric-Laplace steps, read off its output: a fused multiply-add per
single-use product inside one fused loop), the port uses ``rng.fma`` at
the same place, and ``rng.xla_log`` for ``log``.
"""

from __future__ import annotations

import torch

from tmhpvsim_torch import rng


def asymmetric_laplace_ppf(q, kappa):
    """Inverse CDF of the standard asymmetric Laplace distribution
    (the reference's custom scipy distribution):

        q <  k^2/(1+k^2):  x =  kappa  * log((1+k^2)/k^2 * q)
        q >= k^2/(1+k^2):  x = -1/kappa * log((1+k^2) * (1-q))
    """
    k2 = kappa * kappa
    one_k2 = rng.fma(kappa, kappa, 1.0)  # XLA fuses 1 + k^2 here ...
    split = k2 / one_k2
    # ... but not in the lower branch
    lo = kappa * rng.xla_log(torch.clamp_min((1.0 + k2) / k2 * q, 1e-38))
    hi = -rng.rdiv(1.0, kappa) * rng.xla_log(
        torch.clamp_min(one_k2 * (1.0 - q), 1e-38))
    return torch.where(q < split, lo, hi)


def asymmetric_laplace(keys, loc, scale, kappa, impl="threefry2x32"):
    """loc + scale * AL(kappa) from ``uniform(key, minval=tiny)``."""
    u = rng.asymmetric_laplace_uniform(keys, impl)
    return rng.fma(scale, asymmetric_laplace_ppf(u, kappa), loc)


def student_t(keys, loc, scale, df, impl="threefry2x32"):
    """loc + scale * t(df)."""
    return rng.fma(scale, rng.t(keys, df, impl), loc)


CLOUD_LENGTH_BETA = 1.66
CLOUD_LENGTH_XMIN_M = 0.1e3
CLOUD_LENGTH_XMAX_M = 1e6


def truncated_powerlaw_from_u(u, xmin, xmax, beta):
    """Inverse CDF of P(x) ~ x**(-beta) on [xmin, xmax] at uniforms ``u``:
    with a = xmax^(1-beta), d = xmin^(1-beta) - a, x = (a + d*U)^(1/(1-beta)).
    ``xmin`` and ``beta`` are python floats, ``xmax`` a tensor."""
    one_m_beta = 1.0 - beta
    a = xmax ** one_m_beta
    d = xmin ** one_m_beta - a
    return (a + d * u) ** (1.0 / one_m_beta)


def cloud_length_seconds_from_u(u, windspeed, xmax_m):
    """Cloud transit time [s]: truncated power-law length [m] / windspeed."""
    xmax_m = torch.clamp_min(xmax_m, 2.0 * CLOUD_LENGTH_XMIN_M)
    return truncated_powerlaw_from_u(
        u, CLOUD_LENGTH_XMIN_M, xmax_m, CLOUD_LENGTH_BETA
    ) / windspeed


WINDSPEED_SHAPE = 2.69
WINDSPEED_SCALE = 2.14


def windspeed(keys, impl="threefry2x32"):
    """Gamma(2.69, scale=2.14) windspeed [m/s]."""
    a = torch.tensor(WINDSPEED_SHAPE, dtype=torch.float32, device=keys.device)
    return WINDSPEED_SCALE * rng.gamma(keys, a, impl)


def normal(keys, loc, scale, impl="threefry2x32"):
    """loc + scale * N(0, 1) (not contracted by XLA)."""
    return loc + scale * rng.normal(keys, impl=impl)
