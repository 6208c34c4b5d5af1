"""Hourly cloud-cover Markov chain, batched over chains (own copy of
tmhpvsim_tpu/models/markov_hourly.py in torch).

    x[i+1] = clip(x[i] + step(x[i]), 0, 1)

The step comes from one of six fitted distributions, picked by the bin the
state falls in (searchsorted over the right edges): five asymmetric-Laplace
bins and one Student-t bin (data/parameters.py).  Both variates are drawn
from independent key splits and the bin's mark selects one, as in the JAX
package, so the draws match key for key.  A heterogeneous fleet gives each
chain its own weather-regime table (``regime_step_params`` /
``select_regime``).
"""

from __future__ import annotations

import numpy as np
import torch

from tmhpvsim_torch import rng
from tmhpvsim_torch.data import (MARKOV_STEP_BINS, MARKOV_STEP_PARAMS,
                                 MARKOV_STEP_PARAMS_REGIMES)
from tmhpvsim_torch.models import distributions as dist


def _stacked(table, device):
    """Per-bin leaves of ``table`` ((..., 6, 5) rows) as float32 tensors,
    each (..., 6), plus the shared bin edges."""
    p = np.asarray(table, dtype=np.float64)

    def f32(v):
        return torch.tensor(np.asarray(v, np.float32), device=device)

    return {
        "bins": f32(MARKOV_STEP_BINS),
        "loc": f32(p[..., 0]),
        "scale": f32(p[..., 1]),
        "kappa": f32(p[..., 2]),
        "df": f32(p[..., 3]),
        "is_t": f32(p[..., 4]),
    }


def step_params(device=None):
    """Stacked per-bin step-distribution parameters (float32 tensors)."""
    return _stacked(MARKOV_STEP_PARAMS, device)


def regime_step_params(device=None):
    """Every weather-regime table stacked on a leading regime axis: each
    per-bin leaf becomes (n_regimes, 6), ``bins`` stays shared.  Row 0 is
    the Munich fit, so ``select_regime(regime_step_params(), 0)`` equals
    ``step_params()`` exactly."""
    return _stacked(MARKOV_STEP_PARAMS_REGIMES, device)


def select_regime(regime_params, regime):
    """The step tables of ``regime``: an int gives (6,) leaves, an
    ``(n,)`` integer tensor one (6,) row per chain, ``(n, 6)``."""
    if isinstance(regime, torch.Tensor):
        regime = regime.long()
    return {k: (v if k == "bins" else v[regime])
            for k, v in regime_params.items()}


def _take(v, idx):
    """``v[idx]`` for shared (6,) leaves; per-chain (n, 6) leaves take
    each chain's own row."""
    if v.dim() == 1:
        return v[idx]
    return v.gather(-1, idx.unsqueeze(-1)).squeeze(-1)


def transition(keys, state, params, impl="threefry2x32"):
    """One Markov transition of ``state`` (any shape; keys ``(*shape, w)``
    of ``impl``, batched over ``shape``; per-chain ``params`` leaves
    ``(*shape, 6)`` from ``select_regime``)."""
    idx = torch.searchsorted(params["bins"], state.contiguous(), right=False)
    idx = torch.clamp(idx, 0, params["loc"].shape[-1] - 1)
    loc = _take(params["loc"], idx)
    scale = _take(params["scale"], idx)
    kappa = _take(params["kappa"], idx)
    df = _take(params["df"], idx)
    is_t = _take(params["is_t"], idx)
    ks = rng.split(keys, 2, impl)
    d_al = dist.asymmetric_laplace(ks[..., 0, :], loc, scale, kappa, impl)
    d_t = dist.student_t(ks[..., 1, :], loc, scale, df, impl)
    step = torch.where(is_t > 0.5, d_t, d_al)
    return torch.clamp(state + step, 0.0, 1.0)


def chain_window(keys, start: int, n: int, state, params=None,
                 impl="threefry2x32"):
    """``n`` successive states for global indices [start, start+n) of each
    chain, continuing from ``state`` (the state before transition
    ``start``); transition i is keyed by ``fold_in(key, i)`` (the JAX
    scan's, one index per step, so never a batched datum).  ``keys`` is
    ``(chains, w)``, ``state`` ``(chains,)``.  Returns
    ``(values (chains, n), final state)``."""
    if params is None:
        params = step_params(keys.device)
    out = []
    for i in range(n):
        state = transition(rng.fold_in(keys, start + i, impl), state,
                           params, impl)
        out.append(state)
    if not out:
        return state.new_empty(state.shape + (0,)), state
    return torch.stack(out, dim=-1), state


# ---------------------------------------------------------------------------
# float64 numpy chain (the golden model's, engine/golden.py)
# ---------------------------------------------------------------------------

_BINS64 = np.asarray(MARKOV_STEP_BINS, dtype=np.float64)
_PARAMS64 = np.asarray(MARKOV_STEP_PARAMS, dtype=np.float64)


def transition_numpy(rng: np.random.Generator, state: float) -> float:
    """One float64 transition from numpy draws (the JAX package's
    ``transition_numpy``): the same model as :func:`transition`, an
    independent code path and random stream (inverse-CDF from a numpy
    uniform, or ``standard_t``)."""
    idx = np.searchsorted(_BINS64, state, side="left")
    loc, scale, kappa, df, is_t = _PARAMS64[min(idx, len(_PARAMS64) - 1)]
    if is_t > 0.5:
        step = loc + scale * rng.standard_t(df)
    else:
        u = rng.uniform()
        k2 = kappa * kappa
        if u < k2 / (1 + k2):
            x = kappa * np.log((1 + k2) / k2 * u)
        else:
            x = -np.log((1 + k2) * (1 - u)) / kappa
        step = loc + scale * x
    return float(np.clip(state + step, 0.0, 1.0))


def chain_numpy(rng: np.random.Generator, n_samples, initial_state=1.0):
    """A float64 persistent chain of ``n_samples`` states."""
    state = float(np.clip(initial_state, 0.0, 1.0))
    out = np.empty(n_samples)
    for i in range(n_samples):
        state = transition_numpy(rng, state)
        out[i] = state
    return out
