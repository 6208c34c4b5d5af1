"""The plain version of the kernels' NaN-keeping minimum, maximum and
clamp (csrc/nanminmax.cuh, through its test entry ``kernels/block_step.py
nan_minmax``) against jnp.minimum, jnp.maximum and jnp.clip, on the CPU,
where the entry runs that plain version: NaN wherever jax has one, every
other value equal (-0.0 and +0.0 compare equal here).  The card's check,
tests/test_torch_kernels.py ``test_nan_minmax_matches_plain_on_card``,
holds the kernel to this plain version, zeros' signs included."""

import itertools

import jax.numpy as jnp
import numpy as np
import torch

from tmhpvsim_torch.kernels import block_step as k3
from test_torch_threads import one_torch_thread  # noqa: F401

#: every kind of float32 operand: NaN, the infinities, both zeros, values
#: on and between the clamp's bounds
VALUES = (np.nan, -np.inf, -2.0, -1.0, -0.0, 0.0, 0.5, 1.0, 3.0, np.inf)


def test_nan_minmax_plain_matches_jax():
    a, b = (np.asarray(v, np.float32)
            for v in zip(*itertools.product(VALUES, VALUES)))
    got = k3.nan_minmax(torch.from_numpy(a), torch.from_numpy(b), 0.0,
                        1.0).numpy()
    want = np.stack([np.asarray(f(jnp.asarray(a), jnp.asarray(b)))
                     for f in (jnp.minimum, jnp.maximum)]
                    + [np.asarray(jnp.clip(jnp.asarray(a), 0.0, 1.0))])
    assert want.dtype == got.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).any(axis=1).all()
    np.testing.assert_array_equal(got, want)
