"""A slabbed run under rbg keys (tmhpvsim_torch/engine/slab.py), where a
slab changes every chain's draws as in the JAX package, against the JAX
package's slabbed run on the CPU (``plan=`` with ``slab_chains`` 4 of 8
chains, the scan formulation): ``n_seconds`` exact, the rest at the
engine tolerance, rtol 2e-5, atol 1e-2.  The JAX run's compile makes this
a file of its own (tests/test_torch_slab.py holds the port's slabs to its
unslabbed run).
"""

import dataclasses

import numpy as np
import pytest

from tmhpvsim_torch.engine.simulation import Simulation as TSim
from test_torch_slab import SHAPE, cfg, slabbed
from tmhpvsim_tpu import config as jcfg
from tmhpvsim_tpu.engine import Simulation as JSim
from tmhpvsim_tpu.engine import autotune


@pytest.mark.filterwarnings("ignore:prng_impl=:RuntimeWarning")
def test_rbg_slabbed_run_is_the_jax_slabbed_run():
    jc = jcfg.SimConfig(block_impl="scan", scan_unroll=1, dtype="float32",
                        output="reduce", prng_impl="rbg", **SHAPE)
    plan = dataclasses.replace(autotune.static_plan(jc), slab_chains=4)
    want = {k: np.asarray(v)
            for k, v in JSim(jc, plan=plan).run_reduced().items()}
    c = cfg(output="reduce", prng_impl="rbg")
    got = TSim(c, device="cpu", plan=slabbed(c, 4)).run_reduced()
    np.testing.assert_array_equal(got["n_seconds"], want["n_seconds"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-2,
                                   err_msg=k)
