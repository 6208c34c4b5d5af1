"""Checkpoints across the two packages, on the CPU: one written by the JAX
package (``tmhpvsim_tpu.engine.checkpoint.save``) resumes in the port, one
written by the port resumes in the JAX package, and both resumed runs are
held to the uninterrupted JAX run at the engine tolerance (``n_seconds``
exact, the rest rtol 2e-5, atol 1e-2; tests/test_engine.py), the JAX runs
in the scan formulation.  Under rbg keys a JAX checkpoint of the initial
state is the port's initial state: key data bit for bit, floats at the
engine tolerance.

One JAX run serves both directions: it runs to its end, saving after its
first block on the way, and then resumes the port's checkpoint.
"""

import numpy as np
import pytest

from tmhpvsim_torch import config as tcfg
from tmhpvsim_torch.engine import checkpoint as ckpt
from tmhpvsim_torch.engine import convert
from tmhpvsim_torch.engine.simulation import Simulation as TSim
from tmhpvsim_tpu import config as jcfg
from tmhpvsim_tpu.engine import Simulation as JSim
from tmhpvsim_tpu.engine import checkpoint as jckpt

SHAPE = dict(start="2019-09-05 10:00:00", duration_s=360, n_chains=8,
             seed=13, block_s=120, output="reduce")


def _jax_sim(**kw):
    return JSim(jcfg.SimConfig(block_impl="scan", scan_unroll=1,
                               dtype="float32", **dict(SHAPE, **kw)))


def _assert_engine_close(want, got):
    np.testing.assert_array_equal(got["n_seconds"], want["n_seconds"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-2,
                                   err_msg=k)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX run's sim, its uninterrupted reduce rows and the checkpoint
    its save wrote after block 1."""
    path = str(tmp_path_factory.mktemp("jax") / "jax.npz")
    js = _jax_sim()

    def hook(bi, state, acc):
        if bi == 0:
            jckpt.save(path, {"state": state, "acc": acc}, 1, js.config,
                       layout=js.checkpoint_layout())

    want = {k: np.asarray(v) for k, v in js.run_reduced(on_block=hook)
            .items()}
    return js, want, path


def test_jax_checkpoint_resumes_in_port(jax_run):
    """The port loads the JAX file (its config check passes: the echoes
    are the same JSON) and finishes the run."""
    _, want, path = jax_run
    sim = TSim(tcfg.SimConfig(**SHAPE), device="cpu")
    tree, nb = ckpt.load(path, sim.config)
    assert nb == 1 and ckpt.peek_meta(path)["prng_impl"] == "threefry2x32"
    got = sim.run_reduced(state=tree["state"], acc=tree["acc"],
                          start_block=nb)
    _assert_engine_close(want, got)


def test_port_checkpoint_resumes_in_jax(jax_run, tmp_path):
    """The JAX package loads the port's file, with its generations,
    manifest and layout, and finishes the run."""
    js, want, _ = jax_run
    path = str(tmp_path / "port.npz")
    sim = TSim(tcfg.SimConfig(**SHAPE), device="cpu")

    def hook(bi, state, acc):
        if bi == 0:
            ckpt.save(path, {"state": state, "acc": acc}, 1, sim.config,
                      layout=sim.checkpoint_layout())

    sim.run_reduced(on_block=hook)
    assert jckpt.resumable(path)
    tree, nb = jckpt.load_elastic(path, js.config)
    assert nb == 1
    got = {k: np.asarray(v) for k, v in js.run_reduced(
        state=tree["state"], acc=tree["acc"], start_block=nb).items()}
    _assert_engine_close(want, got)
    with pytest.raises(ValueError, match="different configuration"):
        jckpt.load(path, jcfg.SimConfig(dtype="float32",
                                        **dict(SHAPE, seed=14)))


def test_jax_rbg_checkpoint_is_the_port_state(tmp_path):
    """A JAX rbg checkpoint (4-word key data, ``prng_impl`` 'rbg' in its
    meta) of the initial state loads into the port as the port's own
    initial state: the key data bit for bit, the floats (the renewal
    carry's logs, in the suite's x64 mode) at the engine tolerance."""
    js = JSim(jcfg.SimConfig(dtype="float32", prng_impl="rbg", **SHAPE))
    path = str(tmp_path / "rbg.npz")
    jckpt.save(path, js.init_state(), 0, js.config)
    sim = TSim(tcfg.SimConfig(prng_impl="rbg", **SHAPE), device="cpu")
    tree, nb = ckpt.load(path, sim.config)
    got = convert.state_to_numpy(sim._resume_tree(tree, "state"), "rbg")
    want = convert.state_to_numpy(sim.init_state(), "rbg")
    got = ckpt._flatten(got)
    for k, v in ckpt._flatten(want).items():
        if k.startswith("key:"):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=2e-5, atol=1e-2,
                                       err_msg=k)
