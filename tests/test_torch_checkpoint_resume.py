"""A port run stopped after a block and resumed from its checkpoint is the
uninterrupted port run bit for bit: reduce, trace and ensemble output,
under threefry2x32, rbg and unsafe_rbg keys, and under several blocks a
dispatch (where only a dispatch group's last block saves), on the CPU.

Each case runs once to its end, saving a checkpoint after its first
block on the way (the state it saves is the state a stopped run leaves),
then a fresh Simulation resumes from that file.  Port meets port: bit
for bit.
"""

import numpy as np
import pytest

from tmhpvsim_torch import config as tcfg
from tmhpvsim_torch.engine import checkpoint as ckpt
from tmhpvsim_torch.engine.simulation import REDUCE_STATS
from tmhpvsim_torch.engine.simulation import Simulation as TSim

SHAPE = dict(start="2019-09-05 10:00:00", duration_s=360, n_chains=8,
             seed=13, block_s=120)
IMPLS = ("threefry2x32", "rbg", "unsafe_rbg")

pytestmark = pytest.mark.filterwarnings(
    "ignore:prng_impl=:RuntimeWarning")


def cfg(**kw):
    return tcfg.SimConfig(**dict(SHAPE, **kw))


def _blocks(blocks):
    return {f: np.concatenate([getattr(b, f) for b in blocks], axis=1)
            for f in ("meter", "pv", "residual")}


@pytest.mark.parametrize("impl", IMPLS)
def test_port_reduce_resume_is_the_straight_run(tmp_path, impl):
    c = cfg(output="reduce", prng_impl=impl)
    path = str(tmp_path / "r.npz")
    sim = TSim(c, device="cpu")

    def save(bi, state, acc):
        if bi == 0:
            ckpt.save(path, {"state": state, "acc": acc}, bi + 1,
                      sim.config, layout=sim.checkpoint_layout())

    straight = sim.run_reduced(on_block=save)
    fresh = TSim(c, device="cpu")
    tree, nb = ckpt.load(path, fresh.config)
    assert nb == 1
    got = fresh.run_reduced(state=tree["state"], acc=tree["acc"],
                            start_block=nb)
    for k in REDUCE_STATS:
        np.testing.assert_array_equal(got[k], straight[k], err_msg=k)
    assert fresh.ensemble_stats() == sim.ensemble_stats()


@pytest.mark.parametrize("mode", ["trace", "ensemble"])
@pytest.mark.parametrize("impl", IMPLS)
def test_port_rows_resume_are_the_straight_run(tmp_path, impl, mode):
    """Trace and ensemble: the resumed run's blocks are the uninterrupted
    run's blocks after the checkpoint (the saving run steps one block at
    a time, ``output_overlap='off'``, as a checkpointed run does)."""
    c = cfg(output=mode, prng_impl=impl, output_overlap="off")
    path = str(tmp_path / "t.npz")
    sim = TSim(c, device="cpu")
    run = sim.run_ensemble if mode == "ensemble" else sim.run_blocks
    straight = []
    for bi, blk in enumerate(run()):
        straight.append(blk)
        if bi == 0:
            assert sim.state_block == 1
            ckpt.save(path, sim.state, 1, sim.config)
    fresh = TSim(cfg(output=mode, prng_impl=impl), device="cpu")
    state, nb = ckpt.load(path, fresh.config)
    rerun = fresh.run_ensemble if mode == "ensemble" else fresh.run_blocks
    got = list(rerun(state=state, start_block=nb))
    assert [b.offset for b in got] == [b.offset for b in straight[1:]]
    want, have = _blocks(straight[1:]), _blocks(got)
    for f in want:
        np.testing.assert_array_equal(have[f], want[f], err_msg=f)


def test_dispatch_groups_save_at_group_ends(tmp_path):
    """Under two blocks a dispatch the run's state advances a group at a
    time: the ``state_block`` gate saves after blocks 2 and 3 only, and a
    resume from block 2 is the uninterrupted run."""
    c = cfg(output="reduce", blocks_per_dispatch=2)
    path = str(tmp_path / "g.npz")
    sim = TSim(c, device="cpu")
    saved = []

    def save(bi, state, acc):
        if sim.state_block == bi + 1:
            ckpt.save(path, {"state": state, "acc": acc}, bi + 1,
                      sim.config, keep=5)
            saved.append(bi + 1)

    straight = sim.run_reduced(on_block=save)
    assert saved == [2, 3]
    assert ckpt.load(path, sim.config)[1] == 3
    # generation 1 holds the state and accumulator after block 2
    flat, meta = ckpt._read_npz(f"{path}.g1")
    assert meta["next_block"] == 2
    tree = ckpt._unflatten(flat)
    got = TSim(c, device="cpu").run_reduced(
        state=tree["state"], acc=tree["acc"], start_block=2)
    for k in REDUCE_STATS:
        np.testing.assert_array_equal(got[k], straight[k], err_msg=k)
