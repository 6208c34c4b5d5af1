"""Chain slabs (tmhpvsim_torch/engine/slab.py) on the CPU: under
threefry2x32 a slabbed ``run_reduced`` and ``run_ensemble`` (uneven slabs
of 3 + 3 + 2 chains) are the unslabbed port run bit for bit, the fleet
analytics' run totals merge across slabs to the unslabbed totals (counts
and extrema exact, float sums rtol 1e-6).  Under rbg keys a slab changes
every chain's draws: tests/test_torch_slab_jax.py holds that run to the
JAX package's slabbed run.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tmhpvsim_torch import config as tcfg
from tmhpvsim_torch.engine.simulation import REDUCE_STATS
from tmhpvsim_torch.engine.simulation import Simulation as TSim
from tmhpvsim_torch.engine.slab import SlabScheduler
from tmhpvsim_torch.kernels import block_step as k3
from tmhpvsim_torch.parallel import distributed
from test_torch_threads import one_torch_thread  # noqa: F401

SHAPE = dict(start="2019-09-05 10:00:00", duration_s=360, n_chains=8,
             seed=13, block_s=120)


def cfg(**kw):
    return tcfg.SimConfig(**dict(SHAPE, **kw))


def slabbed(c, n):
    return dataclasses.replace(tcfg.resolve_plan(c), slab_chains=n)


def test_plan_does_not_slab_by_default():
    c = cfg(output="reduce")
    assert tcfg.resolve_plan(c).slab_chains == 8
    assert TSim(c, device="cpu")._slab_scheduler() is None


def test_slabbed_reduce_is_the_unslabbed_run():
    """Rows bit for bit, ``ensemble_stats`` equal, and ``on_block`` sees
    a global block counter, slab-major."""
    c = cfg(output="reduce")
    full = TSim(c, device="cpu")
    want = full.run_reduced()
    sim = TSim(c, device="cpu", plan=slabbed(c, 3))
    seen = []
    got = sim.run_reduced(on_block=lambda bi, s, a: seen.append(bi))
    assert seen == list(range(9))
    for k in REDUCE_STATS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sim.ensemble_stats() == full.ensemble_stats()


def test_slabbed_ensemble_is_the_unslabbed_run():
    """The slabs' series parts, joined before their last fold, give the
    unslabbed per-second means bit for bit."""
    c = cfg(output="ensemble")
    want = list(TSim(c, device="cpu").run_ensemble())
    got = list(TSim(c, device="cpu", plan=slabbed(c, 3)).run_ensemble())
    assert [b.offset for b in got] == [b.offset for b in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.epoch, w.epoch)
        for f in ("meter", "pv", "residual"):
            assert getattr(g, f).dtype == getattr(w, f).dtype
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                          err_msg=f)


def test_series_strands_fold_ranges_as_one():
    """Float32 per-CTA partials folded range by range into float64 strands
    (each range's first part numbered after the parts before it) give
    ``series_sum_plain``'s bits over all of them, the card kernel's."""
    rng = np.random.default_rng(5)
    part = torch.from_numpy(
        (rng.standard_normal((2, 97, 50)) * 10.0 ** rng.integers(
            -6, 6, (2, 97, 50))).astype(np.float32))
    want = k3.series_sum_plain(part)
    for cuts in ((0, 40, 80, 97), (0, 1, 33, 64, 96, 97), (0, 97)):
        strands = None
        for lo, hi in zip(cuts, cuts[1:]):
            strands = k3.series_strands(part[:, lo:hi], strands, lo)
        assert strands.shape == (2, k3.SUM_STRANDS, 50)
        assert strands.dtype == torch.float64
        assert torch.equal(k3.strands_total(strands), want), cuts


def test_slabbed_ensemble_in_the_card_order(monkeypatch):
    """With the card's float32 per-CTA partials as the series parts
    (``series_partials_plain``, equal to the kernel's bit for bit),
    slabs of whole CTAs (128 + 128 + 64 chains) give the unslabbed
    per-second means bit for bit."""
    monkeypatch.setattr(k3, "series_parts_plain", k3.series_partials_plain)
    c = cfg(output="ensemble", n_chains=2 * k3.THREADS + 64)
    want = list(TSim(c, device="cpu").run_ensemble())
    got = list(TSim(c, device="cpu",
                    plan=slabbed(c, k3.THREADS)).run_ensemble())
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for f in ("meter", "pv", "residual"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                          err_msg=f)


def test_fleet_totals_merge_across_slabs():
    c = cfg(output="reduce", analytics="risk")
    full = TSim(c, device="cpu")
    full.run_reduced()
    sim = TSim(c, device="cpu", plan=slabbed(c, 3))
    sim.run_reduced()
    want, got = full._fleet_total, sim._fleet_total
    assert set(got) == set(want)
    for k, v in want.items():
        if v.dtype.kind == "f" and not k.startswith(("min", "max")):
            np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_scheduler_layout_and_guards():
    c = cfg(output="reduce")
    sched = SlabScheduler(c, slabbed(c, 3))
    assert len(sched) == 3
    assert [s.chain_offset for s in sched.slab_cfgs] == [0, 3, 6]
    assert sched.checkpoint_layout() == distributed.chain_layout(8)
    with pytest.raises(ValueError, match="slab_chains"):
        SlabScheduler(c, slabbed(c, 8))
    part = cfg(output="reduce", n_chains=2, n_chains_total=8,
               chain_offset=2)
    with pytest.raises(ValueError, match="n_chains_total"):
        SlabScheduler(part, slabbed(part, 1))
    assert TSim(part, device="cpu", plan=slabbed(part, 1)) \
        ._slab_scheduler() is None
    sim = TSim(c, device="cpu", plan=slabbed(c, 3))
    sim.allow_slabs = False
    assert sim._slab_scheduler() is None
