"""The fleet observers' two-launch form (the acc producer, then the
observer fold) against the one-launch form it replaces and against the
JAX package, on the CPU.

Tolerances:
* the composition ``obs_producer_plain`` + ``obs_fold_plain`` (what
  ``block_step_obs_plain`` now is) against a frozen copy of the fused
  plain version it replaced: bit for bit, every tensor compared by its
  bits (NaN payloads and zero signs included), in float32 and bf16, at
  every telemetry x analytics level, with and without cohorts, and with
  NaN and signed-zero fleet leaves on a padded block;
* the composition against the JAX package's
  ``_block_step_scan_acc_tel_fleet`` (one block of a 12-site fleet,
  telemetry and analytics full, float32 in x32): the reduce statistics at
  the engine tolerance (rtol 2e-5 / atol 1e-2, n_seconds exact, as
  tests/test_torch_fleet.py), the observers' integer leaves exact, their
  extrema at the engine tolerance and their sums over chains rel 1e-4
  (tests/test_torch_obs.py: the port adds chains in float64 and rounds
  once, the JAX package adds float32 in XLA's order).
"""

import jax
import numpy as np
import pytest
import torch

from tmhpvsim_torch.config import SimConfig
from tmhpvsim_torch.engine.simulation import REDUCE_STATS, Simulation
from tmhpvsim_torch.fleet import FleetParams
from tmhpvsim_torch.kernels import block_step as k3
from tmhpvsim_torch.obs import analytics as flt
from tmhpvsim_torch.obs import telemetry as tel
from tmhpvsim_tpu import config as jcfg
from tmhpvsim_tpu.engine import Simulation as JSim
from tmhpvsim_tpu.fleet import FleetParams as JFleet
from test_torch_threads import one_torch_thread  # noqa: F401

#: 12 sites over two 600 s blocks from 11:00, the second padded (300 s)
CFG = dict(start="2019-09-05 11:00:00", duration_s=900, n_chains=12,
           seed=5, block_s=600)
FLEET = (12, 3)  # FleetParams.synthetic(12, seed=3): 3 regimes, 3 cohorts
#: NaN fleet leaves (tests/test_torch_fleet.py NAN_LEAVES), and leaves
#: that make a meter of -0.0 (chain 3) and a pv of -0.0 (chain 5)
NAN_LEAVES = (("demand_scale", 1, float("nan")),
              ("demand_shift_w", 4, float("nan")),
              ("pv_scale", 7, float("nan")),
              ("ac_limit_w", 10, float("nan")),
              ("demand_scale", 3, -0.0), ("demand_shift_w", 3, -0.0),
              ("pv_scale", 5, -0.0))


def fused_obs_plain(tables, rows_i, rows_f, k_scan, k_meter, carry, acc,
                    duration_s, meter_max_w, surface_tilt, albedo,
                    site=None, fleet=None, obs=None, kernels="exact",
                    compute_dtype="f32", layout="scan",
                    impl="threefry2x32"):
    """The one-launch plain K8 / K9 as it was before the observer fold
    (frozen): the acc epilogue with the observers' per-chain folds beside
    the statistics, then their reduce_chainwise."""
    carry, meter, ac, csi, covered = k3._body_plain(
        tables, rows_i, rows_f, k_scan, k_meter, carry, meter_max_w,
        surface_tilt, albedo, site, fleet, kernels, compute_dtype,
        layout=layout, impl=impl)
    n, dev = ac.shape[1], ac.device
    cohorts = obs.n_cohorts if obs.n_cohorts >= 2 else 0
    st = {"ta": None if obs.telemetry == "off" else
          tel.init_acc(obs.telemetry, n, dev),
          "fa": None if obs.analytics == "off" else
          flt.init_acc(obs.analytics, n, params=obs.params,
                       cohorts=cohorts, device=dev)}
    t_rows = rows_i[0].tolist()

    def hook(s, ok, res):
        if st["ta"] is not None:
            st["ta"] = tel.fold_second(
                st["ta"], obs.telemetry, meter=meter[s], pv=ac[s],
                csi=csi[s], residual=res, covered=covered[s], valid=ok)
        if st["fa"] is not None:
            st["fa"] = flt.fold_second(
                st["fa"], obs.analytics, obs.params, meter=meter[s],
                pv=ac[s], residual=res, covered=covered[s], t=t_rows[s],
                valid=ok, cohort=obs.cohort)

    acc = k3.stats_fold_plain(acc, rows_i[0], duration_s, meter, ac, hook)
    ta, fa = st["ta"], st["fa"]
    out = {"telemetry": None if ta is None else tel.reduce_chainwise(ta),
           "fleet": None if fa is None else
           flt.reduce_chainwise(fa, cohort=obs.cohort)}
    if obs.per_chain:
        out["telemetry_chain"], out["fleet_chain"] = ta, fa
    return carry, acc, out


def _bits(t):
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t


def _assert_same(got, want, path=""):
    """Equal structure and every tensor equal bit for bit."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif want is None:
        assert got is None, path
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(_bits(got), _bits(want)), path


def _block(compute_dtype, block_i, leaves=()):
    cfg = SimConfig(**dict(CFG, fleet=FleetParams.synthetic(*FLEET[:1],
                                                            seed=FLEET[1]),
                           compute_dtype=compute_dtype))
    sim = Simulation(cfg, device="cpu")
    state = sim.init_state()
    for leaf, c, v in leaves:
        state["fleet"][leaf][c] = v
    for b in range(block_i):
        state, _ = sim.step_acc(state, sim.host_inputs(b),
                                sim.init_reduce_acc())
    ins = sim.host_inputs(block_i)
    tables, _ = sim._windows(state, ins)
    head = (tables, ins.rows_i, ins.rows_f, state["k_scan"],
            state["k_meter"])
    tail = (cfg.duration_s, cfg.meter_max_w, None, None)
    _, _, site = sim.geometry_args(state)
    return sim, state, head, tail, dict(site=site,
                                        fleet=sim.fleet_leaves(state),
                                        compute_dtype=compute_dtype)


CASES = [(cd, tl, al, coh, False) for cd in ("f32", "bf16")
         for tl in ("light", "full") for al in ("risk", "full")
         for coh in (0, 3)] + [(cd, "full", "full", 3, True)
                               for cd in ("f32", "bf16")]


@pytest.mark.parametrize(
    "compute_dtype, telemetry, analytics, cohorts, nan", CASES,
    ids=[f"{cd}-tel_{tl}-flt_{al}-coh{c}" + ("-nan_zero" if nan else "")
         for cd, tl, al, c, nan in CASES])
def test_composition_is_the_fused_plain_bit_for_bit(
        compute_dtype, telemetry, analytics, cohorts, nan):
    """obs_producer_plain + obs_fold_plain (block_step_obs_plain) equal
    the frozen one-launch plain version: the carry, the statistics, every
    collapsed telemetry and fleet leaf (histograms, cohort rows) and every
    per-chain leaf, bit for bit; with NaN and -0.0 fleet leaves on the
    padded block too."""
    sim, state, head, tail, kw = _block(compute_dtype, 1 if nan else 0,
                                        NAN_LEAVES if nan else ())
    cohort = torch.as_tensor(np.asarray(sim.config.fleet.cohort),
                             dtype=torch.int32) if cohorts else None
    obs = k3.Observers(telemetry=telemetry, analytics=analytics,
                       params=flt.params_from_config(sim.config),
                       n_cohorts=cohorts,
                       cohort=cohort, per_chain=True)

    def carry():
        return {k: v.clone() for k, v in state["carry"].items()}

    want = fused_obs_plain(*head, carry(), sim.init_reduce_acc(), *tail,
                           obs=obs, **kw)
    got = k3.block_step_obs_plain(*head, carry(), sim.init_reduce_acc(),
                                  *tail, obs=obs, **kw)
    _assert_same(got[0], want[0], "carry")
    _assert_same(got[1], want[1], "acc")
    _assert_same(got[2], want[2], "out")
    # the two launches on their own: the producer's statistics and carry
    # are the acc step's, and the fold of its arrays is the delta
    c2, a2, prod = k3.obs_producer(*head, carry(), sim.init_reduce_acc(),
                                   *tail, obs=obs, **kw)
    _assert_same(c2, want[0], "producer carry")
    _assert_same(a2, want[1], "producer acc")
    ca, aa = k3.block_step_acc(*head, carry(), sim.init_reduce_acc(), *tail,
                               **kw)
    _assert_same(aa, want[1], "acc launch")
    _assert_same(k3.obs_fold(prod, head[1][0], tail[0], obs), want[2],
                 "fold")
    if nan:  # the leaves did reach the folds
        assert bool(want[1]["residual_min"].isnan().any())
        assert int(want[2]["telemetry"]["nan_residual"]) > 0
        for k, c in (("meter", 3), ("pv", 5)):
            v = prod[k][:, c]
            assert bool((v == 0).all() and torch.signbit(v).all()), k


def test_composition_matches_jax_tel_fleet_block():
    """The composition through the engine (one reduce block of a 12-site
    fleet, telemetry and analytics full, on the CPU) against the JAX
    package's ``_block_step_scan_acc_tel_fleet`` (block_impl 'scan',
    float32, x32): statistics at the engine tolerance, the observers'
    integer leaves exact, extrema at the engine tolerance, sums rel
    1e-4."""
    kw = dict(CFG, duration_s=600, telemetry="full", analytics="full")
    with jax.enable_x64(False):
        js = JSim(jcfg.SimConfig(
            block_impl="scan", dtype="float32", scan_unroll=1,
            fleet=JFleet.synthetic(FLEET[0], seed=FLEET[1]), **kw))
        want = {k: np.asarray(v) for k, v in js.run_reduced().items()}
        wt = {k: np.asarray(v) for k, v in js._tel_last.items()}
        wf = {k: np.asarray(v) for k, v in js._fleet_last.items()}
    ts = Simulation(SimConfig(
        fleet=FleetParams.synthetic(FLEET[0], seed=FLEET[1]), **kw),
        device="cpu")
    folds = []
    real = k3.obs_fold_plain

    def spy(*a, **k):
        folds.append(1)
        return real(*a, **k)

    k3.obs_fold_plain = spy
    try:
        got = ts.run_reduced()
    finally:
        k3.obs_fold_plain = real
    assert folds == [1]
    np.testing.assert_array_equal(np.asarray(got["n_seconds"]),
                                  want["n_seconds"])
    for k in REDUCE_STATS:
        np.testing.assert_allclose(np.asarray(got[k]), want[k], rtol=2e-5,
                                   atol=1e-2, err_msg=k)
    for name, w_, g_ in (("telemetry", wt, ts._tel_last),
                         ("fleet", wf, ts._fleet_last)):
        assert set(g_) == set(w_), name
        for k, w in w_.items():
            g = g_[k].numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, (name, k)
            if "sum" in k and g.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=1e-4,
                                           err_msg=f"{name} {k}")
            elif g.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=2e-5, atol=1e-2,
                                           err_msg=f"{name} {k}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{name} {k}")
    assert int(wf["count"]) > 0 and int(np.asarray(wt["count"])) > 0
