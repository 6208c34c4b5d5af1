"""K10 against the JAX package at width and exactly, on the CPU: the
scenario step at 256 chains over tests/test_serve.py's two blocks in
float32 and bf16 (tests/test_torch_serve.py's tolerances, bf16 as
``_same_stats_bf16`` says), the scenario demand transform as one
multiply-add (bit for bit against exact JAX values), and the site and
cohort selectors in both packages' engines (the engine tolerance).  The
heaviest of the scenario checks, in a file of their own so that a run of
the suite that splits its workers by file takes them apart from
tests/test_torch_serve.py's.
"""

import dataclasses
from fractions import Fraction

import numpy as np
import pytest
import torch

from test_torch_serve import (_jax_state_numpy, _same_delta, _same_stats,
                              jcfg, req, tcfg)
from tmhpvsim_torch.engine import convert
from tmhpvsim_torch.engine.simulation import Simulation as TSim
from tmhpvsim_torch.fleet import FleetParams as TFleet
from tmhpvsim_torch.kernels import block_step as k3
from tmhpvsim_torch.serve import schema as tschema
from tmhpvsim_torch.serve import server as tserver
from tmhpvsim_tpu.engine import Simulation as JSim
from tmhpvsim_tpu.fleet import FleetParams as JFleet
from tmhpvsim_tpu.obs.metrics import MetricsRegistry as JRegistry
from tmhpvsim_tpu.obs.metrics import use_registry as j_use_registry
from tmhpvsim_tpu.serve import schema as jschema
from tmhpvsim_tpu.serve.server import ScenarioEngine as JEngine


#: the width of the K10 check against the JAX engine: a few hundred
#: chains over BASE's two blocks
WIDE_CHAINS = 256


@pytest.fixture(scope="module")
def wide_slack():
    """``slack`` at WIDE_CHAINS chains."""
    want = list(JSim(jcfg(output="trace", n_chains=WIDE_CHAINS))
                .run_blocks())
    got = list(TSim(tcfg(output="trace", n_chains=WIDE_CHAINS),
                    device="cpu").run_blocks())
    return sum(int((np.asarray(w.residual) != g.residual).sum())
               for w, g in zip(want, got))


#: bf16 at width: where a float32 step that XLA contracts otherwise moves
#: a value across a bf16 rounding boundary, that second's pv moves by up
#: to a few percent (ROADMAP Queue 3 bounds the narrowed geometry's
#: divergence alike: none beyond 5 %)
BF16_SHARE, BF16_RTOL = 0.01, 0.05


def _same_stats_bf16(got, want):
    """bf16 at width: n_seconds exact; of every float statistic at most
    BF16_SHARE of the (row, chain) entries outside the engine tolerance,
    and none beyond BF16_RTOL."""
    assert set(got) == set(want)
    for k, w in want.items():
        w, g = np.asarray(w, np.float64), np.asarray(got[k], np.float64)
        if k == "n_seconds":
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        off = ~np.isclose(g, w, rtol=2e-5, atol=1e-2)
        assert off.mean() <= BF16_SHARE, (k, int(off.sum()))
        np.testing.assert_allclose(g, w, rtol=BF16_RTOL, atol=1e-2,
                                   err_msg=k)


@pytest.mark.parametrize("compute_dtype", ["f32", "bf16"])
def test_scenario_step_matches_jax_at_width(compute_dtype, wide_slack):
    """K10 as the port runs it (its producer's meter and pv, then its
    fold, both plain on the CPU) at WIDE_CHAINS chains over two blocks,
    on the JAX package's own state, against the JAX ScenarioEngine's
    ``scenario_step`` with ``block_impl='scan'`` pinned, in float32 and
    bf16: neutral, transformed, site-selected, short-horizon and padding
    rows.  float32: statistics at the engine tolerance, the FleetAcc as
    ``_same_delta`` holds it; bf16: ``_same_stats_bf16``, the FleetAcc's
    counts as in float32 and its extrema within BF16_RTOL."""
    kw = {} if compute_dtype == "f32" else dict(compute_dtype="bf16")
    with j_use_registry(JRegistry()):
        js = JSim(jcfg(serve_batch_sizes=(8,), n_chains=WIDE_CHAINS, **kw))
    ts = TSim(tcfg(n_chains=WIDE_CHAINS, **kw), device="cpu")
    scs = [jschema.parse_scenario(d, max_horizon_s=120,
                                  n_sites=WIDE_CHAINS)
           for d in ({"horizon_s": 120},
                     {"demand_scale": 1.5, "demand_shift_w": 250.0,
                      "dc_capacity_scale": 2.0, "weather_bias": 0.5,
                      "curtail_w": 40.0, "horizon_s": 120},
                     {"site_index": 77, "horizon_s": 120},
                     {"demand_scale": 0.7, "demand_shift_w": -300.0,
                      "horizon_s": 90},
                     {"horizon_s": 30})]
    scen = jschema.encode_batch(scs, 8, np.float32)   # rows 5-7: padding
    jstate = js.init_state()
    jacc = js.init_scenario_acc(8)
    tstate = convert.state_from_numpy(_jax_state_numpy(jstate), "cpu",
                                      ts.plan.prng_impl)
    tacc = convert.acc_from_numpy(
        {k: np.asarray(v) for k, v in jacc.items()}, "cpu")
    for bi in range(js.n_blocks):
        jstate, jacc, jdelta = js.scenario_step(
            jstate, js.host_inputs(bi)[0], jacc, scen)
        tstate, tacc, tdelta = ts.scenario_step(
            tstate, ts.host_inputs(bi), tacc,
            convert.scen_from_numpy(scen, "cpu"))
        got = convert.acc_to_numpy(tacc)
        want = {k: np.asarray(v) for k, v in jacc.items()}
        gd = convert.fleet_delta_to_numpy(tdelta)
        wd = {k: np.asarray(v) for k, v in jdelta.items()}
        if compute_dtype == "f32":
            _same_stats(got, want)
            _same_delta(gd, wd, wide_slack)
            continue
        _same_stats_bf16(got, want)
        _same_delta({k: v for k, v in gd.items() if v.dtype.kind in "iu"},
                    {k: v for k, v in wd.items() if v.dtype.kind in "iu"},
                    wide_slack)
        for k, w in wd.items():
            if w.dtype.kind == "f":
                np.testing.assert_allclose(gd[k], w, rtol=BF16_RTOL,
                                           atol=1e-2, err_msg=k)
    n_s = convert.acc_to_numpy(tacc)["n_seconds"]
    assert (n_s[0] == 120).all() and (n_s[4] == 30).all()
    assert n_s[2].sum() == 120 and n_s[2][77] == 120
    assert (n_s[5:] == 0).all()


def _fma32(a, b, c):
    return np.float32(float(Fraction(float(a)) * Fraction(float(b))
                            + Fraction(float(c))))


def test_scenario_demand_transform_is_one_multiply_add():
    """A one-chain engine with ``horizon_s = 1`` replies with that single
    second's transformed meter as ``meter_sum_w``, an exact JAX value: it
    equals ``fma(meter, demand_scale, demand_shift_w)`` in every case,
    and in some of them differs from the twice-rounded form.  The port's
    plain version and K10 compute the multiply-add."""
    gen = np.random.default_rng(0)
    B = 16
    with j_use_registry(JRegistry()):
        eng = JEngine(jcfg(n_chains=1), (B,))
        meter = np.float32(eng.run([req(
            jschema, "n", jschema.Scenario(horizon_s=1))])[0]
            ["stats"]["meter_sum_w"])
        ds = gen.uniform(0.1, 7.9, B).astype(np.float32)
        sh = gen.uniform(-3000.0, 3000.0, B).astype(np.float32)
        replies = eng.run([req(jschema, f"r{i}", jschema.Scenario(
            demand_scale=float(ds[i]), demand_shift_w=float(sh[i]),
            horizon_s=1)) for i in range(B)])
    tv = k3.scenario_transform_plain(
        torch.tensor([meter]), torch.zeros(1),
        {"demand_scale": torch.from_numpy(ds),
         "demand_shift_w": torch.from_numpy(sh),
         "pv_scale": torch.ones(B), "weather_bias": torch.ones(B),
         "curtail_w": torch.full((B,), 1e30)}, slice(None))[0]
    fma_only = 0
    for i, r in enumerate(replies):
        got = np.float32(r["stats"]["meter_sum_w"])
        fused = _fma32(meter, ds[i], sh[i])
        assert got == fused
        assert np.float32(tv[i]) == fused
        fma_only += int(fused != np.float32(
            np.float32(meter * ds[i]) + sh[i]))
    assert fma_only > 0


def test_selectors_fold_one_site_or_cohort():
    """``site_index`` folds exactly that chain and ``cohort`` exactly that
    cohort's chains, in both packages' engines (a 6-site fleet, 3
    cohorts)."""
    fp_t = TFleet.synthetic(6, seed=3)
    eng = tserver.ScenarioEngine(tcfg(fleet=fp_t), (1, 4), device="cpu")
    assert eng.n_sites == 6 and eng.n_cohorts == fp_t.n_cohorts >= 2
    cohort = np.asarray(fp_t.cohort)
    reqs = [req(tschema, f"s{i}", tschema.parse_scenario(
        d, max_horizon_s=120, n_sites=6, n_cohorts=eng.n_cohorts))
        for i, d in enumerate(({"site_index": 2}, {"cohort": 1}, {}))]
    got = eng.run(reqs)
    assert got[0]["stats"]["n_seconds"] == 120
    assert got[0]["site_index"] == 2 and got[1]["cohort"] == 1
    assert got[1]["stats"]["n_seconds"] == 120 * int((cohort == 1).sum())
    assert got[2]["stats"]["n_seconds"] == 120 * 6
    with j_use_registry(JRegistry()):
        jeng = JEngine(jcfg(fleet=JFleet.synthetic(6, seed=3)), (4,))
        want = jeng.run([req(jschema, r.id, jschema.Scenario(
            **dataclasses.asdict(r.scenario))) for r in reqs])
    for g, w in zip(got, want):
        assert g["stats"]["n_seconds"] == w["stats"]["n_seconds"]
        for k, v in w["stats"].items():
            assert g["stats"][k] == pytest.approx(v, rel=2e-5, abs=1e-2), k
