"""Scenario serving in the port (tmhpvsim_torch/serve/, K10) against the
JAX package's (tmhpvsim_tpu/serve/), on the CPU at tests/test_serve.py's
shape: 4 chains, 2 blocks of 60 s, the JAX scan at ``scan_unroll=1``.

Tolerances:
* schema: equal (the same validation of the same documents, rejections
  included; the encoded knob columns bit for bit);
* ``scenario_step`` on the same state (engine/convert.py) and
  ``ScenarioEngine.run`` replies: ``n_seconds`` exact, the statistics
  rtol 2e-5 / atol 1e-2 (the engine tolerance); the FleetAcc counts
  within the number of residual samples that differ between the two
  packages' traces (the suite runs JAX with x64, which evaluates part of
  its physics in float64, so a sample a few ULP off can cross a sketch
  bin edge; in x32 they are equal), ``count`` exact;
* inside the port, bit for bit: a row of a batch-of-N dispatch equals a
  batch-of-1 dispatch of the same scenario, padding rows are inert, the
  neutral scenario is ``run_reduced``, and continuous batching answers
  what batch-of-1 runs answer;
* the scenario demand transform: bit for bit against exact JAX values,
  which settles that the JAX scan contracts ``meter * demand_scale +
  demand_shift_w`` into one multiply-add.

The heaviest checks live beside this file, so that a run of the suite
that splits its workers by file takes them apart: the step at width, the
demand transform and the selectors in tests/test_torch_serve_width.py,
the server's round trips in tests/test_torch_serve_server.py.
"""

import asyncio
import dataclasses
import os
import re
import threading
import time

import jax
import numpy as np
import pytest
import torch

from tmhpvsim_torch import kernels
from tmhpvsim_torch.config import SimConfig as TConfig
from tmhpvsim_torch.engine import convert
from tmhpvsim_torch.engine.simulation import REDUCE_STATS
from tmhpvsim_torch.engine.simulation import Simulation as TSim
from tmhpvsim_torch.kernels import block_step as k3
from tmhpvsim_torch.kernels import build
from tmhpvsim_torch.obs.metrics import MetricsRegistry as TRegistry
from tmhpvsim_torch.obs.metrics import quantile_from_snapshot
from tmhpvsim_torch.runtime import broker as tbroker
from tmhpvsim_torch.runtime.resilience import CircuitBreaker
from tmhpvsim_torch.serve import schema as tschema
from tmhpvsim_torch.serve import server as tserver
from tmhpvsim_torch.serve.batcher import ContinuousBatcher, MicroBatcher
from tmhpvsim_tpu.config import SimConfig as JConfig
from tmhpvsim_tpu.engine import Simulation as JSim
from tmhpvsim_tpu.obs.metrics import MetricsRegistry as JRegistry
from tmhpvsim_tpu.obs.metrics import use_registry as j_use_registry
from tmhpvsim_tpu.serve import schema as jschema
from tmhpvsim_tpu.serve.server import ScenarioEngine as JEngine
from tmhpvsim_tpu.serve.server import default_buckets as j_default_buckets

BASE = dict(start="2019-09-05 10:00:00", duration_s=120, n_chains=4,
            seed=7, block_s=60, output="reduce")
#: the JAX side's scan at unroll 1 (tests/test_serve.py's ``scfg``)
JAX_ONLY = dict(dtype="float32", block_impl="scan", scan_unroll=1)
BUCKETS = (1, 4)
#: the scenarios every cross-package check runs: neutral, transformed,
#: short horizon, a binding curtailment cap (one batch-of-4 dispatch)
SCENARIOS = [
    (dict(horizon_s=120), "reduce"),
    (dict(demand_scale=1.5, demand_shift_w=250.0, horizon_s=120), "fleet"),
    (dict(weather_bias=0.5, dc_capacity_scale=2.0, curtail_w=40.0,
          horizon_s=60), "quantiles"),
    (dict(demand_scale=0.7, demand_shift_w=-300.0, horizon_s=90), "fleet"),
]


#: seconds a test's event loop may run before the test fails (a hang
#: fails its test, not the run)
LOOP_TIMEOUT_S = 120


def _run(coro):
    return asyncio.new_event_loop().run_until_complete(
        asyncio.wait_for(coro, LOOP_TIMEOUT_S))


def jcfg(**kw):
    return JConfig(**dict(BASE, **JAX_ONLY, **kw))


def tcfg(**kw):
    return TConfig(**dict(BASE, **kw))


def req(mod, rid, scenario, mode="reduce"):
    return mod.Request(id=rid, reply_to="r", mode=mode, scenario=scenario)


def scen_of(mod, doc, max_horizon_s=120):
    return mod.parse_scenario(doc, max_horizon_s=max_horizon_s)


@pytest.fixture(scope="module")
def jeng():
    with j_use_registry(JRegistry()):
        return JEngine(jcfg(), BUCKETS)


@pytest.fixture(scope="module")
def teng():
    return tserver.ScenarioEngine(tcfg(), (1, 4, 8), device="cpu")


@pytest.fixture(scope="module")
def slack():
    """How many residual samples (chain-seconds of the served run's
    trace) differ in their bits between the two packages."""
    want = list(JSim(jcfg(output="trace")).run_blocks())
    got = list(TSim(tcfg(output="trace"), device="cpu").run_blocks())
    return sum(int((np.asarray(w.residual) != g.residual).sum())
               for w, g in zip(want, got))


# --------------------------------------------------------------------------
# schema
# --------------------------------------------------------------------------

_SCENARIO_DOCS = [
    None, {}, {"horizon_s": 1}, {"horizon_s": 120},
    {"demand_scale": 2.0, "demand_shift_w": -5e4, "curtail_w": 0.0},
    {"dc_capacity_scale": 8, "weather_bias": 0.25, "curtail_w": 4000},
    {"site_index": 3}, {"cohort": 1}, {"site_index": -1, "cohort": -1},
    {"site_index": 1, "cohort": 0}, {"site_index": 4}, {"cohort": 3},
    {"demand_scale": 99.0}, {"demand_scale": -0.1}, {"weather_bias": 0.1},
    {"weather_bias": 5.0}, {"dc_capacity_scale": 8.5},
    {"demand_shift_w": 1e9}, {"curtail_w": -1.0},
    {"curtail_w": float("inf")}, {"demand_scale": True},
    {"demand_scale": float("nan")}, {"demand_scale": "1.0"},
    {"horizon_s": 60.0}, {"horizon_s": True}, {"horizon_s": 0},
    {"horizon_s": -5}, {"horizon_s": 121}, {"volcano": 2.0},
    {"site_index": 1.0}, "not-an-object", 7,
]


def _parse(mod, fn, *args, **kw):
    try:
        return "ok", fn(*args, **kw)
    except mod.RequestError as e:
        return e.code, str(e)


@pytest.mark.parametrize("doc", _SCENARIO_DOCS, ids=repr)
@pytest.mark.parametrize("n_sites, n_cohorts", [(None, 0), (4, 3)])
def test_parse_scenario_matches_jax(doc, n_sites, n_cohorts):
    kw = dict(max_horizon_s=120, n_sites=n_sites, n_cohorts=n_cohorts)
    jc, jv = _parse(jschema, jschema.parse_scenario, doc, **kw)
    tc, tv = _parse(tschema, tschema.parse_scenario, doc, **kw)
    assert tc == jc
    if jc == "ok":
        assert dataclasses.asdict(tv) == dataclasses.asdict(jv)
    else:
        assert tv == jv


_OK_META = jschema.request_meta("a", "reply.x", "fleet", {"horizon_s": 60})
_REQUEST_METAS = [
    _OK_META, {**_OK_META, "mode": "reduce", "tenant": "t1",
               "trace_id": "abc", "span_id": ""},
    {**_OK_META, "worker": "w0"}, {k: v for k, v in _OK_META.items()
                                   if k != "mode"},
    {**_OK_META, "id": ""}, {**_OK_META, "id": "x" * 65},
    {**_OK_META, "id": 7}, {**_OK_META, "reply_to": ""},
    {**_OK_META, "mode": "bogus"}, {**_OK_META, "surprise": 1},
    {**_OK_META, "tenant": ""}, {**_OK_META, "scenario": {"volcano": 1}},
    "not-a-dict",
]


@pytest.mark.parametrize("meta", _REQUEST_METAS, ids=repr)
def test_parse_request_matches_jax(meta):
    jc, jv = _parse(jschema, jschema.parse_request, meta, max_horizon_s=120)
    tc, tv = _parse(tschema, tschema.parse_request, meta, max_horizon_s=120)
    assert tc == jc
    if jc == "ok":
        d = dataclasses.asdict(tv)
        assert d == dataclasses.asdict(jv)
    else:
        assert tv == jv


def test_reply_metas_match_jax():
    for args, kw in ((("a", "fleet", {"x": 1}), {}),
                     (("a", "reduce", {}), dict(timings={"batch": 2},
                                                trace_id="t"))):
        assert tschema.ok_meta(*args, **kw) == jschema.ok_meta(*args, **kw)
    for args, kw in ((("a", "busy", "m"), dict(retry_after_ms=-3)),
                     ((None, "invalid", "m"), dict(trace_id="t"))):
        assert tschema.error_meta(*args, **kw) == \
            jschema.error_meta(*args, **kw)
    assert tschema.request_meta("a", "r", "fleet", {"horizon_s": 1}) == \
        jschema.request_meta("a", "r", "fleet", {"horizon_s": 1})


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 9])
def test_pick_bucket_matches_jax(n):
    buckets = (1, 4, 8)
    if n > max(buckets):
        for mod in (jschema, tschema):
            with pytest.raises(ValueError):
                mod.pick_bucket(n, buckets)
        return
    assert tschema.pick_bucket(n, buckets) == jschema.pick_bucket(n,
                                                                  buckets)


def test_encode_batch_matches_jax():
    docs = [d for d, _ in SCENARIOS] + [{"curtail_w": 1e3, "site_index": 2}]
    js = [jschema.parse_scenario(d, max_horizon_s=120, n_sites=4)
          for d in docs]
    ts = [tschema.parse_scenario(d, max_horizon_s=120, n_sites=4)
          for d in docs]
    want = jschema.encode_batch(js, 8, np.float32)
    got = tschema.encode_batch(ts, 8, device="cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.from_numpy(v).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    with pytest.raises(ValueError):
        tschema.encode_batch(ts, 2, device="cpu")
    # the device is a required keyword: the JAX call's positional dtype,
    # or no device at all, fails at once
    with pytest.raises(TypeError):
        tschema.encode_batch(ts, 8, np.float32)
    with pytest.raises(TypeError):
        tschema.encode_batch(ts, 8)


def test_default_buckets_and_serve_config_match_jax():
    for m in (1, 2, 6, 16, 17):
        assert tserver.default_buckets(m) == j_default_buckets(m)
    cfg = tserver.ServeConfig(sim=tcfg(), batch_sizes=(8, 1, 8))
    assert cfg.buckets() == (1, 8)
    with pytest.raises(ValueError):
        tserver.ServeConfig(sim=tcfg(), batch_sizes=(0, 2)).buckets()


# --------------------------------------------------------------------------
# scenario_step against the JAX package's on the same state
# --------------------------------------------------------------------------


def _same_stats(got, want):
    """The engine tolerance: n_seconds exact, the rest rtol 2e-5 / atol
    1e-2."""
    assert set(got) == set(want)
    for k, w in want.items():
        w, g = np.asarray(w), np.asarray(got[k])
        assert g.shape == w.shape, k
        if k == "n_seconds":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-5, atol=1e-2,
                                       err_msg=k)


def _same_delta(got, want, slack):
    """A FleetAcc delta (or run total): ``count`` exact, other counts
    within ``slack``, extrema rtol 2e-5 / atol 1e-2."""
    assert set(got) == set(want)
    for k, w in want.items():
        w, g = np.asarray(w), np.asarray(got[k])
        assert g.shape == w.shape, k
        if k == "count":
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif w.dtype.kind in "iu":
            assert np.abs(g.astype(np.int64) - w).max() <= slack, k
        else:
            np.testing.assert_allclose(g, w, rtol=2e-5, atol=1e-2,
                                       err_msg=k)


def test_scenario_step_matches_jax(slack):
    """One dispatch of each block on the JAX package's own state (carried
    across with engine/convert.py): a neutral, a transformed, a padding
    and a short-horizon row."""
    with j_use_registry(JRegistry()):
        js = JSim(jcfg(serve_batch_sizes=(4,)))
    ts = TSim(tcfg(), device="cpu")
    scs = [jschema.parse_scenario(d, max_horizon_s=120)
           for d in ({"horizon_s": 120},
                     {"demand_scale": 1.5, "demand_shift_w": 250.0,
                      "dc_capacity_scale": 2.0, "weather_bias": 0.5,
                      "curtail_w": 40.0, "horizon_s": 120},
                     {"horizon_s": 30})]
    scen = jschema.encode_batch(scs, 4, np.float32)   # row 3: padding
    jstate = js.init_state()
    jacc = js.init_scenario_acc(4)
    for bi in range(js.n_blocks):
        np_state = _jax_state_numpy(jstate)
        tstate = convert.state_from_numpy(np_state, "cpu",
                                          ts.plan.prng_impl)
        tacc = convert.acc_from_numpy(
            {k: np.asarray(v) for k, v in jacc.items()}, "cpu")
        jstate, jacc, jdelta = js.scenario_step(
            jstate, js.host_inputs(bi)[0], jacc, scen)
        tstate, tacc, tdelta = ts.scenario_step(
            tstate, ts.host_inputs(bi), tacc,
            convert.scen_from_numpy(scen, "cpu"))
        _same_stats(convert.acc_to_numpy(tacc),
                    {k: np.asarray(v) for k, v in jacc.items()})
        _same_delta(convert.fleet_delta_to_numpy(tdelta),
                    {k: np.asarray(v) for k, v in jdelta.items()}, slack)
        got = convert.state_to_numpy(tstate, ts.plan.prng_impl)
        want = _jax_state_numpy(jstate)
        for k in convert.KEY_LEAVES:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    n_s = np.asarray(jacc["n_seconds"])
    assert (n_s[0] == 120).all() and (n_s[2] == 30).all()
    assert (n_s[3] == 0).all()
    acc0 = convert.acc_to_numpy(ts.init_scenario_acc(1))
    for k in REDUCE_STATS:  # the padding row folded nothing
        np.testing.assert_array_equal(convert.acc_to_numpy(tacc)[k][3],
                                      acc0[k][0], err_msg=k)


def test_scenario_nan_knobs_match_jax(slack):
    """NaN knobs through the plain scenario fold as through the JAX
    engine's ``scenario_step``: a NaN demand scale (NaN meter), weather
    bias (NaN pv) and curtailment cap, each on a full horizon, and a NaN
    demand shift on a short horizon and with a site selector (a masked
    second still adds NaN * 0 to the sums, as the JAX fold's).  Every
    statistic is NaN where the JAX run's is, the rest within the engine
    tolerance; the FleetAcc, which folds finite residuals only, as
    ``_same_delta`` holds it."""
    with j_use_registry(JRegistry()):
        js = JSim(jcfg(serve_batch_sizes=(8,)))
    ts = TSim(tcfg(), device="cpu")
    docs = ({"horizon_s": 120}, {"horizon_s": 120}, {"horizon_s": 120},
            {"horizon_s": 120}, {"horizon_s": 90},
            {"site_index": 2, "horizon_s": 120}, {"horizon_s": 120})
    scen = jschema.encode_batch(
        [jschema.parse_scenario(d, max_horizon_s=120, n_sites=4)
         for d in docs], 8,
        np.float32)                                   # row 7: padding
    for knob, row in (("demand_scale", 1), ("weather_bias", 2),
                      ("curtail_w", 3), ("demand_shift_w", 4),
                      ("demand_shift_w", 5)):
        scen[knob] = np.array(scen[knob])
        scen[knob][row] = np.nan
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
        for k, w in want.items():
            np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(w),
                                          err_msg=k)
        _same_stats(got, want)
        _same_delta(convert.fleet_delta_to_numpy(tdelta),
                    {k: np.asarray(v) for k, v in jdelta.items()}, slack)
    got = convert.acc_to_numpy(tacc)
    nan_rows = {k: sorted(set(np.nonzero(np.isnan(got[k]))[0]))
                for k in REDUCE_STATS if k != "n_seconds"}
    assert nan_rows["meter_sum"] == [1, 4, 5]
    assert nan_rows["pv_sum"] == nan_rows["pv_max"] == [2, 3]
    assert nan_rows["residual_min"] == [1, 2, 3, 4, 5]
    # a row's masked chains: NaN sums, untouched extrema
    assert np.isnan(got["meter_sum"][5]).all()
    assert not np.isnan(got["residual_min"][5][[0, 1, 3]]).any()


def _jax_state_numpy(state):
    out = {k: np.asarray(jax.random.key_data(state[k]))
           for k in convert.KEY_LEAVES}
    for k in convert.FLOAT_LEAVES:
        out[k] = np.asarray(state[k])
    for tree in ("carry", "site", "fleet"):
        if tree in state:
            out[tree] = {k: np.asarray(v) for k, v in state[tree].items()}
    return out


def test_fleet_delta_round_trips_through_convert():
    ts = TSim(tcfg(), device="cpu")
    state = ts.init_state()
    scen = tschema.encode_batch([tschema.Scenario(horizon_s=60)], 2,
                                device="cpu")
    _, _, delta = ts.scenario_step(state, ts.host_inputs(0),
                                   ts.init_scenario_acc(2), scen)
    back = convert.fleet_delta_from_numpy(
        convert.fleet_delta_to_numpy(delta), "cpu")
    for k, v in delta.items():
        assert torch.equal(back[k], v), k
    with pytest.raises(ValueError):
        convert.scen_from_numpy({"horizon_s": np.zeros(1, np.int32)}, "cpu")


# --------------------------------------------------------------------------
# ScenarioEngine replies against the JAX package's
# --------------------------------------------------------------------------


def _same_reply(got, want, slack, width):
    """A reply against the JAX package's: the same keys, strings and
    Nones; ints within ``slack`` (``count`` and ``n_seconds`` exact);
    quantiles within ``slack`` bins of the sketch; other floats rtol 1e-4
    (2e-5 for the reduce statistics) / atol 1e-2."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            if isinstance(want[k], (int, float)) and \
                    not isinstance(want[k], bool) and \
                    re.fullmatch(r"p\d+", k):
                assert abs(got[k] - want[k]) <= width * max(slack, 1e-6)
                continue
            sub_slack = 0 if k in ("count", "n_seconds", "horizon_s") \
                else slack
            _same_reply(got[k], want[k], sub_slack, width)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_reply(g, w, slack, width)
    elif want is None or isinstance(want, (bool, str)):
        assert got == want
    elif isinstance(want, int):
        assert abs(got - want) <= slack
    else:
        assert got == pytest.approx(want, rel=2e-5, abs=1e-2)


def test_engine_replies_match_jax(jeng, teng, slack):
    """``ScenarioEngine.run`` in all three modes, one batch of 4."""
    jreqs = [req(jschema, f"r{i}", scen_of(jschema, d), m)
             for i, (d, m) in enumerate(SCENARIOS)]
    treqs = [req(tschema, f"r{i}", scen_of(tschema, d), m)
             for i, (d, m) in enumerate(SCENARIOS)]
    with j_use_registry(JRegistry()):
        want = jeng.run(jreqs)
    got = teng.run(treqs)
    width = teng.params.hi - teng.params.lo
    width /= teng.params.bins
    for g, w in zip(got, want):
        _same_reply(g, w, slack, width)
    assert got[0]["stats"]["n_seconds"] == 120 * 4
    assert got[1]["fleet"]["count"] == 120 * 4
    assert got[2]["count"] == 60 * 4
    # the cap binds: pv never above 40 W in that row
    assert got[3]["fleet"]["lolp"]["k_s"] == 60
    assert {r["mode"] for r in got} == {"reduce", "fleet", "quantiles"}




# --------------------------------------------------------------------------
# inside the port: bit identity
# --------------------------------------------------------------------------


def test_batch_rows_match_singleton_runs(teng):
    reqs = [req(tschema, f"r{i}", scen_of(tschema, d), m)
            for i, (d, m) in enumerate(SCENARIOS[:3])]
    batch = teng.run(reqs)                      # padded to bucket 4
    singles = [teng.run([r])[0] for r in reqs]  # bucket 1 each
    assert batch == singles
    company = teng.run([
        req(tschema, "n1", scen_of(tschema, {"weather_bias": 4.0,
                                             "horizon_s": 60})),
        reqs[1],
        req(tschema, "n2", scen_of(tschema, {"demand_shift_w": -5e4})),
        reqs[0], reqs[2]])                      # bucket 8
    assert company[1] == singles[1] and company[3] == singles[0]
    assert company[4] == singles[2]


def test_padding_rows_are_inert(teng):
    """Padding rows (``horizon_s = 0``) keep the fresh accumulator and
    contribute the merge's identity, and the rows beside them are the
    rows without them."""
    sim = teng.sim
    scs = [scen_of(tschema, d) for d, _ in SCENARIOS[:2]]
    state = teng.block_state(0)
    outs = []
    for bucket in (2, 8):
        acc = sim.init_scenario_acc(bucket)
        _, acc, delta = sim.scenario_step(
            tserver._fresh(state), teng._inputs[0], acc,
            tschema.encode_batch(scs, bucket, device="cpu"))
        outs.append((acc, delta))
    (a2, d2), (a8, d8) = outs
    fresh = sim.init_scenario_acc(6)
    neutral = teng.init_total(6)
    for k in a2:
        assert torch.equal(a8[k][:2], a2[k]), k
        assert torch.equal(a8[k][2:], fresh[k]), k
    for k in d2:
        assert torch.equal(d8[k][:2], d2[k]), k
        pad = d8[k][2:]
        want = neutral[k].to(pad.dtype)
        assert torch.equal(pad, want), k


def test_neutral_scenario_matches_run_reduced(teng):
    stats = teng.run([req(tschema, "n", scen_of(tschema, {}))])[0]["stats"]
    red = TSim(tcfg(), device="cpu").run_reduced()
    assert stats["n_seconds"] == int(red["n_seconds"].sum())
    for name, key in (("pv_sum", "pv_sum_w"), ("meter_sum", "meter_sum_w"),
                      ("residual_sum", "residual_sum_w")):
        assert stats[key] == float(red[name].astype(np.float64).sum())
    assert stats["pv_max_w"] == float(red["pv_max"].max())
    assert stats["residual_min_w"] == float(red["residual_min"].min())
    assert stats["residual_max_w"] == float(red["residual_max"].max())


def test_rolling_session_matches_run(teng):
    """The slot protocol by hand: rows admitted at different cursors,
    scheduled apart, retire with the batch-of-1 answers."""
    s = teng.open_rolling(4)
    a = req(tschema, "a", scen_of(tschema, {"demand_scale": 2.0}))
    b = req(tschema, "b", scen_of(tschema, {"horizon_s": 60}), "fleet")
    s.admit_rows([(0, a)])
    assert s.step_finish(0, [0], []) == {}
    s.admit_rows([(1, b)])
    out_b = s.step_finish(0, [1], [1])
    out_a = s.step_finish(1, [0], [0])
    assert out_a[0] == teng.run([a])[0] and out_b[1] == teng.run([b])[0]
    # a slot re-admitted after release starts from a fresh row
    s.admit_rows([(0, b)])
    assert s.step_finish(0, [0], [0])[0] == out_b[1]
    s.recover()
    assert all(r is None for r in s._reqs)


# --------------------------------------------------------------------------
# batchers (stub dispatch: no device work)
# --------------------------------------------------------------------------


class TestMicroBatcher:
    def test_coalesces_and_demuxes(self):
        async def main():
            reg = TRegistry()
            calls = []

            def dispatch(reqs):
                calls.append(len(reqs))
                time.sleep(0.005)
                return [f"r:{r}" for r in reqs]

            b = MicroBatcher(dispatch, window_s=0.05, max_batch=8,
                             registry=reg)
            b.start()
            out = await asyncio.gather(*[b.submit(f"q{i}")
                                         for i in range(5)])
            assert [r for r, _ in out] == [f"r:q{i}" for i in range(5)]
            assert {i["batch"] for _, i in out} == {5}
            assert all(i["queue_s"] >= 0.0 and i["dispatch_s"] > 0.0
                       for _, i in out)
            assert calls == [5]
            await b.stop(drain=True)
            snap = reg.snapshot()
            assert snap["counters"]["serve.batches_total"] == 1.0
            assert snap["histograms"]["serve.batch_occupancy"]["max"] == 5.0
        _run(main())

    def test_max_batch_splits(self):
        async def main():
            b = MicroBatcher(lambda rs: list(rs), window_s=0.02,
                             max_batch=2, registry=TRegistry())
            b.start()
            out = await asyncio.gather(*[b.submit(i) for i in range(5)])
            assert [r for r, _ in out] == list(range(5))
            assert all(i["batch"] <= 2 for _, i in out)
            await b.stop(drain=True)
        _run(main())

    def test_queue_limit_and_drain_rejections(self):
        async def main():
            b = MicroBatcher(lambda rs: list(rs), window_s=0.01,
                             max_batch=2, queue_limit=2,
                             registry=TRegistry())
            f1, f2 = b.submit("a"), b.submit("b")   # worker not started
            with pytest.raises(tschema.RequestError) as ei:
                b.submit("c")
            assert ei.value.code == "busy" and ei.value.retry_after_ms >= 1
            await b.stop(drain=False)
            for f in (f1, f2):
                with pytest.raises(tschema.RequestError) as e2:
                    await f
                assert e2.value.code == "draining"
            with pytest.raises(tschema.RequestError) as e3:
                b.submit("d")
            assert e3.value.code == "draining"
        _run(main())

    def test_drain_runs_queued_batches(self):
        async def main():
            b = MicroBatcher(lambda rs: [r * 2 for r in rs], window_s=0.01,
                             max_batch=2, registry=TRegistry())
            futs = [b.submit(i) for i in range(3)]
            b.start()
            await b.stop(drain=True)
            assert [f.result()[0] for f in futs] == [0, 2, 4]
        _run(main())

    def test_dispatch_error_is_typed_internal(self):
        async def main():
            def boom(reqs):
                raise RuntimeError("no device")

            breaker = CircuitBreaker("t", failure_threshold=1,
                                     registry=TRegistry())
            b = MicroBatcher(boom, window_s=0.01, max_batch=2,
                             registry=TRegistry(), breaker=breaker)
            b.start()
            with pytest.raises(tschema.RequestError) as ei:
                await b.submit("x")
            assert ei.value.code == "internal"
            # one failure opens this breaker: the next submit is shed
            with pytest.raises(tschema.RequestError) as e2:
                b.submit("y")
            assert e2.value.code == "unavailable"
            await b.stop(drain=True)
        _run(main())


def test_breaker_opens_sheds_and_reopens_on_a_failed_probe(monkeypatch):
    """Consecutive failures open the breaker; after ``reset_s`` it is
    half-open, and a failure then re-opens it at once while a success
    closes it."""
    from tmhpvsim_torch.runtime import resilience

    now = [100.0]
    monkeypatch.setattr(resilience.time, "monotonic", lambda: now[0])
    reg = TRegistry()
    br = CircuitBreaker("t", failure_threshold=2, reset_s=5.0, registry=reg)
    br.record_failure()
    assert br.state == "closed"
    br.record_failure()
    assert br.state == "open" and br.reset_remaining_s() == 5.0
    now[0] += 5.0
    assert br.state == "half_open"
    br.record_failure()
    assert br.state == "open"
    now[0] += 5.0
    assert br.state == "half_open"
    br.record_success()
    assert br.state == "closed"
    snap = reg.snapshot()
    assert snap["counters"]["resilience.breaker_open_total.t"] == 2.0
    assert snap["gauges"]["resilience.breaker_state.t"] == 0.0


def test_breaker_repairs_the_jax_half_open_failure(monkeypatch):
    """The same failures through the JAX package's breaker: its batchers
    never call ``allow()``, so no probe is marked and a failure while
    half-open leaves it half-open (work keeps flowing to a failing
    dispatch).  The port's copy re-opens it instead (a repair)."""
    from tmhpvsim_torch.runtime import resilience
    from tmhpvsim_tpu.runtime.resilience import CircuitBreaker as JBreaker

    now = [100.0]
    monkeypatch.setattr(resilience.time, "monotonic", lambda: now[0])
    jb = JBreaker("t", failure_threshold=2, reset_s=5.0,
                  registry=JRegistry(), now=lambda: now[0])
    tb = CircuitBreaker("t", failure_threshold=2, reset_s=5.0,
                        registry=TRegistry())
    for br in (jb, tb):
        br.record_failure()
        br.record_failure()
    assert jb.state == tb.state == "open"
    now[0] += 5.0
    assert jb.state == tb.state == "half_open"
    for br in (jb, tb):
        br.record_failure()
    assert jb.state == "half_open"
    assert tb.state == "open"
    now[0] += 60.0
    jb.record_failure()
    assert jb.state == "half_open"


class _FakeSession:
    """Duck-typed RollingSession: each ``step_finish`` signals entry and
    blocks until released; ``recover`` takes ``recover_s`` (a slow card)."""

    def __init__(self, bucket, blocks, recover_s=0.0):
        self.bucket = bucket
        self._blocks = dict(blocks)
        self.rows = {}
        self.calls = []
        self.step_entered = threading.Semaphore(0)
        self.step_go = threading.Semaphore(0)
        self.fail_next = False
        self.recovered = 0
        self.recover_s = recover_s

    def blocks_for(self, request):
        return self._blocks[request.id]

    def admit_rows(self, admits):
        for slot, request in admits:
            self.rows[slot] = request.id

    def step_finish(self, bi, sched, retiring):
        self.step_entered.release()
        assert self.step_go.acquire(timeout=10.0)
        if self.fail_next:
            self.fail_next = False
            raise RuntimeError("dispatch failed on the card")
        self.calls.append((bi, tuple(sched), tuple(retiring)))
        return {sl: {"rid": self.rows.pop(sl)} for sl in retiring}

    def recover(self):
        time.sleep(self.recover_s)
        self.recovered += 1
        self.rows.clear()


async def _entered(sess, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not sess.step_entered.acquire(blocking=False):
        assert time.monotonic() < deadline, "dispatch never started"
        await asyncio.sleep(0.005)


def _r(rid):
    return req(tschema, rid, tschema.Scenario())


class TestContinuousScheduler:
    def test_backfill_joins_next_dispatch_and_retires_early(self):
        async def main():
            reg = TRegistry()
            sess = _FakeSession(4, {"a": 3, "b": 3, "c": 1})
            b = ContinuousBatcher(sess, window_s=0.02, registry=reg)
            b.start()
            fa, fb = b.submit(_r("a")), b.submit(_r("b"))
            await _entered(sess)                 # block 0 of {a, b}
            fc = b.submit(_r("c"))               # arrives mid-dispatch
            sess.step_go.release()
            for _ in range(3):
                await _entered(sess)
                sess.step_go.release()
            (ra, ia), (rb, ib), (rc, ic) = await asyncio.gather(fa, fb, fc)
            await b.stop(drain=True)
            assert sess.calls == [(0, (0, 1), ()), (1, (0, 1), ()),
                                  (2, (0, 1), (0, 1)), (0, (2,), (2,))]
            assert (ra["rid"], rb["rid"], rc["rid"]) == ("a", "b", "c")
            assert ia["blocks"] == 3 and ic["blocks"] == 1
            assert ia["batch"] == 2 and ic["batch"] == 1
            c = reg.snapshot()["counters"]
            assert c["serve.backfilled_total"] == 1.0
            assert c["serve.batches_total"] == 4.0
            assert reg.snapshot()["gauges"]["serve.resident_rows"] == 0.0
        _run(main())

    def test_starve_limit_forces_the_oldest_cursor(self):
        async def main():
            blocks = {"L": 2, **{f"s{i}": 1 for i in range(6)}}
            sess = _FakeSession(8, blocks)
            b = ContinuousBatcher(sess, window_s=0.02, registry=TRegistry(),
                                  starve_limit=2)
            b.start()
            futs = [b.submit(_r("L"))]
            for wave in range(3):
                await _entered(sess)
                futs += [b.submit(_r(f"s{2 * wave + k}")) for k in range(2)]
                sess.step_go.release()
            for _ in range(2):
                await _entered(sess)
                sess.step_go.release()
            await asyncio.gather(*futs)
            await b.stop(drain=True)
            assert sess.calls == [(0, (0,), ()), (0, (1, 2), (1, 2)),
                                  (0, (1, 2), (1, 2)), (1, (0,), (0,)),
                                  (0, (1, 2), (1, 2))]
        _run(main())

    @pytest.mark.parametrize("recover_s", [0.0, 0.2],
                             ids=["prompt-recovery", "late-recovery"])
    def test_dispatch_failure_fails_residents_and_recovers(self, recover_s):
        """The JAX package's docstring contract: a failed dispatch fails
        every resident row typed ``internal`` and the session recovers;
        later requests are served.  A row's error arrives only after the
        recovery, even when recovering takes a while (the JAX copy
        resolves the errors first and races, tests/test_serve.py)."""
        async def main():
            sess = _FakeSession(4, {"a": 2, "b": 1, "d": 1},
                                recover_s=recover_s)
            b = ContinuousBatcher(sess, window_s=0.02, registry=TRegistry())
            b.start()
            fa, fb = b.submit(_r("a")), b.submit(_r("b"))
            await _entered(sess)
            sess.fail_next = True
            sess.step_go.release()
            for f in (fa, fb):
                with pytest.raises(tschema.RequestError) as ei:
                    await f
                assert ei.value.code == "internal"
            assert sess.recovered == 1
            fd = b.submit(_r("d"))
            await _entered(sess)
            sess.step_go.release()
            rd, _ = await fd
            assert rd["rid"] == "d"
            await b.stop(drain=True)
        _run(main())


# --------------------------------------------------------------------------
# transport, metrics, server end to end
# --------------------------------------------------------------------------


def test_make_transport_serves_local_and_names_the_rest():
    """Serving runs over local:// and refuses the other schemes by name;
    the streaming apps' transports of those schemes exist."""
    from tmhpvsim_torch.runtime.tcpbroker import TcpTransport

    for make in (tbroker.make_transport, tserver.make_transport):
        assert isinstance(make(None, "x"), tbroker.LocalTransport)
    for url in ("tcp://127.0.0.1:5701/", "amqp://guest@host/"):
        with pytest.raises(NotImplementedError, match="not ported"):
            tserver.make_transport(url, "x")
    assert isinstance(tbroker.make_transport("tcp://127.0.0.1:5701/", "x"),
                      TcpTransport)


def test_local_transport_fans_out_with_meta():
    async def main():
        url = "local://fanout-test"
        async with tbroker.make_transport(url, "ex") as pub:
            subs = [tbroker.make_transport(url, "ex") for _ in range(2)]
            its = [s.subscribe(with_meta=True) for s in subs]
            firsts = [asyncio.ensure_future(it.__anext__()) for it in its]
            await asyncio.sleep(0.01)
            await pub.publish(1.5, None, meta={"op": "x"})
            got = await asyncio.gather(*firsts)
            assert [(v, m) for _, v, m in got] == [(1.5, {"op": "x"})] * 2
            for it in its:
                await it.aclose()
    _run(main())


def test_quantile_from_snapshot_matches_jax():
    from tmhpvsim_tpu.obs.metrics import Histogram as JHist
    from tmhpvsim_tpu.obs.metrics import \
        quantile_from_snapshot as j_quantile

    reg = TRegistry()
    th = reg.histogram("h")
    jh = JHist("h")
    for v in (0.003, 0.004, 0.02, 0.7, 0.7, 3.0, 400.0):
        th.observe(v)
        jh.observe(v)
    assert th.snapshot() == jh.snapshot()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert quantile_from_snapshot(th.snapshot(), q) == \
            j_quantile(jh.snapshot(), q)
    assert quantile_from_snapshot(None, 0.5) is None


def test_serve_cli_needs_the_card_or_cpu(monkeypatch):
    from tmhpvsim_torch.cli import main as cli

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="CUDA"):
        cli(["serve", "--chains", "2", "--duration", "120"])
    with pytest.raises(SystemExit, match="not ported"):
        cli(["serve", "--device", "cpu", "--chains", "2", "--duration",
             "120", "--block-s", "60", "--amqp-url", "tcp://127.0.0.1:9/"])


# --------------------------------------------------------------------------
# the K10 wrapper on the CPU
# --------------------------------------------------------------------------


def test_scenario_wrapper_runs_plain_on_cpu():
    """On CPU tensors ``block_step_scenario`` is ``scenario_plain`` (no
    launch counted); the neutral row's statistics are the acc fold's."""
    kernels.reset_counts()
    sim = TSim(tcfg(), device="cpu")
    state, ins = sim.init_state(), sim.host_inputs(0)
    tables, _ = sim._windows(state, ins)
    head = (tables, ins.rows_i, ins.rows_f, state["k_scan"],
            state["k_meter"], state["carry"])
    tail = (sim.config.duration_s, sim.config.meter_max_w,
            sim.config.site.surface_tilt, sim.config.site.albedo)
    scen = tschema.encode_batch(
        [tschema.Scenario(horizon_s=120),
         tschema.Scenario(demand_scale=2.0, horizon_s=120)], 2,
        device="cpu")
    kw = dict(scen=scen, params=sim.scenario_fleet_params(),
              per_chain=True)
    _, aw, dw = k3.block_step_scenario(*head, sim.init_scenario_acc(2),
                                       *tail, **kw)
    _, ap, dp = k3.scenario_plain(*head, sim.init_scenario_acc(2), *tail,
                                  **kw)
    _, acc = k3.block_step_acc(*head, sim.init_reduce_acc(), *tail)
    for k in ap:
        assert torch.equal(aw[k], ap[k]) and torch.equal(aw[k][0], acc[k])
    assert int(dw["count"][0]) == 60 * 4
    assert all(c.launches == 0 for c in kernels.COUNTERS)
    assert set(dw["chain"]) >= {"min_res", "lol_run", "seen_ramp_60s"}
    with pytest.raises(ValueError, match="scen"):
        k3.block_step_scenario(*head, sim.init_scenario_acc(2), *tail,
                               scen=dict(scen, horizon_s=scen[
                                   "horizon_s"].long()),
                               params=sim.scenario_fleet_params())


def test_scen_layout_mirrors_the_kernel():
    """The wrapper's ctypes ``Scen`` has the kernel struct's fields in
    order, and the leaf tables the kernel's lengths."""
    text = open(os.path.join(build.CSRC, "block_step.cuh")).read()
    body = re.search(r"struct Scen \{(.*?)\n\};", text, re.S).group(1)
    names = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        line = re.sub(r"^const\s+", "", line)
        if not line:
            continue
        decl = line.split(None, 1)[1]
        names += [re.sub(r"[\*\s]|\[\d+\]", "", d) for d in decl.split(",")]
    assert names == [f for f, _ in k3._Scen._fields_]
    for name, table in (("SCN_CHAIN_I", k3.SCN_CHAIN_I),
                        ("SCN_CHAIN_F", k3.SCN_CHAIN_F),
                        ("SCN_LEAVES", k3.SCN_KINDS)):
        assert len(table) == int(re.search(rf"#define {name} (\d+)",
                                           text).group(1)), name
    for entry in ("block_step_scenario", "scen_struct_size"):
        assert re.search(rf'extern "C" int {entry}\(', text), entry


# --------------------------------------------------------------------------
# bf16 and rbg serving (K12 in K10; K13 in K10)
# --------------------------------------------------------------------------


def _bf16_or_rbg(kind):
    return (dict(compute_dtype="bf16") if kind == "bf16"
            else dict(prng_impl="rbg"))


@pytest.mark.filterwarnings("ignore:prng_impl='rbg'")
@pytest.mark.parametrize("kind", ["bf16", "rbg"])
def test_lever_engine_replies_match_jax(kind, slack):
    """``ScenarioEngine.run`` under bf16 (the JAX ScenarioEngine runs its
    step in the compute dtype) and under rbg keys, against the JAX engine
    with ``block_impl='scan'`` pinned: one batch of 4 in all three
    modes."""
    kw = _bf16_or_rbg(kind)
    with j_use_registry(JRegistry()):
        jeng = JEngine(jcfg(**kw), BUCKETS)
    teng = tserver.ScenarioEngine(tcfg(**kw), BUCKETS, device="cpu")
    assert teng.sim.plan.compute_dtype == ("bf16" if kind == "bf16"
                                           else "f32")
    jreqs = [req(jschema, f"r{i}", scen_of(jschema, d), m)
             for i, (d, m) in enumerate(SCENARIOS)]
    treqs = [req(tschema, f"r{i}", scen_of(tschema, d), m)
             for i, (d, m) in enumerate(SCENARIOS)]
    with j_use_registry(JRegistry()):
        want = jeng.run(jreqs)
    got = teng.run(treqs)
    width = (teng.params.hi - teng.params.lo) / teng.params.bins
    for g, w in zip(got, want):
        _same_reply(g, w, slack, width)
    assert got[0]["stats"]["n_seconds"] == 120 * 4


def test_bf16_scenario_step_is_the_bf16_step():
    """The bf16 scenario fold's neutral row folds the bf16 acc step's
    statistics bit for bit (plain versions on the CPU)."""
    sim = TSim(tcfg(compute_dtype="bf16"), device="cpu")
    scs = [tschema.parse_scenario({"horizon_s": 120}, max_horizon_s=120)]
    scen = tschema.encode_batch(scs, 1, device="cpu")
    state, acc = sim.init_state(), sim.init_scenario_acc(1)
    for bi in range(sim.n_blocks):
        state, acc, _ = sim.scenario_step(state, sim.host_inputs(bi), acc,
                                          scen)
    ref = TSim(tcfg(compute_dtype="bf16"), device="cpu").run_reduced()
    for k in REDUCE_STATS:
        np.testing.assert_array_equal(acc[k][0].numpy(), ref[k], err_msg=k)
