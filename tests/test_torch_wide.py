"""The port's wide formulation (the K4 merges) and the plan knobs the JAX
package treats as the same run, against the JAX package on the CPU.

Tolerances:

* the port's wide runs against the JAX package's wide runs: the engine
  tolerance, ``n_seconds`` exact and the rest rtol 2e-5 / atol 1e-2
  (tests/test_engine.py:139-150).  The port's wide producer is the K4
  trace launch, which follows the scan's multiply-adds; the JAX wide
  producer differs from it by an ULP in some seconds;
* the fleet run's summary: counts within the number of residual samples
  whose bits differ between the two traces (a sample a few ULP off can
  cross a sketch bin edge), ``count`` exact, other floats rel 1e-4;
* the plain wide folds against the JAX folds on the same numpy arrays:
  integer leaves and extrema bit for bit, float sums rtol 1e-5 (the port
  sums each chain's seconds in float32 in order, then the chains in
  float64; the JAX fold sums the block in XLA's order);
* the knobs on the port's CPU path against its default run: bit for bit.
"""

import json
import os

import numpy as np
import pytest
import torch

from tmhpvsim_torch import config as tcfg
from tmhpvsim_torch.engine.simulation import Simulation as TSim
from tmhpvsim_torch.fleet import FleetParams as TFleet
from tmhpvsim_torch.kernels import block_step as k3
from tmhpvsim_torch.kernels import wide
from tmhpvsim_torch.obs import analytics as tflt
from tmhpvsim_torch.obs import telemetry as ttel
from tmhpvsim_tpu import config as jcfg
from tmhpvsim_tpu.engine import Simulation as JSim
from tmhpvsim_tpu.fleet import FleetParams as JFleet
from tmhpvsim_tpu.obs import analytics as jflt
from tmhpvsim_tpu.obs import telemetry as jtel
from test_torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(start="2019-09-05 10:00:00", duration_s=7200, n_chains=3,
             seed=7, block_s=3600)
#: the 2 x 2 grid of tests/test_engine.py:153-166 (5400 s in 3600 s
#: blocks: the second block ends mid-way)
GRID = dict(start="2019-09-05 10:00:00", duration_s=5400, n_chains=4,
            seed=7, block_s=3600)
GRID_REGULAR = ((46, 50), (9, 13), 2, 2)
#: the fleet run of tests/test_torch_engine.py (a lower capacity and a 5 s
#: run length, so that loss-of-load runs occur)
FLEET_SYNTH = (12, 3)
FLEET_KW = dict(telemetry="full", analytics="full",
                analytics_capacity_w=6000.0, analytics_lolp_k=5)
TOL = dict(rtol=2e-5, atol=1e-2)


def _jax(impl="wide", **kw):
    return JSim(jcfg.SimConfig(block_impl=impl, dtype="float32", **kw))


def _port(**kw):
    return TSim(tcfg.SimConfig(**kw), device="cpu")


def _assert_engine_close(want, got):
    np.testing.assert_array_equal(got["n_seconds"], want["n_seconds"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def _grid(mod):
    return mod.SiteGrid.regular(*GRID_REGULAR)


@pytest.fixture(scope="module")
def jax_wide():
    return _jax(**SMALL).run_reduced()


@pytest.fixture(scope="module")
def jax_wide_grid():
    return _jax(**dict(GRID, site_grid=_grid(jcfg))).run_reduced()


@pytest.mark.parametrize("fusion", ["split", "fused"])
def test_wide_reduce_matches_jax(jax_wide, fusion):
    sim = _port(block_impl="wide", stats_fusion=fusion, **SMALL)
    assert (sim.plan.block_impl, sim.plan.stats_fusion) == ("wide", fusion)
    _assert_engine_close(jax_wide, sim.run_reduced())


@pytest.mark.parametrize("fusion", ["split", "fused"])
def test_wide_grid_reduce_matches_jax(jax_wide_grid, fusion):
    got = _port(block_impl="wide", stats_fusion=fusion,
                **dict(GRID, site_grid=_grid(tcfg))).run_reduced()
    _assert_engine_close(jax_wide_grid, got)
    assert (got["n_seconds"] == GRID["duration_s"]).all()


def test_wide_ensemble_matches_jax():
    want = list(_jax(**dict(SMALL, output="ensemble")).run_ensemble())
    got = list(_port(block_impl="wide",
                     **dict(SMALL, output="ensemble")).run_ensemble())
    assert len(got) == len(want)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.epoch, np.asarray(w.epoch))
        for k in ("meter", "pv", "residual"):
            np.testing.assert_allclose(getattr(g, k),
                                       np.asarray(getattr(w, k)),
                                       err_msg=k, **TOL)


def test_wide_split_fold_is_k3_and_series_is_the_scan_sum():
    """On the same block the wide fold of the trace equals the acc
    epilogue's statistics bit for bit (one fold order), and the wide
    series the series epilogue's sums."""
    sim = _port(**SMALL)
    state = sim.init_state()
    ins = sim.host_inputs(0)
    tables, _ = sim._windows(state, ins)
    head = (tables, ins.rows_i, ins.rows_f, state["k_scan"],
            state["k_meter"], state["carry"])
    tail = (sim.config.meter_max_w, sim.config.site.surface_tilt,
            sim.config.site.albedo)
    _, meter, pv = k3.trace_plain(*head, *tail)
    acc, _ = wide.wide_fold(meter, pv, ins.rows_i[0], SMALL["duration_s"],
                            sim.init_reduce_acc())
    _, want = k3.block_step_plain(*head, sim.init_reduce_acc(),
                                  SMALL["duration_s"], *tail)
    for k in want:
        assert torch.equal(acc[k], want[k]), k
    _, m, p = k3.series_plain(*head, *tail)
    ms, ps = wide.wide_series(meter, pv)
    assert torch.equal(ms, m) and torch.equal(ps, p)


# --------------------------------------------------------------------------
# the fleet in the wide formulation, both observers at level full
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fleet_pair():
    js = _jax(fleet=JFleet.synthetic(FLEET_SYNTH[0], seed=FLEET_SYNTH[1]),
              **dict(SMALL, **FLEET_KW))
    ts = _port(block_impl="wide", fleet=TFleet.synthetic(
        FLEET_SYNTH[0], seed=FLEET_SYNTH[1]), **dict(SMALL, **FLEET_KW))
    want, got = js.run_reduced(), ts.run_reduced()
    # the residual samples whose bits differ between the two producers
    jt = list(_jax(fleet=JFleet.synthetic(FLEET_SYNTH[0],
                                                  seed=FLEET_SYNTH[1]),
                   **SMALL).run_blocks())
    tt = list(_port(fleet=TFleet.synthetic(FLEET_SYNTH[0],
                                           seed=FLEET_SYNTH[1]),
                    **SMALL).run_blocks())
    n_diff = sum(int((np.asarray(w.residual) != g.residual).sum())
                 for w, g in zip(jt, tt))
    return js, ts, want, got, n_diff


def _assert_summary(got, want, path="", slack=0):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_summary(got[k], want[k], f"{path}.{k}",
                            0 if k == "count" else slack)
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_summary(g, w, f"{path}[{i}]", slack)
    elif want is None or isinstance(want, (bool, str)):
        assert got == want, path
    elif isinstance(want, int):
        assert abs(got - want) <= slack, path
    else:
        assert got == pytest.approx(want, rel=1e-4, abs=1e-6), path


def test_wide_fleet_matches_jax(fleet_pair):
    js, ts, want, got, n_diff = fleet_pair
    _assert_engine_close(want, got)
    summary = ts.fleet_summary()
    _assert_summary(summary, js.fleet_summary(), slack=n_diff)
    # the wide fold observes no cloud state: regimes unobserved
    assert summary["regimes"] is None and summary["lolp"]["events"] > 0
    assert len(summary["cohorts"]) == 3
    jt = {k: np.asarray(v) for k, v in js._tel_last.items()}
    tt = ts._tel_last
    assert set(tt) == set(jt)
    for k, w in jt.items():
        g = tt[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k.startswith(("min_", "max_", "sum_", "sumsq_")):
            np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=k)
        else:
            assert np.array_equal(g, w), k
    assert not ts.tel_summary["fields"]["csi"]["observed"]
    _assert_summary(ts.tel_summary, jtel.summarize(jt))


# --------------------------------------------------------------------------
# the plain wide folds against the JAX folds on the same arrays
# --------------------------------------------------------------------------


def _fold_inputs():
    """Seeded (n, T) meter / pv with NaN and Inf injected, loss-of-load
    runs of 6-9 s over a 5000 W capacity, 3 cohorts and a duration ending
    in the block's middle."""
    rs = np.random.default_rng(2024)
    n, T, t0 = 24, 240, 3600
    meter = rs.uniform(0, 9000, (n, T)).astype(np.float32)
    pv = rs.uniform(0, 4000, (n, T)).astype(np.float32)
    for c in range(0, n, 3):
        s = int(rs.integers(0, T - 12))
        meter[c, s:s + 6 + c % 4] = 8900.0
        pv[c, s:s + 6 + c % 4] = 10.0
    meter[1, 7] = np.nan
    pv[2, 11] = np.inf
    meter[4, 100] = -np.inf
    pv[5, 200] = np.nan  # past the duration: masked
    t = np.arange(t0, t0 + T, dtype=np.int32)
    return meter, pv, t, t0 + 170, (np.arange(n) % 3).astype(np.int32)


def _params(mod):
    return mod.FleetParams(lo=-9000.0, hi=9000.0, bins=64,
                           thresholds=(1000.0, 3000.0, 6000.0),
                           capacity_w=5000.0, lolp_k=5,
                           ramp_windows=(1, 60, 3600))


def _assert_leaves(got, want, sums=()):
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k in sums:
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_plain_wide_stats_match_jax():
    meter, pv, t, dur, _ = _fold_inputs()
    n = meter.shape[0]
    js = _jax(**dict(SMALL, duration_s=int(dur), n_chains=n))
    acc0 = js.init_reduce_acc()
    want = js._merge_acc(acc0, js._block_stats(meter, pv, t))
    tacc = {k: torch.from_numpy(np.array(v)) for k, v in acc0.items()}
    got, _ = wide.wide_fold_plain(torch.from_numpy(meter.T.copy()),
                                  torch.from_numpy(pv.T.copy()),
                                  torch.from_numpy(t), int(dur), tacc)
    _assert_leaves(got, want, sums=("pv_sum", "meter_sum", "residual_sum"))


@pytest.mark.parametrize("level", ["light", "full"])
def test_plain_wide_telemetry_matches_jax(level):
    meter, pv, t, dur, _ = _fold_inputs()
    want = jtel.fold_wide(jtel.init_acc(level), level, meter=meter, pv=pv,
                          t=t, duration_s=dur)
    got = ttel.fold_wide(ttel.init_acc(level), level,
                         meter=torch.from_numpy(meter.T.copy()),
                         pv=torch.from_numpy(pv.T.copy()),
                         t=torch.from_numpy(t), duration_s=dur)
    _assert_leaves(got, want, sums=tuple(
        f"{p}_{f}" for p in ("sum", "sumsq")
        for f in ("meter", "pv", "residual")))
    assert int(got["nan_meter"]) == 1 and int(got["inf_pv"]) == 1


@pytest.mark.parametrize("level,cohorts", [("risk", 0), ("full", 3)])
def test_plain_wide_analytics_matches_jax(level, cohorts):
    meter, pv, t, dur, cohort = _fold_inputs()
    kw = dict(meter=meter, pv=pv, t=t, duration_s=dur)
    want = jflt.fold_wide(
        jflt.init_acc(level, params=_params(jflt), cohorts=cohorts), level,
        _params(jflt), cohort=cohort if cohorts else None, **kw)
    got = tflt.fold_wide(
        tflt.init_acc(level, params=_params(tflt), cohorts=cohorts), level,
        _params(tflt), meter=torch.from_numpy(meter.T.copy()),
        pv=torch.from_numpy(pv.T.copy()), t=torch.from_numpy(t),
        duration_s=dur,
        cohort=torch.from_numpy(cohort) if cohorts else None)
    _assert_leaves(got, want, sums=tuple(
        f"{p}sum_{f}" for p in ("cohort_", "", "cov_")
        for f in ("meter", "pv", "residual")))
    assert int(got["lol_events"]) > 0 and int(got["count"]) > 0
    assert float(got["max_ramp_60s"]) > 0.0


# --------------------------------------------------------------------------
# the knobs that give the default run's bits
# --------------------------------------------------------------------------

#: five 360 s blocks from 10:00, so that a group of 2 or 3 leaves a
#: shorter last one
KNOB_RUN = dict(SMALL, n_chains=2, duration_s=1800, block_s=360)
KNOBS = {
    "scan2": dict(block_impl="scan2"),
    "unroll1": dict(scan_unroll=1),
    "unroll4": dict(scan_unroll=4),
    "rng_block": dict(rng_batch="block"),
    "dispatch2": dict(blocks_per_dispatch=2),
    "dispatch3": dict(blocks_per_dispatch=3),
}


def _run_with_blocks(**kw):
    sim = _port(**dict(KNOB_RUN, **kw))
    seen = []
    out = sim.run_reduced(on_block=lambda bi, state, acc: seen.append(
        (bi, {k: v.clone() for k, v in acc.items()})))
    return sim, out, seen


@pytest.fixture(scope="module")
def default_run():
    return _run_with_blocks()


@pytest.mark.parametrize("knob", list(KNOBS))
def test_knob_gives_the_default_bits(default_run, knob):
    from tmhpvsim_torch.obs.report import plan_doc

    _, want, want_seen = default_run
    sim, got, seen = _run_with_blocks(**KNOBS[knob])
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert [bi for bi, _ in seen] == list(range(sim.n_blocks)) == \
        [bi for bi, _ in want_seen]
    for (_, a), (_, b) in zip(seen, want_seen):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    doc = plan_doc(sim.plan)
    for field, value in KNOBS[knob].items():
        assert doc[field] == value, field
    if knob == "rng_block":
        assert sim.precision_doc()["rng_batch"] == "block"
    else:
        assert sim.precision_doc() is None


def test_dispatch_groups_share_one_upload():
    """A group's blocks' inputs are views of one buffer, equal to each
    block's own inputs."""
    sim = _port(**dict(KNOB_RUN, blocks_per_dispatch=3))
    group = sim._inputs_ahead(3)
    assert len(group) == 2 and len(sim._inputs_ahead(5)) == 0
    base = group[0].rows_i.untyped_storage().data_ptr()
    for j, ins in enumerate(group):
        one = sim.host_inputs(3 + j)
        for f in ("mh_idx", "mh_frac", "rows_i", "rows_f"):
            assert torch.equal(getattr(ins, f), getattr(one, f)), f
            assert getattr(ins, f).untyped_storage().data_ptr() == base
        assert np.array_equal(ins.epoch, one.epoch)


@pytest.mark.parametrize("field,value,match", [
    ("block_impl", "fast", "block_impl must be"),
    ("stats_fusion", "both", "stats_fusion must be"),
    ("rng_batch", "tile", "rng_batch must be"),
    ("scan_unroll", 0, "scan_unroll must be"),
    ("blocks_per_dispatch", -1, "blocks_per_dispatch must be"),
])
def test_bad_knob_refused(field, value, match):
    with pytest.raises(ValueError, match=match):
        tcfg.resolve_plan(tcfg.SimConfig(**{field: value}))


def test_cli_knob_flags(tmp_path):
    """--block-impl wide --blocks-per-dispatch 2 --rng-batch block on the
    port's pvsim: the statistics of a reduce run at the defaults, and a
    run report whose plan names the three knobs."""
    from tmhpvsim_torch.cli import main

    common = ["--output", "reduce", "--no-realtime", "--chains", "3",
              "--duration", "2160", "--block-s", "720", "--seed", "7",
              "--start", SMALL["start"], "--device", "cpu"]
    plain, knob = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    rep = str(tmp_path / "r.json")
    assert main(["pvsim", plain] + common) == 0
    assert main(["pvsim", knob, "--block-impl", "wide",
                 "--blocks-per-dispatch", "2", "--rng-batch", "block",
                 "--run-report", rep] + common) == 0
    want = np.genfromtxt(plain, delimiter=",", skip_header=1)
    got = np.genfromtxt(knob, delimiter=",", skip_header=1)
    np.testing.assert_allclose(got, want, rtol=0, atol=0)
    with open(rep) as f:
        plan = json.load(f)["plan"]
    assert (plan["block_impl"], plan["blocks_per_dispatch"],
            plan["rng_batch"]) == ("wide", 2, "block")


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_wide_kernels_match_plain_on_card(card):
    """The K4 merges on the card against their plain versions on a fleet
    block's trace: the statistics and every count, histogram and extremum
    bit for bit, the sums within 1e-6 of the plain float64 sums, and the
    series to rtol 1e-6."""
    sim = TSim(tcfg.SimConfig(fleet=TFleet.synthetic(300, seed=3),
                              **dict(SMALL, **FLEET_KW)), device=card)
    state = sim.init_state()
    ins = sim.host_inputs(0)
    _, meter, pv = sim.step_trace(state, ins)
    obs = sim.observers(state)
    t = ins.rows_i[0]
    acc_k, out_k = wide.wide_fold(meter, pv, t, SMALL["duration_s"],
                                  sim.init_reduce_acc(), obs)
    acc_p, out_p = wide.wide_fold_plain(meter, pv, t, SMALL["duration_s"],
                                        sim.init_reduce_acc(), obs)
    for k in acc_p:
        assert torch.equal(acc_k[k], acc_p[k]), k
    for d in ("telemetry", "fleet"):
        for k, v in out_p[d].items():
            if "sum" in k:
                torch.testing.assert_close(out_k[d][k], v, rtol=1e-6,
                                           atol=1e-3)
            else:
                assert torch.equal(out_k[d][k], v), (d, k)
    ms, ps = wide.wide_series(meter, pv)
    mp, pp = wide.wide_series_plain(meter, pv)
    torch.testing.assert_close(ms, mp, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(ps, pp, rtol=1e-6, atol=0.0)


def test_wide_fold_source_is_built_and_bound():
    """wide_fold.cu is one of the build's sources, keyed by the shared
    observer header, and exports the entries the wrappers bind."""
    from tmhpvsim_torch.kernels import build

    assert "wide_fold.cu" in build.SOURCES and "fold.cuh" in build.HEADERS
    text = open(os.path.join(build.CSRC, "wide_fold.cu")).read()
    for entry in ("wide_fold", "wide_series", "wide_obs_struct_size"):
        assert f'extern "C" int {entry}(' in text, entry
    assert '#include "fold.cuh"' in text


def test_reference_file_has_wide_results():
    """chip_smoke.py's reference phase reads the wide results from the
    reference file (tests/test_torch_engine.py keeps it equal to the JAX
    package's)."""
    path = os.path.join(os.path.dirname(__file__), "data",
                        "torch_port_reference.json")
    with open(path) as f:
        ref = json.load(f)
    assert set(ref["wide"]) == {"reduced", "ensemble", "fleet"}
