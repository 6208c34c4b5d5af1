"""The port's engine (reduce, ensemble and trace output, shared site, site
grid and heterogeneous fleet) and CLI against the JAX package, on the CPU.

Tolerance (the bound the JAX package holds its own formulations to,
tests/test_engine.py): ``n_seconds`` exact, every other statistic and
every per-second value rtol 2e-5 / atol 1e-2; the time axis (epochs, the
CSV ``time`` column) exact.  Chain keys are bit-exact.  Within the port a
different block partition folds the same seconds in the same order, so it
must give identical bits.

The fleet run's observers: integer counts exact where the per-second
residual is bit-identical to the JAX package's (checked first, on the
fleet's trace); where it is not, a count may differ by at most the number
of residual samples that differ (the suite runs JAX with x64, which
evaluates part of its physics in float64, so most daylight residuals
differ by a few float32 ULP and a sample can cross a sketch bin edge).
Extrema and sums rel 1e-4 (float32 physics through another libm; sums
over chains reassociated).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from tmhpvsim_torch import config as tcfg
from tmhpvsim_torch.engine import convert
from tmhpvsim_torch.engine.simulation import REDUCE_STATS
from tmhpvsim_torch.engine.simulation import Simulation as TSim
from tmhpvsim_torch.fleet import FleetParams as TFleet
from tmhpvsim_torch.obs import telemetry as ttel
from tmhpvsim_tpu import config as jcfg
from tmhpvsim_tpu.engine import Simulation as JSim
from tmhpvsim_tpu.fleet import FleetParams as JFleet
from tmhpvsim_tpu.obs import telemetry as jtel
from test_torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(start="2019-09-05 10:00:00", duration_s=7200, n_chains=3,
             seed=7, block_s=3600)
#: the site grid of the grid checks (tests/test_engine.py:153-164)
GRID = ((46, 50), (9, 13), 2, 2)
OUTPUTS = ("meter", "pv", "residual")
REF = os.path.join(os.path.dirname(__file__), "data",
                   "torch_port_reference.json")
#: the fleet run: FleetParams.synthetic(12, seed=3) (weather regimes 0-2,
#: 3 cohorts, clipped inverters, per-site demand) with both observers at
#: level full; a lower capacity and a 5 s run length so that loss-of-load
#: runs occur in two hours
FLEET_SYNTH = (12, 3)
FLEET_KW = dict(telemetry="full", analytics="full",
                analytics_capacity_w=6000.0, analytics_lolp_k=5)


def _jax_sim(impl="scan", **kw):
    """The JAX package's run at this shape, its per-second scan at
    ``scan_unroll`` 1 (a performance knob of the JAX package's SimConfig,
    which compiles faster than the default 8)."""
    return JSim(jcfg.SimConfig(block_impl=impl, dtype="float32",
                               **dict(SMALL, **{"scan_unroll": 1, **kw})))


def _assert_engine_close(want, got):
    np.testing.assert_array_equal(got["n_seconds"], want["n_seconds"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-2,
                                   err_msg=k)


@pytest.fixture(scope="module")
def jax_scan():
    sim = _jax_sim()
    return sim, sim.run_reduced()


@pytest.fixture(scope="module")
def port():
    sim = TSim(tcfg.SimConfig(**SMALL), device="cpu")
    return sim, sim.run_reduced()


@pytest.fixture(scope="module")
def jax_ensemble():
    return list(_jax_sim().run_ensemble())


@pytest.fixture(scope="module")
def jax_trace():
    return list(_jax_sim().run_blocks())


@pytest.fixture(scope="module")
def jax_grid():
    sim = _jax_sim(site_grid=jcfg.SiteGrid.regular(*GRID))
    return sim, sim.run_reduced()


@pytest.fixture(scope="module")
def jax_fleet():
    sim = _jax_sim(fleet=JFleet.synthetic(FLEET_SYNTH[0],
                                          seed=FLEET_SYNTH[1]), **FLEET_KW)
    return sim, sim.run_reduced()


#: the bf16 compute path's JAX runs: this shape over 2 x 600 s (a short
#: depth keeps tests/test_torch_precision.py's port runs against them
#: cheap)
BF16_SHAPE = dict(duration_s=1200, block_s=600)
BF16_KW = dict(compute_dtype="bf16", **BF16_SHAPE)


@pytest.fixture(scope="module")
def jax_bf16_runs():
    """The JAX package's bf16 reduce runs at this shape's chains over
    ``BF16_SHAPE``, the main path's (shared site) and the fleet run's:
    reduce statistics, and for the fleet the fleet summary."""
    sim = _jax_sim(**BF16_KW)
    fleet = _jax_sim(fleet=JFleet.synthetic(FLEET_SYNTH[0],
                                            seed=FLEET_SYNTH[1]),
                     **FLEET_KW, **BF16_KW)
    return {"reduced": sim.run_reduced(), "sentinel": sim.sentinel.report(),
            "fleet": (fleet.run_reduced(), fleet.fleet_summary())}


@pytest.fixture(scope="module")
def jax_wide_runs():
    """The JAX package's wide formulation at this shape: the reduce
    statistics, the ensemble blocks and the fleet run (reduce statistics
    and fleet summary)."""
    fleet = _jax_sim("wide", fleet=JFleet.synthetic(FLEET_SYNTH[0],
                                                    seed=FLEET_SYNTH[1]),
                     **FLEET_KW)
    return {"reduced": _jax_sim("wide").run_reduced(),
            "ensemble": list(_jax_sim("wide").run_ensemble()),
            "fleet": (fleet.run_reduced(), fleet.fleet_summary())}


@pytest.fixture(scope="module")
def fleet_traces():
    """The fleet run's per-second trace on both sides, and how many
    residual samples differ in their bits."""
    want = list(_jax_sim(fleet=JFleet.synthetic(FLEET_SYNTH[0],
                                                seed=FLEET_SYNTH[1]))
                .run_blocks())
    got = list(_port_sim(fleet=TFleet.synthetic(FLEET_SYNTH[0],
                                                seed=FLEET_SYNTH[1]))
               .run_blocks())
    n_diff = sum(int((np.asarray(w.residual) != g.residual).sum())
                 for w, g in zip(want, got))
    return want, got, n_diff


@pytest.fixture(scope="module")
def port_fleet():
    sim = _port_sim(fleet=TFleet.synthetic(FLEET_SYNTH[0],
                                           seed=FLEET_SYNTH[1]), **FLEET_KW)
    return sim, sim.run_reduced()


def _port_sim(**kw):
    return TSim(tcfg.SimConfig(**dict(SMALL, **kw)), device="cpu")


def _assert_blocks_close(want, got):
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g.offset == w.offset
        np.testing.assert_array_equal(g.epoch, w.epoch)
        for k in OUTPUTS:
            wk = np.asarray(getattr(w, k))
            assert getattr(g, k).shape == wk.shape, k
            np.testing.assert_allclose(getattr(g, k), wk, rtol=2e-5,
                                       atol=1e-2, err_msg=k)


def test_reduce_matches_jax_scan(jax_scan, port):
    _assert_engine_close(jax_scan[1], port[1])
    je, te = jax_scan[0].ensemble_stats(), port[0].ensemble_stats()
    assert je["n_seconds"] == te["n_seconds"]
    for k in REDUCE_STATS:
        assert te[k] == pytest.approx(je[k], rel=2e-5, abs=1e-2), k


def test_reduce_matches_jax_wide(jax_wide_runs, port):
    """The CPU default formulation of the JAX package, as a second case."""
    _assert_engine_close(jax_wide_runs["reduced"], port[1])


def _f32_list(a):
    """Shortest decimals that give back the float32 values."""
    return [float(np.format_float_positional(x, unique=True, trim="-"))
            for x in np.asarray(a, np.float32).ravel()]


#: seconds of the wide ensemble's per-second means the reference file keeps
WIDE_ENSEMBLE_S = 1800


def test_reference_file_tracks_jax(jax_scan, jax_ensemble, jax_trace,
                                   jax_grid, jax_fleet, jax_wide_runs,
                                   jax_bf16_runs):
    """tests/data/torch_port_reference.json holds the JAX package's results
    at this shape for chip_smoke.py's reference phase — the reduce
    statistics, every per-second ensemble mean, chain 0's trace over the
    first hour, the site-grid reduce statistics, the fleet run's reduce
    statistics and fleet summary, the wide formulation's reduce
    statistics, ensemble means over the first half hour and fleet run, and
    under ``compute_dtype='bf16'`` the reduce statistics with the drift
    sentinel's report, and the fleet run (section ``bf16``); it is written
    when missing and must equal what the JAX package computes (its ``rbg``
    section is tests/test_torch_rbg.py's, its ``unsafe_rbg`` section
    tests/test_torch_urbg.py's)."""
    jw = jax_wide_runs
    jb = jax_bf16_runs
    doc = {
        "config": SMALL,
        "reduced": {k: np.asarray(v).tolist()
                    for k, v in jax_scan[1].items()},
        "ensemble": {k: _f32_list(np.concatenate(
            [np.asarray(getattr(b, k))[0] for b in jax_ensemble]))
            for k in ("meter", "pv")},
        "trace": {"chain": 0, **{k: _f32_list(
            np.asarray(getattr(jax_trace[0], k))[0, :3600])
            for k in ("meter", "pv")}},
        "site_grid": {"regular": GRID, "reduced": {
            k: np.asarray(v).tolist() for k, v in jax_grid[1].items()}},
        "fleet": {"synthetic": FLEET_SYNTH, "config": FLEET_KW,
                  "reduced": {k: np.asarray(v).tolist()
                              for k, v in jax_fleet[1].items()},
                  "summary": jax_fleet[0].fleet_summary()},
        "wide": {
            "reduced": {k: np.asarray(v).tolist()
                        for k, v in jw["reduced"].items()},
            "ensemble": {k: _f32_list(np.concatenate(
                [np.asarray(getattr(b, k))[0] for b in jw["ensemble"]])
                [:WIDE_ENSEMBLE_S]) for k in ("meter", "pv")},
            "fleet": {"reduced": {k: np.asarray(v).tolist()
                                  for k, v in jw["fleet"][0].items()},
                      "summary": jw["fleet"][1]},
        },
        "bf16": {
            "config": dict(SMALL, **BF16_SHAPE),
            "reduced": {k: np.asarray(v).tolist()
                        for k, v in jb["reduced"].items()},
            "sentinel": jb["sentinel"],
            "fleet": {"reduced": {k: np.asarray(v).tolist()
                                  for k, v in jb["fleet"][0].items()},
                      "summary": jb["fleet"][1]},
        },
    }
    if not os.path.exists(REF):
        os.makedirs(os.path.dirname(REF), exist_ok=True)
        with open(REF, "w") as f:
            json.dump(doc, f, separators=(",", ":"))
    assert os.path.getsize(REF) < 300_000
    with open(REF) as f:
        held = {k: v for k, v in json.load(f).items()
                if k not in ("rbg", "unsafe_rbg", "metersim")}
    assert held == json.loads(json.dumps(doc))


def test_reference_file_metersim_tracks_jax():
    """The reference file's ``metersim`` section: the JAX device meter
    producer's first three 600-second blocks at seed 7 under each key
    implementation (their SHA-256 and first values), which chip_smoke.py's
    ``phase_k15`` holds the card's K15 blocks to; written when missing,
    and it must equal what the JAX package computes."""
    from test_torch_metersim import jax_reference_blocks

    sec = jax_reference_blocks()
    with open(REF) as f:
        doc = json.load(f)
    if "metersim" not in doc:
        doc["metersim"] = sec
        with open(REF, "w") as f:
            json.dump(doc, f, separators=(",", ":"))
    assert os.path.getsize(REF) < 300_000
    with open(REF) as f:
        assert json.load(f)["metersim"] == json.loads(json.dumps(sec))


def test_ensemble_matches_jax_scan(jax_ensemble):
    """run_ensemble against the JAX scan formulation's fleet means."""
    got = list(_port_sim().run_ensemble())
    assert got[0].meter.shape == (1, SMALL["block_s"])
    _assert_blocks_close(jax_ensemble, got)


def test_trace_matches_jax(jax_trace):
    """run_blocks against the JAX package's per-chain trace."""
    got = list(_port_sim().run_blocks())
    assert got[0].pv.shape == (SMALL["n_chains"], SMALL["block_s"])
    _assert_blocks_close(jax_trace, got)


@pytest.mark.parametrize("overlap", ["off", "auto"])
def test_trace_padding_and_overlap(overlap):
    """A duration that is not a whole number of blocks trims the last
    block's padding seconds; the double-buffered loop yields the same
    blocks as the serial one."""
    kw = dict(duration_s=5400, n_chains=2)
    want = list(_port_sim(output_overlap="off", **kw).run_blocks())
    got = list(_port_sim(output_overlap=overlap, **kw).run_blocks())
    assert [b.pv.shape[1] for b in got] == [3600, 1800]
    for w, g in zip(want, got):
        for k in OUTPUTS:
            assert np.array_equal(getattr(g, k), getattr(w, k)), k


def test_site_grid_reduce_matches_jax_scan(jax_grid):
    grid = tcfg.SiteGrid.regular(*GRID)
    sim = _port_sim(site_grid=grid)
    assert sim.config.n_chains == len(grid) == 4
    _assert_engine_close(jax_grid[1], sim.run_reduced())


def test_grid_state_converts(jax_grid):
    """The site leaves ride the state both ways, equal to the JAX
    package's."""
    js = _jax_state_numpy(jax_grid[0].state)
    tstate = convert.state_from_numpy(js, "cpu", "threefry2x32")
    fresh = _port_sim(site_grid=tcfg.SiteGrid.regular(*GRID)).init_state()
    for k in convert.SITE_FIELDS:
        assert torch.equal(tstate["site"][k], fresh["site"][k]), k
        back = convert.state_to_numpy(tstate, "threefry2x32")
        assert np.array_equal(back["site"][k], js["site"][k]), k


def test_identical_grid_matches_shared_site():
    """A grid of n copies of the default site reproduces the shared-site
    run (tests/test_sitegrid.py:146-166): the same seed gives the same
    meter; pv differs only by the geometry path (host float64 against
    device float32 split time), sub-watt on a ~250 W plant."""
    n, site = 4, tcfg.Site()
    grid = tcfg.SiteGrid(**{f: (getattr(site, f),) * n for f in (
        "latitude", "longitude", "altitude", "surface_tilt",
        "surface_azimuth", "albedo")})
    kw = dict(duration_s=300, block_s=300, n_chains=n)
    blk_g = next(_port_sim(site_grid=grid, **kw).run_blocks())
    blk_s = next(_port_sim(**kw).run_blocks())
    np.testing.assert_array_equal(blk_g.meter, blk_s.meter)
    assert np.abs(blk_g.pv - blk_s.pv).max() < 1.0
    assert blk_g.pv.max() > 10.0


def test_state_after_two_blocks(jax_scan, port):
    js, ts = jax_scan[0].state, port[0].state
    for k in convert.KEY_LEAVES:
        assert np.array_equal(np.asarray(jax.random.key_data(js[k])),
                              ts[k].numpy().astype(np.uint32)), k
    for k in ("cc_carry", "cc0", "cloudy_pair"):
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=2e-6, atol=1e-6, err_msg=k)
    for k in convert.CARRY_LEAVES:
        np.testing.assert_allclose(ts["carry"][k].numpy(),
                                   np.asarray(js["carry"][k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("block_s", [1800, 3600])
def test_block_partition_invariance(port, block_s):
    got = TSim(tcfg.SimConfig(**dict(SMALL, block_s=block_s)),
               device="cpu").run_reduced()
    for k in REDUCE_STATS:
        assert np.array_equal(got[k], port[1][k]), k


def test_chain_slab_matches_full_run():
    full = TSim(tcfg.SimConfig(**dict(SMALL, n_chains=5, duration_s=3600)),
                device="cpu").run_reduced()
    slab = TSim(tcfg.SimConfig(**dict(SMALL, n_chains=3, duration_s=3600,
                                      n_chains_total=5, chain_offset=1)),
                device="cpu").run_reduced()
    for k in REDUCE_STATS:
        assert np.array_equal(slab[k], full[k][1:4]), k


def _jax_state_numpy(state):
    out = {k: np.asarray(jax.random.key_data(state[k]))
           for k in convert.KEY_LEAVES}
    for k in convert.FLOAT_LEAVES:
        out[k] = np.asarray(state[k])
    out["carry"] = {k: np.asarray(v) for k, v in state["carry"].items()}
    for tree in ("site", "fleet"):
        if tree in state:
            out[tree] = {k: np.asarray(v) for k, v in state[tree].items()}
    return out


def test_jax_state_continues_in_port(jax_scan):
    """JAX runs block 0; the port takes its state and runs block 1; the
    result is JAX's two-block run."""
    sim = jax_scan[0]
    inputs, _ = sim.host_inputs(0)
    state, acc = sim.step_acc(sim.init_state(), inputs,
                              sim.init_reduce_acc())
    state_np = _jax_state_numpy(state)
    acc_np = {k: np.asarray(v) for k, v in acc.items()}
    tstate = convert.state_from_numpy(state_np, "cpu", "threefry2x32")
    back = convert.state_to_numpy(tstate, "threefry2x32")
    for k in convert.KEY_LEAVES + convert.FLOAT_LEAVES:
        assert np.array_equal(back[k], state_np[k])
    tacc = convert.acc_from_numpy(acc_np, "cpu")
    for k, v in convert.acc_to_numpy(tacc).items():
        assert np.array_equal(v, acc_np[k])
    got = TSim(tcfg.SimConfig(**SMALL), device="cpu").run_reduced(
        state=tstate, acc=tacc, start_block=1)
    _assert_engine_close(jax_scan[1], got)


def test_resume_needs_accumulator():
    with pytest.raises(ValueError):
        TSim(tcfg.SimConfig(**SMALL), device="cpu").run_reduced(
            start_block=1)


# --------------------------------------------------------------------------
# heterogeneous fleet with telemetry and analytics
# --------------------------------------------------------------------------


def _assert_summary(got, want, path="", slack=0):
    """Host summaries: same structure, ints within ``slack`` (``count``
    exact), floats rel 1e-4 (plus, for the probabilities, ``slack``
    samples' worth)."""
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


def test_fleet_reduce_matches_jax(jax_fleet, port_fleet):
    assert port_fleet[0].config.n_chains == FLEET_SYNTH[0]
    assert port_fleet[0].config.site_grid is not None
    _assert_engine_close(jax_fleet[1], port_fleet[1])


def test_fleet_trace_matches_jax(fleet_traces):
    """The fleet's per-second trace against the JAX package's (the engine
    tolerance), and every clipped site within its AC limit."""
    want, got, _ = fleet_traces
    _assert_blocks_close(want, got)
    limit = np.asarray(TFleet.synthetic(FLEET_SYNTH[0],
                                        seed=FLEET_SYNTH[1]).ac_limit_w,
                       np.float32)
    for blk in got:
        assert (blk.pv <= limit[:, None]).all()
    assert max(float(b.pv.max()) for b in got) > 10.0


def test_fleet_summary_matches_jax(jax_fleet, port_fleet, fleet_traces):
    """The run totals (int64 / float64 host merges of each block's delta)
    and the fleet section: counts exact if every residual sample is
    bit-identical, else each within the number that is not; count and
    the cohort counts always exact; the rest rel 1e-4."""
    slack = fleet_traces[2]
    jt, tt = jax_fleet[0]._fleet_total, port_fleet[0]._fleet_total
    assert set(jt) == set(tt)
    for k, want in jt.items():
        want = np.asarray(want)
        assert tt[k].dtype == want.dtype, k
        if k in ("count", "cohort_count", "regime_observed"):
            assert np.array_equal(tt[k], want), k
        elif want.dtype.kind == "i":
            assert np.abs(tt[k] - want).max() <= slack, k
        else:
            np.testing.assert_allclose(tt[k], want, rtol=1e-4, err_msg=k)
    want = jax_fleet[0].fleet_summary()
    got = port_fleet[0].fleet_summary()
    _assert_summary(got, want, slack=slack)
    assert got["lolp"]["events"] > 0 and len(got["cohorts"]) == 3
    assert got["regimes"]["covered"]["seconds"] > 0


def test_fleet_telemetry_matches_jax(jax_fleet, port_fleet):
    """The last block's telemetry delta (and its summary) against the JAX
    package's: counts, the csi histogram and the occupancy exact, the
    moments rel 1e-4."""
    want = {k: np.asarray(v) for k, v in jax_fleet[0]._tel_last.items()}
    got = port_fleet[0]._tel_last
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k.startswith(("min_", "max_", "sum_", "sumsq_")):
            np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=k)
        else:
            assert np.array_equal(g, w), k
    _assert_summary(port_fleet[0].tel_summary, jtel.summarize(want))
    assert port_fleet[0].tel_summary == ttel.summarize(got)


def test_fleet_state_converts(jax_fleet, port_fleet):
    """The fleet leaves ride the state both ways, equal to the JAX
    package's."""
    js = _jax_state_numpy(jax_fleet[0].state)
    assert set(js["fleet"]) == {"demand_scale", "demand_shift_w",
                                "pv_scale", "ac_limit_w", "regime",
                                "cohort"}
    tstate = convert.state_from_numpy(js, "cpu", "threefry2x32")
    fresh = port_fleet[0].init_state()
    for k, v in js["fleet"].items():
        assert torch.equal(tstate["fleet"][k], fresh["fleet"][k]), k
        back = convert.state_to_numpy(tstate, "threefry2x32")["fleet"][k]
        assert back.dtype == v.dtype and np.array_equal(back, v), k
