"""Heterogeneous fleets in the port against the JAX package, on the CPU.

Tolerances:
* ``FleetParams`` (synthetic, CSV, slices, views, digest): equal — the
  same numpy code on the same numbers;
* the weather-regime tables, their selection and the sampler windows
  drawn through them: bit for bit (draws, as in tests/test_torch_models.py;
  the minute noise to 1e-6 relative, as there);
* the demand transform: bit for bit against the JAX scan's per-second
  meter of a one-chain fleet; this settles that the JAX scan contracts
  ``meter * demand_scale + demand_shift_w`` into one multiply-add
  (tests/test_torch_obs.py settles the telemetry's sum of squares);
* ensemble output with a fleet: the engine tolerance, rtol 2e-5
  / atol 1e-2 (float32 physics goes through another libm);
* a fleet whose columns are all neutral: bit-identical to the run without
  it.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tmhpvsim_torch import config as tcfg
from tmhpvsim_torch import rng
from tmhpvsim_torch.engine.simulation import REDUCE_STATS
from tmhpvsim_torch.engine.simulation import Simulation as TSim
from tmhpvsim_torch.fleet import FleetParams as TFleet
from tmhpvsim_torch.fleet import slice_fleet as t_slice
from tmhpvsim_torch.models import markov_hourly as tmh
from tmhpvsim_tpu import config as jcfg
from tmhpvsim_tpu.engine import Simulation as JSim
from tmhpvsim_tpu.fleet import FleetParams as JFleet
from tmhpvsim_tpu.fleet import slice_fleet as j_slice
from tmhpvsim_tpu.models import markov_hourly as jmh
from test_torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(start="2019-09-05 10:00:00", duration_s=7200, n_chains=3,
             seed=7, block_s=3600)
FLEET = (12, 3)  # FleetParams.synthetic(12, seed=3): regimes 0-2, 3 cohorts
OUTPUTS = ("meter", "pv", "residual")


def _fields(fp):
    return {f.name: getattr(fp, f.name) for f in dataclasses.fields(fp)}


def _same_fleet(jf, tf):
    assert _fields(jf) == _fields(tf)
    assert jf.digest() == tf.digest()
    for prop in ("n_cohorts", "het_demand", "het_power", "het_regime",
                 "uniform_geometry"):
        assert getattr(jf, prop) == getattr(tf, prop), prop


@pytest.mark.parametrize("n, seed", [(12, 3), (257, 0), (64, 11)])
def test_synthetic_matches_jax(n, seed):
    _same_fleet(JFleet.synthetic(n, seed=seed),
                TFleet.synthetic(n, seed=seed))


def test_synthetic_test_fleet_spans_regimes_and_cohorts():
    fp = TFleet.synthetic(*FLEET[:1], seed=FLEET[1])
    assert set(fp.weather_regime) == {0, 1, 2}
    assert fp.n_cohorts >= 2
    assert fp.het_demand and fp.het_power and not fp.uniform_geometry


_CSV = """latitude,longitude,altitude,surface_tilt,ac_limit_w,weather_regime,\
dc_capacity_scale,demand_scale,demand_shift_w,cohort,ignored
48.1,11.6,520,35,,0,1.0,1.0,0,0,x
53.9,9.1,,,180.5,1,1.4,0.8,-50,1,y
47.6,7.7,300,20,250,2,0.9,1.7,120.5,2,z
"""


def test_from_csv_matches_jax(tmp_path):
    path = tmp_path / "fleet.csv"
    path.write_text(_CSV)
    _same_fleet(JFleet.from_csv(str(path)), TFleet.from_csv(str(path)))


@pytest.mark.parametrize("row", [
    "48.1,11.6,520,35,,3,1.0,1.0,0,0,x",      # regime outside [0, 3)
    "48.1,11.6,520,35,,0,1.0,1.0,0,-1,x",     # negative cohort
    "48.1,191.6,520,35,,0,1.0,1.0,0,0,x",     # longitude out of range
    "48.1,11.6,520,35,-5,0,1.0,1.0,0,0,x",    # negative AC limit
    "48.1,11.6,abc,35,,0,1.0,1.0,0,0,x",      # unparsable
])
def test_from_csv_refuses_like_jax(tmp_path, row):
    path = tmp_path / "fleet.csv"
    path.write_text(_CSV.splitlines()[0] + "\n" + row + "\n")
    with pytest.raises(ValueError) as je:
        JFleet.from_csv(str(path))
    with pytest.raises(ValueError) as te:
        TFleet.from_csv(str(path))
    assert str(te.value) == str(je.value)


def test_slice_and_views_match_jax():
    jf, tf = JFleet.synthetic(40, seed=5), TFleet.synthetic(40, seed=5)
    _same_fleet(j_slice(jf, 7, 9), t_slice(tf, 7, 9))
    assert t_slice(tf, 7, 9).n_cohorts == tf.n_cohorts
    assert t_slice(None, 0, 3) is None
    assert _fields(jf.site_grid()) == _fields(tf.site_grid())
    uni = dataclasses.replace(tf, **{f: (getattr(tf, f)[0],) * len(tf) for f
                                     in ("latitude", "longitude", "altitude",
                                         "surface_tilt", "surface_azimuth",
                                         "albedo")})
    juni = dataclasses.replace(jf, **{f: getattr(uni, f) for f in
                                      ("latitude", "longitude", "altitude",
                                       "surface_tilt", "surface_azimuth",
                                       "albedo")})
    assert uni.uniform_geometry
    assert _fields(juni.uniform_site()) == _fields(uni.uniform_site())


def test_regime_tables_bit_exact():
    jp, tp = jmh.regime_step_params(), tmh.regime_step_params()
    assert set(jp) == set(tp)
    for k in jp:
        assert np.array_equal(np.asarray(jp[k]), tp[k].numpy()), k
    for r in range(3):
        js, ts = jmh.select_regime(jp, r), tmh.select_regime(tp, r)
        for k in js:
            assert np.array_equal(np.asarray(js[k]), ts[k].numpy()), (r, k)
    # regime 0 is the single-table simulation's table
    for k, v in tmh.step_params().items():
        assert torch.equal(tmh.select_regime(tp, 0)[k], v), k
    # per chain: one row of each leaf per chain
    regime = torch.tensor([2, 0, 1, 1], dtype=torch.int32)
    per = tmh.select_regime(tp, regime)
    for k in ("loc", "scale", "kappa", "df", "is_t"):
        assert per[k].shape == (4, 6)
        for i, r in enumerate(regime.tolist()):
            assert torch.equal(per[k][i], tp[k][r]), k


def _fleet_sims(**kw):
    """The JAX and the port's fleet runs at this shape; the JAX scan at
    ``scan_unroll`` 1 (a performance knob of the JAX package's SimConfig),
    which compiles faster than the default 8."""
    cfg = dict(SMALL, **kw)
    js = JSim(jcfg.SimConfig(block_impl="scan", dtype="float32",
                             scan_unroll=1,
                             fleet=JFleet.synthetic(FLEET[0], seed=FLEET[1]),
                             **cfg))
    ts = TSim(tcfg.SimConfig(fleet=TFleet.synthetic(FLEET[0], seed=FLEET[1]),
                             **cfg), device="cpu")
    return js, ts


#: the fleet leaves set to NaN, one chain each: a NaN meter (demand scale
#: and shift), a NaN pv (DC scale) and a NaN inverter limit
NAN_LEAVES = (("demand_scale", 1), ("demand_shift_w", 4), ("pv_scale", 7),
              ("ac_limit_w", 10))


def test_nan_fleet_leaves_match_jax():
    """A NaN in one chain's fleet leaf (the demand transform's, the DC
    scale or the inverter limit) goes through the plain acc step as it
    goes through the JAX scan: every statistic is NaN where the JAX run's
    is (the NaN-keeping maximum / minimum of pv_max and the residual
    extrema included), the rest within the engine tolerance, n_seconds
    exact."""
    js, ts = _fleet_sims(duration_s=3600)
    jstate, tstate = js.init_state(), ts.init_state()
    for leaf, c in NAN_LEAVES:
        jstate["fleet"][leaf] = jstate["fleet"][leaf].at[c].set(np.nan)
        tstate["fleet"][leaf][c] = float("nan")
    want = js.run_reduced(state=jstate)
    got = ts.run_reduced(state=tstate)
    for k in REDUCE_STATS:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        if k == "n_seconds":
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=1e-2, err_msg=k)
    nan = {k: set(np.flatnonzero(np.isnan(np.asarray(got[k]))))
           for k in REDUCE_STATS if k != "n_seconds"}
    assert nan["meter_sum"] == {1, 4}
    assert nan["residual_min"] == nan["residual_max"] == {1, 4, 7, 10}
    assert nan["pv_max"] == nan["pv_sum"] == {7, 10}


def test_windows_with_regimes_match_jax():
    """init_state's regime-primed cc0 and the first block's windows, drawn
    through each chain's regime table, against the JAX package's."""
    js, ts = _fleet_sims()
    jstate, tstate = js.init_state(), ts.init_state()
    assert np.array_equal(np.asarray(jstate["fleet"]["regime"]),
                          tstate["fleet"]["regime"].numpy())
    for k in ("cc0", "cloudy_pair"):
        assert np.array_equal(np.asarray(jstate[k]), tstate[k].numpy()), k
    inputs, _ = js.host_inputs(0)
    arrays, mvals, jcarry = jax.vmap(
        lambda ch: js._windows_one_chain(ch, inputs))(jstate)
    tables, tcarry = ts._windows(tstate, ts.host_inputs(0))
    assert np.array_equal(np.asarray(jcarry), tcarry.numpy())
    for k in ("cc", "cloudy", "clear_day", "ws"):
        assert np.array_equal(np.asarray(arrays[k]), tables[k].T.numpy()), k
    for jk, tk in (("noise_min_clear", "ml"), ("noise_min_cloudy", "mc")):
        np.testing.assert_allclose(tables[tk].T.numpy(), np.asarray(mvals[jk]),
                                   rtol=1e-6)
    # the regimes matter: the Munich table gives other windows elsewhere
    munich = tmh.chain_window(
        rng.split(tstate["k_arr"], 4)[:, 0, :], 0, 4, tstate["cc_carry"])[0]
    regimed = tmh.chain_window(
        rng.split(tstate["k_arr"], 4)[:, 0, :], 0, 4, tstate["cc_carry"],
        tmh.select_regime(tmh.regime_step_params(),
                          tstate["fleet"]["regime"]))[0]
    moved = (munich != regimed).any(1)
    assert not moved[tstate["fleet"]["regime"] == 0].any()
    assert moved[tstate["fleet"]["regime"] != 0].all()


# the multiply-add question: one chain on the default site with its own
# demand transform, 20 night minutes (pv is 0, so residual = meter); the
# fleet mean of one chain is its meter itself
_NIGHT = dict(start="2019-09-05 00:00:00", duration_s=1200, n_chains=1,
              seed=7, block_s=1200)
_SCALE, _SHIFT = 1.37, 123.4


def _demand_fleet(cls):
    site = tcfg.Site()
    geo = {f: (getattr(site, f),) for f in (
        "latitude", "longitude", "altitude", "surface_tilt",
        "surface_azimuth", "albedo")}
    return cls(demand_scale=(_SCALE,), demand_shift_w=(_SHIFT,), **geo)


def test_fleet_transforms_contract_like_the_jax_scan():
    """The JAX scan's per-second meter of a one-chain fleet (its ensemble
    series) is ``meter * demand_scale + demand_shift_w`` rounded once, as
    XLA's CPU code contracts it into a multiply-add; rounded after the
    multiply it differs in many seconds.  The port computes it the scan's
    way (``rng.fma``; ``fmaf`` in the kernels, built with -fmad=false).
    The JAX package's wide trace formulation folds the constant instead,
    ``u * (max_w * scale) + shift``, and so differs from both."""
    js = JSim(jcfg.SimConfig(block_impl="scan", dtype="float32",
                             fleet=_demand_fleet(JFleet), **_NIGHT))
    want = np.concatenate([np.asarray(b.meter)[0] for b in
                           js.run_ensemble()])
    plain = TSim(tcfg.SimConfig(**_NIGHT), device="cpu")
    blocks = list(plain.run_blocks())
    assert max(float(b.pv.max()) for b in blocks) == 0.0
    meter = torch.from_numpy(np.concatenate([b.meter[0] for b in blocks]))
    fused = rng.fma(meter, _SCALE, _SHIFT).numpy()
    twice = (meter * torch.tensor(_SCALE) + torch.tensor(_SHIFT)).numpy()
    assert np.array_equal(fused, want)
    assert (twice != want).mean() > 0.05
    fleet = TSim(tcfg.SimConfig(fleet=_demand_fleet(TFleet), **_NIGHT),
                 device="cpu")
    got = np.concatenate([b.meter[0] for b in fleet.run_ensemble()])
    assert np.array_equal(got, want)


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


def test_fleet_ensemble_matches_jax():
    js, ts = _fleet_sims()
    want = list(js.run_ensemble())
    got = list(ts.run_ensemble())
    _assert_blocks_close(want, got)


def _neutral(grid):
    return TFleet.from_site_grid(grid, cohort=(0, 1) * (len(grid) // 2))


def test_neutral_fleet_is_the_plain_run():
    """A fleet whose electrical and stochastic columns are all neutral adds
    no state leaf and no transform: the runs are the site-grid (or, for a
    uniform geometry, the shared-site) runs bit for bit, in every mode."""
    kw = dict(SMALL, duration_s=3600, n_chains=4)
    grid = tcfg.SiteGrid.regular((46, 50), (9, 13), 2, 2)
    site = tcfg.Site()
    uniform = tcfg.SiteGrid(**{f: (getattr(site, f),) * 4 for f in (
        "latitude", "longitude", "altitude", "surface_tilt",
        "surface_azimuth", "albedo")})
    for plain_kw, fleet in (({"site_grid": grid}, _neutral(grid)),
                            ({}, _neutral(uniform))):
        fsim = TSim(tcfg.SimConfig(fleet=fleet, **kw), device="cpu")
        psim = TSim(tcfg.SimConfig(**plain_kw, **kw), device="cpu")
        assert "fleet" not in fsim.init_state()
        assert (fsim.config.site_grid is None) == (not plain_kw)
        got, want = fsim.run_reduced(), psim.run_reduced()
        for k in REDUCE_STATS:
            assert np.array_equal(got[k], want[k]), k
        for run in ("run_blocks", "run_ensemble"):
            for g, w in zip(getattr(fsim, run)(), getattr(psim, run)()):
                for k in OUTPUTS:
                    assert np.array_equal(getattr(g, k), getattr(w, k)), k
