"""The port's host modules and models against the JAX package's, on the same
numpy-seeded inputs.

Tolerances:
* the float64 host side (time grid, calendar index, block_geometry): bit
  for bit — the same numpy code on the same numbers;
* draws: bit-exact, as in tests/test_torch_rng.py, through the Markov
  chain and the cloudy, clear-day and windspeed windows (rng.fma sits
  where XLA's CPU code fuses a multiply-add in those functions); the
  minute noise runs in float64 on the JAX side under the suite's x64
  mode, so it is held to 1e-6 relative;
* single functions that jax runs op by op here (the distribution
  transforms, the renewal cycle, csi composition) go through a different
  libm on each side: a few float32 ULP;
* elementwise float32 physics: XLA's CPU exp / log / pow / acos and
  torch's differ by an ULP or two, and the DISC / SAPM chain amplifies a
  few of them (a log of a small irradiance, a cancellation in the
  inverter's quadratic): 2e-3 W absolute (1e-5 of the 250 W rating) plus
  2e-5 relative, with the share of bit-exact outputs reported;
* float32 site geometry from the split time: the bounds the JAX package
  holds it to against its float64 host path (tests/test_sitegrid.py):
  4e-4 rad of zenith, 4e-4 of cos(AOI), 1 W/m2 of clear-sky GHI.  Both
  sides evaluate the same float32 expressions, so the port stays far
  inside them (the sin of a ~130 rad ephemeris argument is where libms
  differ most).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmhpvsim_torch import config as tcfg
from tmhpvsim_torch.data import SANDIA_INVERTER as T_INV
from tmhpvsim_torch.data import SAPM_MODULE as T_MOD
from tmhpvsim_torch.models import clearsky_index as tci
from tmhpvsim_torch.models import distributions as tdist
from tmhpvsim_torch.models import markov_hourly as tmh
from tmhpvsim_torch.models import pv as tpv
from tmhpvsim_torch.models import renewal as tren
from tmhpvsim_torch.models import solar as tsol
from tmhpvsim_torch.models import timegrid as ttg
from tmhpvsim_tpu import config as jcfg
from tmhpvsim_tpu.data import SANDIA_INVERTER, SAPM_MODULE
from tmhpvsim_tpu.models import clearsky_index as jci
from tmhpvsim_tpu.models import distributions as jdist
from tmhpvsim_tpu.models import markov_hourly as jmh
from tmhpvsim_tpu.models import pv as jpv
from tmhpvsim_tpu.models import renewal as jren
from tmhpvsim_tpu.models import solar as jsol
from tmhpvsim_tpu.models import timegrid as jtg
from test_torch_threads import one_torch_thread  # noqa: F401

F32 = jnp.float32
SEEDS = [0, 1, 2]
STARTS = ["2019-09-05 10:00:00", "2019-10-27 01:30:00",
          "2019-03-31 01:00:00", "2019-12-31 23:00:00"]


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _keys(seed, n=24):
    jk = jax.random.split(jax.random.key(seed), n)
    return jk, torch.from_numpy(_kd(jk))


def _close(want, got, rtol, atol=0.0):
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


# --------------------------------------------------------------------------
# config and data: the same fields, defaults and constants
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cls", ["Site", "ModelOptions", "SimConfig",
                                 "SiteGrid"])
def test_config_fields_and_defaults_match(cls):
    jf = {f.name: f for f in dataclasses.fields(getattr(jcfg, cls))}
    tf = {f.name: f for f in dataclasses.fields(getattr(tcfg, cls))}
    assert list(jf) == list(tf)
    if cls == "SiteGrid":  # no defaults for the per-site fields
        j = jcfg.SiteGrid.regular((47, 55), (6, 15), 3, 4)
        t = tcfg.SiteGrid.regular((47, 55), (6, 15), 3, 4)
    else:
        j, t = getattr(jcfg, cls)(), getattr(tcfg, cls)()
    for name in jf:
        jv, tv = getattr(j, name), getattr(t, name)
        if dataclasses.is_dataclass(jv):
            assert dataclasses.astuple(jv) == dataclasses.astuple(tv)
        else:
            assert jv == tv, name


@pytest.mark.parametrize("field,value", [
    ("site_grid", object()), ("fleet", object()), ("trace", "t.json"),
    ("phase_obs", "on"), ("prng_impl", "philox"),
    ("output", "nonsense"), ("dtype", "bfloat16"),
    ("output_overlap", "on"),
    ("mesh_scenario", 2), ("pod_obs", "on"),
    ("pod_straggler_factor", 3.0),
])
def test_config_outside_slice_raises(field, value):
    with pytest.raises(NotImplementedError):
        tcfg.SimConfig(**{field: value})


@pytest.mark.parametrize("field,good,bad", [
    ("checkpoint_keep", 1, 0), ("checkpoint_async", "on", "maybe"),
    ("preempt_grace_s", 30.0, -1.0),
])
def test_config_checkpoint_options_inside_slice(field, good, bad):
    """The checkpoint options are in the slice, with the JAX CLI's value
    checks."""
    assert getattr(tcfg.SimConfig(**{field: good}), field) == good
    with pytest.raises(ValueError, match=field):
        tcfg.SimConfig(**{field: bad})


@pytest.mark.parametrize("impl", ["threefry2x32", "rbg", "unsafe_rbg"])
def test_config_prng_impls_inside_slice(impl):
    """Every key implementation the JAX SimConfig takes is in the slice,
    and the plan echoes it."""
    cfg = tcfg.SimConfig(prng_impl=impl)
    assert cfg.prng_impl == impl
    assert tcfg.resolve_plan(cfg).prng_impl == impl


def test_config_tune_inside_slice():
    """``tune`` 'auto' and 'force' are accepted; another value raises the
    JAX package's ValueError from plan resolution."""
    from tmhpvsim_torch.engine import autotune as tat
    from tmhpvsim_tpu.engine import autotune as jat

    for value in ("off", "auto", "force"):
        assert tcfg.SimConfig(tune=value).tune == value
    bad = tcfg.SimConfig(tune="sometimes")
    with pytest.raises(ValueError) as t:
        tat.resolve_plan(bad, device="cpu")
    with pytest.raises(ValueError) as j:
        jat.resolve_plan(jcfg.SimConfig(tune="sometimes"))
    assert str(t.value) == str(j.value) == (
        "tune must be 'auto', 'off' or 'force', got 'sometimes'")


def test_refusal_names_what_is_still_to_port():
    assert tcfg.SimConfig(prng_impl="rbg").prng_impl == "rbg"
    assert tcfg.SimConfig(prng_impl="unsafe_rbg").prng_impl == "unsafe_rbg"
    with pytest.raises(NotImplementedError) as e:
        tcfg.SimConfig(prng_impl="philox")
    msg = str(e.value)
    assert "prng_impl='philox'" in msg and "still to port" not in msg \
        and "float32 or bf16" in msg \
        and "threefry2x32, rbg or unsafe_rbg" in msg \
        and "exact kernels" not in msg


@pytest.mark.parametrize("field,value,plan", [
    ("block_impl", "wide", ("wide", "fused", 8, 1, "scan")),
    ("block_impl", "scan2", ("scan2", "fused", 8, 1, "scan")),
    ("block_impl", "auto", ("scan", "fused", 8, 1, "scan")),
    ("stats_fusion", "split", ("scan", "split", 8, 1, "scan")),
    ("scan_unroll", 1, ("scan", "fused", 1, 1, "scan")),
    ("blocks_per_dispatch", 4, ("scan", "fused", 8, 4, "scan")),
    ("blocks_per_dispatch", 0, ("scan", "fused", 8, 1, "scan")),
    ("rng_batch", "block", ("scan", "fused", 8, 1, "block")),
])
def test_config_knobs_inside_slice(field, value, plan):
    """The plan knobs the JAX package holds to the same run are inside the
    slice; 'auto' and 0 resolve as the JAX package resolves them on an
    accelerator."""
    p = tcfg.resolve_plan(tcfg.SimConfig(**{field: value}))
    assert (p.block_impl, p.stats_fusion, p.scan_unroll,
            p.blocks_per_dispatch, p.rng_batch) == plan


@pytest.mark.parametrize("field,value,plan", [
    ("kernel_impl", "table", ("table", 1)),
    ("kernel_impl", "auto", ("exact", 1)),
    ("geom_stride", 60, ("exact", 60)),
    ("geom_stride", 30, ("exact", 30)),
    ("geom_stride", 0, ("exact", 1)),
])
def test_config_levers_inside_slice(field, value, plan):
    """kernel_impl and geom_stride are inside the slice;
    'auto' and 0 resolve as the JAX package resolves them untuned."""
    p = tcfg.resolve_plan(tcfg.SimConfig(**{field: value}))
    assert (p.kernel_impl, p.geom_stride) == plan


def test_model_options_outside_slice_raise():
    with pytest.raises(NotImplementedError):
        tcfg.ModelOptions(swap_covered_branches=True)


def test_parameters_match():
    from tmhpvsim_torch import data as tdata
    from tmhpvsim_tpu.data import parameters as jp

    assert tdata.MARKOV_STEP_BINS == jp.MARKOV_STEP_BINS
    assert tdata.MARKOV_STEP_PARAMS == jp.MARKOV_STEP_PARAMS
    assert tdata.MARKOV_STEP_PARAMS_REGIMES == jp.MARKOV_STEP_PARAMS_REGIMES
    assert tdata.SAPM_MODULE == jp.SAPM_MODULE
    assert tdata.SANDIA_INVERTER == jp.SANDIA_INVERTER
    assert tdata.LINKE_TURBIDITY_MONTHLY_MUNICH == \
        jp.LINKE_TURBIDITY_MONTHLY_MUNICH


# --------------------------------------------------------------------------
# float64 host side: bit for bit
# --------------------------------------------------------------------------


@pytest.mark.parametrize("start", STARTS)
def test_timegrid_and_block_index_bit_exact(start):
    js = jtg.TimeGridSpec.from_local_start(start, 3 * 86400, "Europe/Berlin")
    ts = ttg.TimeGridSpec.from_local_start(start, 3 * 86400, "Europe/Berlin")
    for off in (0, 3600, 86400 + 1800):
        jb, tb = js.block(off, 7200), ts.block(off, 7200)
        for f in dataclasses.fields(jb):
            assert np.array_equal(getattr(jb, f.name), getattr(tb, f.name))
        ji, jr = jci.host_block_index(js, off, 7200, F32)
        ti, tr = tci.host_block_index(ts, off, 7200)
        assert jr == tr
        for k in ji:
            assert np.array_equal(ji[k], ti[k]) and ji[k].dtype == ti[k].dtype
        lo, hi = tr
        for a, b in zip(js.minute_value_features(lo, hi),
                        ts.minute_value_features(lo, hi)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("site", [{}, {"latitude": -33.9, "longitude": 18.4,
                                       "altitude": 500.0,
                                       "surface_tilt": 30.0,
                                       "surface_azimuth": 0.0,
                                       "timezone": "Africa/Johannesburg"}])
def test_block_geometry_bit_exact(start, site):
    spec = jtg.TimeGridSpec.from_local_start(
        start, 86400, site.get("timezone", "Europe/Berlin"))
    b = spec.block(0, 86400)
    ep, doy = b.epoch.astype(np.float64), b.doy.astype(np.float64)
    jg = jsol.block_geometry(ep, doy, jcfg.Site(**site), xp=np)
    tg = tsol.block_geometry(ep, doy, tcfg.Site(**site))
    assert list(jg) == list(tg)
    for k in jg:
        assert np.array_equal(jg[k], tg[k]), k


def test_slice_grid_matches():
    j = jcfg.slice_grid(jcfg.SiteGrid.regular((46, 50), (9, 13), 3, 3), 2, 4)
    t = tcfg.slice_grid(tcfg.SiteGrid.regular((46, 50), (9, 13), 3, 3), 2, 4)
    assert dataclasses.astuple(j) == dataclasses.astuple(t)
    assert tcfg.slice_grid(None, 0, 1) is None


def _sites_csv(tmp_path, text):
    p = tmp_path / "sites.csv"
    p.write_text(text)
    return str(p)


@pytest.mark.parametrize("text", [
    "latitude,longitude,altitude,surface_tilt,surface_azimuth,albedo,owner\n"
    "48.1,11.6,520,30,180,0.2,alice\n47.0,9.5,800,45,170,0.3,bob\n",
    "latitude,longitude\n48.1,11.6\n47.0,9.5\n",
], ids=["full-columns", "defaults"])
def test_sites_csv_matches_jax(tmp_path, text):
    path = _sites_csv(tmp_path, text)
    assert dataclasses.astuple(tcfg.SiteGrid.from_csv(path)) == \
        dataclasses.astuple(jcfg.SiteGrid.from_csv(path))


@pytest.mark.parametrize("text, match", [
    ("latitude,altitude\n48.1,100\n", "longitude"),
    ("latitude,longitude\n48.1,11.6\n48.2,oops\n", "line 3"),
    ("latitude,longitude\n", "no data rows"),
    ("latitude,longitude\n48.1,11.6\n95.0,11.6\n",
     r"line 3: latitude=95\.0 outside \[-90, 90\]"),
    ("latitude,longitude\n48.1,11.6\n48.1,191.0\n",
     r"line 3: longitude=191\.0 outside"),
    ("latitude,longitude,albedo\n48.1,11.6,0.2\n48.1,11.6,1.5\n",
     r"line 3: albedo=1\.5 outside \[0, 1\]"),
    ("latitude,longitude,surface_tilt\n48.1,11.6,0.2\n48.1,11.6,120\n",
     r"line 3: surface_tilt=120\.0 outside"),
    ("latitude,longitude\n48.1,11.6\nnan,11.6\n", "line 3"),
    ("latitude,longitude\n48.1\n", "line 2.*required"),
    ("latitude,longitude\n,11.6\n", "line 2.*required"),
    ("latitude,longitude\n48.1,11.6\n\n47.0,9.5\n48.2,oops\n", "line 5"),
], ids=["missing-column", "bad-value", "empty", "latitude-range",
        "longitude-range", "albedo-range", "tilt-range", "non-finite",
        "ragged-row", "blank-cell", "line-after-blank"])
def test_sites_csv_errors(tmp_path, text, match):
    """A bad site list is refused by the CLI with the JAX package's message
    (tests/test_sitegrid.py:204-300), naming the offending line."""
    from tmhpvsim_torch.cli import main

    path = _sites_csv(tmp_path, text)
    with pytest.raises(ValueError, match=match):
        jcfg.SiteGrid.from_csv(path)
    with pytest.raises(SystemExit, match=match):
        main(["pvsim", str(tmp_path / "out.csv"), "--sites-csv", path,
              "--output", "reduce", "--no-realtime", "--duration", "60",
              "--device", "cpu"])


def test_cli_sites_csv_end_to_end(tmp_path):
    from tmhpvsim_torch.cli import main

    sites = _sites_csv(tmp_path, "latitude,longitude\n48.1,11.6\n47.0,9.5"
                                 "\n46.0,8.0\n45.0,7.0\n")
    out = tmp_path / "fleet.csv"
    assert main(["pvsim", str(out), "--no-realtime", "--duration", "120",
                 "--seed", "5", "--sites-csv", sites, "--output", "reduce",
                 "--start", "2019-09-05 10:00:00", "--device", "cpu"]) == 0
    lines = out.read_text().splitlines()
    assert len(lines) == 1 + 4 + 1  # header + 4 sites + ensemble row


# --------------------------------------------------------------------------
# float32 site geometry (the site-grid path)
# --------------------------------------------------------------------------

#: a handful of sites: the default Munich roof, the southern hemisphere
#: facing north, a high east-facing plant, the tropics, the far north
GEO_SITES = [
    (48.12, 11.60, 34.0, 48.12, 180.0, 0.25),
    (-33.9, 18.4, 500.0, 30.0, 0.0, 0.2),
    (46.5, 9.8, 2500.0, 20.0, 90.0, 0.3),
    (1.3, 103.8, 15.0, 5.0, 180.0, 0.15),
    (69.6, 18.9, 10.0, 70.0, 200.0, 0.5),
]


def _split_day(day="2019-09-05 00:00:00", n=86400, step=60):
    spec = jtg.TimeGridSpec.from_local_start(day, n, "Europe/Berlin")
    b = spec.block(0, n)
    ep = b.epoch[::step]
    return ((ep // 86400 - 10957).astype(np.float32),
            (ep % 86400).astype(np.float32), b.doy[::step].astype(np.float32))


def _geo_inputs(sites, day="2019-09-05 00:00:00"):
    d2k, sec, doy = _split_day(day)
    cols = np.asarray(sites, np.float32).T        # (6, n)
    return (d2k[:, None], sec[:, None], doy[:, None]), cols


@pytest.mark.parametrize("day", ["2019-09-05 00:00:00",
                                 "2019-12-21 00:00:00"])
def test_sun_position_split(day):
    (d2k, sec, _), cols = _geo_inputs(GEO_SITES, day)
    want = jsol.sun_position_split(jnp.asarray(d2k), jnp.asarray(sec),
                                   jnp.asarray(cols[0]), jnp.asarray(cols[1]),
                                   xp=jnp)
    got = tsol.sun_position_split(torch.from_numpy(d2k),
                                  torch.from_numpy(sec),
                                  torch.from_numpy(cols[0]),
                                  torch.from_numpy(cols[1]))
    for k, bound in (("zenith", 4e-4), ("cos_zenith", 4e-4)):
        err = np.abs(np.asarray(want[k], np.float64) - got[k].numpy())
        assert err.max() < bound, (k, err.max())
    daz = np.asarray(want["azimuth"], np.float64) - got["azimuth"].numpy()
    daz = np.abs((daz + np.pi) % (2 * np.pi) - np.pi)
    assert daz.max() < 4e-4


@pytest.mark.parametrize("day", ["2019-09-05 00:00:00",
                                 "2019-06-21 00:00:00"])
def test_device_geometry(day):
    (d2k, sec, doy), cols = _geo_inputs(GEO_SITES, day)
    turb = np.asarray(jcfg.Site().linke_turbidity_monthly, np.float32)
    want = jsol.device_geometry(
        jnp.asarray(d2k), jnp.asarray(sec), jnp.asarray(doy),
        *(jnp.asarray(c) for c in cols), jnp.asarray(turb), xp=jnp)
    got = tsol.device_geometry(
        torch.from_numpy(d2k), torch.from_numpy(sec), torch.from_numpy(doy),
        *(torch.from_numpy(c) for c in cols), torch.from_numpy(turb))
    assert list(got) == list(want)
    bounds = {"zenith": 4e-4, "cos_zenith": 4e-4, "apparent_zenith": 4e-4,
              "cos_aoi": 4e-4, "ghi_clear": 1.0, "csi_cap": 1e-3,
              "dni_extra": 1e-3, "airmass_abs": 1e-3}
    for k, bound in bounds.items():
        w = np.broadcast_to(np.asarray(want[k], np.float64), (len(d2k), 5))
        g = got[k].numpy().astype(np.float64)
        # the airmass and the csi cap grow without bound at night: hold
        # them relative where the sun is up
        day_ = np.asarray(want["zenith"]) < np.radians(88.0)
        err = np.abs(w - g) / (np.abs(w) if k in ("airmass_abs", "csi_cap")
                               else 1.0)
        assert err[day_].max() < bound, (k, err[day_].max())
        assert np.isfinite(g).all(), k


# --------------------------------------------------------------------------
# distributions, Markov chain, renewal
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_distribution_transforms(seed):
    r = np.random.default_rng(seed)
    q = r.uniform(0, 1, 4096).astype(np.float32)
    kappa = r.uniform(0.5, 2.5, 4096).astype(np.float32)
    _close(jdist.asymmetric_laplace_ppf(jnp.asarray(q), jnp.asarray(kappa)),
           tdist.asymmetric_laplace_ppf(torch.from_numpy(q),
                                        torch.from_numpy(kappa)).numpy(),
           rtol=1e-6, atol=1e-6)  # absolute near the ppf's zero
    ws = r.uniform(0.5, 15, 4096).astype(np.float32)
    xmax = r.uniform(100, 5e5, 4096).astype(np.float32)
    _close(jdist.cloud_length_seconds_from_u(jnp.asarray(q), jnp.asarray(ws),
                                             jnp.asarray(xmax)),
           tdist.cloud_length_seconds_from_u(
               torch.from_numpy(q), torch.from_numpy(ws),
               torch.from_numpy(xmax)).numpy(), rtol=2e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_markov_chain_window(seed):
    jk, tk = _keys(seed)
    carry = np.random.default_rng(seed).uniform(0, 1, 24).astype(np.float32)
    jv, jc = jax.vmap(lambda k, c: jmh.chain_window(k, 5, 12, c, F32))(
        jk, jnp.asarray(carry))
    tv, tc = tmh.chain_window(tk, 5, 12, torch.from_numpy(carry))
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert np.array_equal(np.asarray(jc), tc.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_renewal(seed):
    r = np.random.default_rng(seed)
    u = r.uniform(0, 1, 2048).astype(np.float32)
    cc = r.uniform(0, 1, 2048).astype(np.float32)
    ws = r.uniform(0.3, 15, 2048).astype(np.float32)
    jc = jren.cycle_from_u(jnp.asarray(u), jnp.asarray(cc), jnp.asarray(ws))
    tc = tren.cycle_from_u(torch.from_numpy(u), torch.from_numpy(cc),
                           torch.from_numpy(ws))
    for a, b in zip(jc, tc):
        _close(a, b.numpy(), rtol=2e-6)
    jk, tk = _keys(seed)
    ji = jax.vmap(lambda k, c, w: jren.init(k, c, w, F32))(
        jk, jnp.asarray(cc[:24]), jnp.asarray(ws[:24]))
    ti = tren.init(tk, torch.from_numpy(cc[:24]), torch.from_numpy(ws[:24]))
    for k in ji:
        _close(ji[k], ti[k].numpy(), rtol=2e-6)
    # the per-second compare/select on identical inputs: exact
    carry = {k: np.array(v) for k, v in ji.items()}
    jn, jcov = jren.step_from_cycle(
        {k: jnp.asarray(v) for k, v in carry.items()},
        jnp.asarray(u[:24] * 900), jnp.asarray(u[:24] * 3000), F32)
    tn, tcov = tren.step_from_cycle(
        {k: torch.from_numpy(v) for k, v in carry.items()},
        torch.from_numpy(u[:24] * 900), torch.from_numpy(u[:24] * 3000))
    for k in jn:
        assert np.array_equal(np.asarray(jn[k]), tn[k].numpy())
    assert np.array_equal(np.asarray(jcov) > 0.5, tcov.numpy())


# --------------------------------------------------------------------------
# clear-sky index windows, streams and the per-second step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_sampler_windows(seed):
    jk, tk = _keys(seed)
    r = np.random.default_rng(seed)
    cc_w = r.uniform(0, 1, (24, 12)).astype(np.float32)
    cc0 = r.uniform(0, 1, 24).astype(np.float32)
    jcl = jax.vmap(lambda k, v, c: jci.cloudy_window(k, 1, 12, v, 1, c, F32))(
        jk, jnp.asarray(cc_w), jnp.asarray(cc0))
    tcl = tci.cloudy_window(tk, 1, 12, torch.from_numpy(cc_w), 1,
                            torch.from_numpy(cc0))
    assert np.array_equal(np.asarray(jcl), tcl.numpy())
    assert np.array_equal(
        np.asarray(jax.vmap(lambda k: jci.clear_day_window(k, 3, 9, F32))(jk)),
        tci.clear_day_window(tk, 3, 9).numpy())
    assert np.array_equal(
        np.asarray(jax.vmap(lambda k: jci.ws_window(k, 2, 4, F32))(jk)),
        tci.ws_window(tk, 2, 4).numpy())
    h_idx = np.sort(r.integers(0, 11, 21)).astype(np.int32)
    h_frac = r.uniform(0, 1, 21).astype(np.float32)
    jm = jax.vmap(lambda k, c: jci.minute_noise_values_device(
        k, c, 17, (jnp.asarray(h_idx), jnp.asarray(h_frac)), F32))(
        jk, jnp.asarray(cc_w))
    tm = tci.minute_noise_values(tk, torch.from_numpy(cc_w), 17,
                                 (torch.from_numpy(h_idx).long(),
                                  torch.from_numpy(h_frac)))
    for k in jm:
        _close(jm[k], tm[k].numpy(), rtol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_per_second_streams(seed):
    """u, z and the meter bit for bit; time-major layout."""
    jk, tk = _keys(seed)
    ju, jz = jci.scan_draws_tmajor(jk, 11 + seed, 3, F32)
    tu, tz = tci.scan_draws_tmajor(tk, 11 + seed, 3)
    assert np.array_equal(np.asarray(ju), tu.numpy())
    assert np.array_equal(np.asarray(jz), tz.numpy())
    jmtr = jci.meter_block_tmajor(jk, 11 + seed, 3, 9000.0, F32)
    assert np.array_equal(np.asarray(jmtr),
                          tci.meter_block_tmajor(tk, 11 + seed, 3,
                                                 9000.0).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_csi_compose_step(seed):
    r = np.random.default_rng(seed)
    n = 64
    tables = {"cc": r.uniform(0, 1, (6, n)), "cloudy": r.uniform(0.2, 1, (6, n)),
              "clear_day": r.uniform(0.8, 1.1, (9, n)),
              "ws": r.uniform(0.5, 10, (4, n)),
              "ml": r.uniform(0.99, 1.01, (20, n)),
              "mc": r.uniform(0.95, 1.05, (20, n))}
    tables = {k: v.astype(np.float32) for k, v in tables.items()}
    carry = {"cloud_end": r.uniform(0, 500, n), "total_end":
             r.uniform(1, 900, n), "sec": r.uniform(0, 900, n)}
    carry = {k: v.astype(np.float32) for k, v in carry.items()}
    jc = {k: jnp.asarray(v) for k, v in carry.items()}
    tcar = {k: torch.from_numpy(v) for k, v in carry.items()}
    for s in range(30):
        x = {"h": 2, "d": 1, "m": 5 + s // 7, "hf": np.float32(s / 31),
             "df": np.float32(0.4 + s / 100), "mf": np.float32((s % 7) / 7),
             "u": r.uniform(0, 1, n).astype(np.float32),
             "z": r.normal(size=n).astype(np.float32)}
        jc, jcsi, jcov = jci.csi_compose_step(
            {k: jnp.asarray(v) for k, v in tables.items()},
            {k: jnp.asarray(v) for k, v in x.items()}, jc, jcfg.ModelOptions(),
            F32)
        tcar, tcsi, tcov = tci.csi_compose_step(
            {k: torch.from_numpy(v) for k, v in tables.items()},
            {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                 else torch.tensor(v)) for k, v in x.items()}, tcar)
        _close(jcsi, tcsi.numpy(), rtol=1e-6, atol=1e-7)
        assert np.array_equal(np.asarray(jcov) > 0.5, tcov.numpy())
        for k in jc:
            _close(jc[k], tcar[k].numpy(), rtol=2e-6)


# --------------------------------------------------------------------------
# PV physics
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_power_from_csi(seed):
    spec = jtg.TimeGridSpec.from_local_start("2019-09-05 00:00:00", 86400,
                                             "Europe/Berlin")
    b = spec.block(0, 86400)
    g64 = jsol.block_geometry(b.epoch.astype(np.float64),
                              b.doy.astype(np.float64), jcfg.Site(), xp=np)
    g = {k: (np.asarray(v, np.float32) if isinstance(v, np.ndarray) else v)
         for k, v in g64.items()}
    csi = np.random.default_rng(seed).uniform(0, 1.3, (4, 86400)).astype(
        np.float32)
    want = np.asarray(jpv.power_from_csi(
        jnp.asarray(csi), {k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                               else v) for k, v in g.items()},
        SAPM_MODULE, SANDIA_INVERTER, xp=jnp), np.float32)
    got = tpv.power_from_csi(
        torch.from_numpy(csi), {k: (torch.from_numpy(v)
                                    if isinstance(v, np.ndarray) else v)
                                for k, v in g.items()}, T_MOD, T_INV).numpy()
    _close(want, got, rtol=2e-5, atol=2e-3)
    assert (want == got).mean() > 0.8


# --------------------------------------------------------------------------
# the SAM database overrides (data/sam.py), read at import time
# --------------------------------------------------------------------------

#: a realistic module row of tests/test_sam.py's synthetic module CSV
#: (its reference-named row is a column-mapping check of small primes)
SAM_MODULE_ROW = "Other Module [2010]"

_SAM_RUN = """
import json, sys
from tmhpvsim_{pkg} import data
out = {{"module": data.SAPM_MODULE, "inverter": data.SANDIA_INVERTER}}
SMALL = dict(start="2019-09-05 10:00:00", duration_s=7200, n_chains=3,
             seed=7, block_s=3600)
if "{pkg}" == "tpu":
    from tmhpvsim_tpu.config import SimConfig
    from tmhpvsim_tpu.engine import Simulation
    sim = Simulation(SimConfig(block_impl="scan", dtype="float32", **SMALL))
else:
    from tmhpvsim_torch.config import SimConfig
    from tmhpvsim_torch.engine.simulation import Simulation
    from tmhpvsim_torch.kernels import block_step
    sim = Simulation(SimConfig(**SMALL), device="cpu")
    c = block_step.kernel_constants()
    out["consts"] = {{"PACO": c["PACO"], "IMPO": c["IMPO"]}}
out["reduced"] = {{k: [float(x) for x in v]
                  for k, v in sim.run_reduced().items()}}
json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def sam_runs(tmp_path_factory):
    """Both packages' coefficients and a small_config reduce run, each in
    its own process with the SAM variables pointing at the synthetic
    CSVs of tests/test_sam.py."""
    import json
    import os
    import subprocess
    import sys

    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_sam_csvs", os.path.join(os.path.dirname(__file__), "test_sam.py"))
    sam = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sam)
    d = tmp_path_factory.mktemp("sam")
    (d / "modules.csv").write_text(sam.MODULE_CSV)
    (d / "inverters.csv").write_text(sam.INVERTER_CSV)
    env = dict(os.environ, TMHPVSIM_SAM_MODULES=str(d / "modules.csv"),
               TMHPVSIM_SAM_INVERTERS=str(d / "inverters.csv"),
               TMHPVSIM_SAM_MODULE_NAME=SAM_MODULE_ROW, JAX_PLATFORMS="cpu")
    out = {}
    for pkg in ("tpu", "torch"):
        r = subprocess.run([sys.executable, "-c", _SAM_RUN.format(pkg=pkg)],
                           capture_output=True, text=True, timeout=600,
                           env=env)
        assert r.returncode == 0, r.stderr[-2000:]
        out[pkg] = json.loads(r.stdout.strip().splitlines()[-1])
    return out


def test_sam_overrides_reach_both_packages(sam_runs):
    from tmhpvsim_torch import data as tdata

    j, t = sam_runs["tpu"], sam_runs["torch"]
    assert t["module"] == j["module"] and t["inverter"] == j["inverter"]
    assert t["module"] != tdata.SAPM_MODULE
    assert t["inverter"]["Paco"] == 3 and t["module"]["Cells_in_Series"] == 60
    # the kernels' generated constants read the overridden rows
    assert t["consts"] == {"PACO": 3.0, "IMPO": 8.2}


def test_sam_override_run_matches_jax(sam_runs):
    want, got = sam_runs["tpu"]["reduced"], sam_runs["torch"]["reduced"]
    assert got["n_seconds"] == want["n_seconds"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-2,
                                   err_msg=k)
    assert max(got["pv_max"]) > 0.0


def test_bad_sam_override_fails_at_import(tmp_path):
    import os
    import subprocess
    import sys

    env = dict(os.environ, TMHPVSIM_SAM_MODULES=str(tmp_path / "none.csv"))
    r = subprocess.run([sys.executable, "-c", "import tmhpvsim_torch.data"],
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode != 0 and "none.csv" in r.stderr
