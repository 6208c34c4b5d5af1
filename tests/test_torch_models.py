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
  2e-5 relative, with the share of bit-exact outputs reported.
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


@pytest.mark.parametrize("cls", ["Site", "ModelOptions", "SimConfig"])
def test_config_fields_and_defaults_match(cls):
    jf = {f.name: f for f in dataclasses.fields(getattr(jcfg, cls))}
    tf = {f.name: f for f in dataclasses.fields(getattr(tcfg, cls))}
    assert list(jf) == list(tf)
    j, t = getattr(jcfg, cls)(), getattr(tcfg, cls)()
    for name in jf:
        jv, tv = getattr(j, name), getattr(t, name)
        if dataclasses.is_dataclass(jv):
            assert dataclasses.astuple(jv) == dataclasses.astuple(tv)
        else:
            assert jv == tv, name


@pytest.mark.parametrize("field,value", [
    ("site_grid", object()), ("fleet", object()), ("telemetry", "light"),
    ("analytics", "risk"), ("compute_dtype", "bf16"),
    ("kernel_impl", "table"), ("geom_stride", 60), ("block_impl", "wide"),
    ("prng_impl", "rbg"), ("output", "ensemble"), ("dtype", "bfloat16"),
    ("tune", "auto"), ("blocks_per_dispatch", 4), ("rng_batch", "block"),
])
def test_config_outside_slice_raises(field, value):
    with pytest.raises(NotImplementedError):
        tcfg.SimConfig(**{field: value})


def test_model_options_outside_slice_raise():
    with pytest.raises(NotImplementedError):
        tcfg.ModelOptions(swap_covered_branches=True)


def test_parameters_match():
    from tmhpvsim_torch import data as tdata
    from tmhpvsim_tpu.data import parameters as jp

    assert tdata.MARKOV_STEP_BINS == jp.MARKOV_STEP_BINS
    assert tdata.MARKOV_STEP_PARAMS == jp.MARKOV_STEP_PARAMS
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
