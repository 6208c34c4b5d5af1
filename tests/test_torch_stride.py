"""K6s (strided site geometry) and the two precision levers
(``geom_stride``, ``kernel_impl``) end to end: the port against the JAX
package, on the CPU.

Tolerances.  The host's float64 ``strided_block_geometry`` and its numpy
``interp_sampled`` are bit-identical to the JAX package's (the same numpy
operations); the float32 lerp of the device path is bit-identical to the
JAX scan's, which lerps each second's (n,) fields with a scalar fraction
(both ``fma(lo, 1 - f, hi * f)``: float32 XLA contracts the first
product there; lerping whole (T, n) arrays at once, as the JAX package's
wide trace step does, XLA contracts either product depending on the
vectorised loop, which the engine tolerance below covers).  The engine
with both levers (``geom_stride=60``, ``kernel_impl='table'``) is held to
the bound the JAX package holds its own formulations to
(tests/test_engine.py): ``n_seconds`` and the time axis exact, every
other statistic and per-second value rtol 2e-5 / atol 1e-2.  Within the
port, ``geom_stride=1`` is the default run bit for bit.
"""

import dataclasses
import datetime as dt
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmhpvsim_torch import config as tcfg
from tmhpvsim_torch.engine.simulation import Simulation as TSim
from tmhpvsim_torch.fleet import FleetParams as TFleet
from tmhpvsim_torch.models import solar as tsolar
from tmhpvsim_tpu import config as jcfg
from tmhpvsim_tpu.engine import Simulation as JSim
from tmhpvsim_tpu.fleet import FleetParams as JFleet
from tmhpvsim_tpu.models import solar as jsolar

SMALL = dict(start="2019-09-05 10:00:00", duration_s=7200, n_chains=3,
             seed=7, block_s=3600)
LEVERS = dict(kernel_impl="table", geom_stride=60)
#: the 4-site grid of tests/test_geom_stride.py (equator to 70 N)
GRID4 = dict(latitude=(0.0, 48.12, 52.5, 70.0),
             longitude=(11.6, 11.6, 13.4, 20.0),
             altitude=(10.0, 520.0, 34.0, 5.0),
             surface_tilt=(10.0, 30.0, 35.0, 60.0),
             surface_azimuth=(180.0, 180.0, 175.0, 180.0))
#: the 12-site synthetic fleet of tests/test_torch_engine.py
FLEET = (12, 3)
OUTPUTS = ("reduce", "ensemble", "trace")
TOL = dict(rtol=2e-5, atol=1e-2)


def _geo_kw(pkg, geo):
    if geo == "grid":
        return {"site_grid": pkg.SiteGrid(**GRID4)}
    if geo == "fleet":
        fleet = JFleet if pkg is jcfg else TFleet
        return {"fleet": fleet.synthetic(FLEET[0], seed=FLEET[1])}
    return {}


def _run(sim, output):
    if output == "reduce":
        return sim.run_reduced()
    runner = sim.run_ensemble if output == "ensemble" else sim.run_blocks
    return list(runner())


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's runs with both levers, each made once (at
    scan_unroll 1: the unroll changes compile time, not the values)."""
    cache = {}

    def get(geo, output):
        if (geo, output) not in cache:
            cfg = jcfg.SimConfig(block_impl="scan", dtype="float32",
                                 scan_unroll=1, output=output,
                                 **dict(SMALL, **LEVERS,
                                        **_geo_kw(jcfg, geo)))
            cache[geo, output] = _run(JSim(cfg), output)
        return cache[geo, output]

    return get


def _port(geo, output, **kw):
    cfg = tcfg.SimConfig(output=output, **dict(SMALL, **LEVERS,
                                               **_geo_kw(tcfg, geo), **kw))
    return TSim(cfg, device="cpu")


def check_levers(jax_runs, geo, output):
    """The port's run with both levers against the JAX package's."""
    want = jax_runs(geo, output)
    got = _run(_port(geo, output), output)
    if output == "reduce":
        np.testing.assert_array_equal(got["n_seconds"], want["n_seconds"])
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.epoch, np.asarray(w.epoch))
        for k in ("meter", "pv", "residual"):
            # trace: chain 0 (the CSV's); ensemble: the fleet mean
            np.testing.assert_allclose(getattr(g, k)[0],
                                       np.asarray(getattr(w, k))[0],
                                       err_msg=k, **TOL)
    assert float(np.max([np.max(g.pv) for g in got])) > 10.0


# the fleet's cases are tests/test_torch_stride_fleet.py's (a file of their
# own, so that a worker of a run split by file takes them apart from these)
@pytest.mark.parametrize("output", OUTPUTS)
@pytest.mark.parametrize("geo", ("shared", "grid"))
def test_levers_match_jax(jax_runs, geo, output):
    check_levers(jax_runs, geo, output)


@pytest.mark.parametrize("geo", ("shared", "grid"))
def test_stride1_is_the_default_bit_for_bit(geo):
    kw = dict(SMALL, output="reduce", **_geo_kw(tcfg, geo))
    base = TSim(tcfg.SimConfig(**kw), device="cpu")
    one = TSim(tcfg.SimConfig(geom_stride=1, **kw), device="cpu")
    hb, h1 = base.host_arrays(1), one.host_arrays(1)
    assert np.array_equal(hb.rows_f, h1.rows_f)
    assert np.array_equal(hb.rows_i, h1.rows_i)
    want, got = base.run_reduced(), one.run_reduced()
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert one.precision_doc() is None and base.plan == one.plan


def _day_seam(stride):
    """An hour across a UTC-midnight (and year) seam: epochs and the UTC
    day of year of each second, float64."""
    t0 = dt.datetime(2019, 12, 31, 23, 30, tzinfo=dt.timezone.utc)
    epoch = int(t0.timestamp()) + np.arange(3600)
    doy = np.asarray([dt.datetime.fromtimestamp(int(e), dt.timezone.utc)
                      .timetuple().tm_yday for e in epoch], np.float64)
    return epoch.astype(np.float64), doy


@pytest.mark.parametrize("stride", (30, 60))
def test_strided_block_geometry_bit_identical(stride):
    epoch, doy = _day_seam(stride)
    want = jsolar.strided_block_geometry(epoch, doy, jcfg.Site(), stride,
                                         xp=np)
    got = tsolar.strided_block_geometry(epoch, doy, tcfg.Site(), stride)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w),
                                      err_msg=k)
    # the endpoint sample is the next second, its doy the block's last
    ep_s, doy_s = tsolar.stride_samples(epoch, doy, stride)
    assert ep_s[-1] == epoch[-1] + 1 and doy_s[-1] == doy[-1] == 1.0
    assert doy_s[0] == 365.0


def test_strided_constants_equal_jax():
    assert tsolar.STRIDE_LERP_FIELDS == jsolar.STRIDE_LERP_FIELDS
    assert tsolar.STRIDE_MAX_ABS_ERR == jsolar.STRIDE_MAX_ABS_ERR
    assert tsolar.STRIDES == jsolar.STRIDES


def _sampled(S=19, n=5, seed=0):
    gen = np.random.default_rng(seed)
    return {k: gen.uniform(-3.0, 300.0, (S, n)).astype(np.float32)
            for k in tsolar.STRIDE_LERP_FIELDS}


def test_interp_sampled_matches_jax():
    T, s = 1080, 60
    i, f = tsolar.stride_weights(T, s)
    # the host's numpy float64 lerp
    g64 = {k: v.astype(np.float64) for k, v in _sampled().items()}
    want = jsolar.interp_sampled(g64, i, f, xp=np)
    got = tsolar.interp_sampled(g64, i, f)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the device path's float32 lerp, against the JAX scan's: one second
    # per step, a scalar fraction against the (n,) fields
    g32 = _sampled(n=64, seed=1)
    f32 = f.astype(np.float32)

    def scan(g, i, f):
        return jax.lax.scan(
            lambda c, x: (c, jsolar.interp_sampled(g, x[0], x[1], xp=jnp)),
            0, (i, f))[1]

    with jax.enable_x64(False):
        want = jax.jit(scan)(g32, i, f32)
    got = tsolar.interp_sampled({k: torch.from_numpy(v)
                                 for k, v in g32.items()},
                                torch.from_numpy(i).long(),
                                torch.from_numpy(f32))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy().view(np.int32),
                                      np.asarray(want[k]).view(np.int32),
                                      err_msg=k)


def test_bad_stride_rejected_as_jax():
    with pytest.raises(ValueError, match="geom_stride") as jerr:
        JSim(jcfg.SimConfig(**dict(SMALL, geom_stride=45)))
    with pytest.raises(ValueError, match="geom_stride") as terr:
        TSim(tcfg.SimConfig(**dict(SMALL, geom_stride=45)), device="cpu")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="kernel_impl") as jerr:
        JSim(jcfg.SimConfig(**dict(SMALL, kernel_impl="fast")))
    with pytest.raises(ValueError, match="kernel_impl") as terr:
        TSim(tcfg.SimConfig(**dict(SMALL, kernel_impl="fast")), device="cpu")
    assert str(terr.value) == str(jerr.value)
    # the host path's checks: a stride outside STRIDES, one that does not
    # divide the block
    epoch, doy = _day_seam(60)
    for stride, n, match in ((45, 3600, "geom_stride"), (60, 90, "multiple")):
        with pytest.raises(ValueError, match=match) as jerr:
            jsolar.strided_block_geometry(epoch[:n], doy[:n], jcfg.Site(),
                                          stride, xp=np)
        with pytest.raises(ValueError, match=match) as terr:
            tsolar.strided_block_geometry(epoch[:n], doy[:n], tcfg.Site(),
                                          stride)
        assert str(terr.value) == str(jerr.value)


def test_plan_and_precision_doc_as_jax():
    kw = dict(SMALL, **LEVERS, site_grid=tcfg.SiteGrid(**GRID4))
    t = TSim(tcfg.SimConfig(**kw), device="cpu")
    j = JSim(jcfg.SimConfig(**dict(kw, site_grid=jcfg.SiteGrid(**GRID4))))
    assert (t.plan.kernel_impl, t.plan.geom_stride) == \
        (j.plan.kernel_impl, j.plan.geom_stride) == ("table", 60)
    td, jd = t.precision_doc(), j.precision_doc()
    assert set(td) == set(jd)
    for k in ("compute_dtype", "kernel_impl", "rng_batch", "geom_stride",
              "telemetry"):
        assert td[k] == jd[k], k
    assert TSim(tcfg.SimConfig(**SMALL), device="cpu").precision_doc() \
        is None


def test_cli_levers(tmp_path):
    """--kernel-impl and --geom-stride on pvsim: the CSV of the library
    run with the same levers, and the report's precision section."""
    from tmhpvsim_torch.apps.pvsim import write_reduced_csv
    from tmhpvsim_torch.cli import main

    out, rep = str(tmp_path / "r.csv"), str(tmp_path / "r.json")
    argv = ["pvsim", out, "--output", "reduce", "--no-realtime",
            "--site-grid", "46:50:2,9:13:2", "--duration", "3600",
            "--seed", "7", "--start", SMALL["start"], "--device", "cpu",
            "--geom-stride", "60", "--kernel-impl", "table",
            "--run-report", rep]
    assert main(argv) == 0
    sim = TSim(tcfg.SimConfig(
        site_grid=tcfg.SiteGrid.regular((46, 50), (9, 13), 2, 2), seed=7,
        start=SMALL["start"], duration_s=3600, block_s=3600,
        output="reduce", **LEVERS), device="cpu")
    want = str(tmp_path / "w.csv")
    write_reduced_csv(want, sim.run_reduced(), sim.ensemble_stats())
    assert open(out).read() == open(want).read()
    with open(rep) as f:
        prec = json.load(f)["precision"]
    assert (prec["kernel_impl"], prec["geom_stride"]) == ("table", 60)
    for flag, bad in (("--geom-stride", "45"), ("--kernel-impl", "fast")):
        with pytest.raises(SystemExit) as e:
            main(["pvsim", out, "--duration", "60", "--device", "cpu",
                  flag, bad])
        assert e.value.code == 2


def test_strided_plain_geometry_is_the_lerped_sample_grid():
    """The block step's plain strided geometry is device_geometry on the
    sample rows, lerped per second with the second's own doy."""
    from tmhpvsim_torch.kernels import block_step as k3
    from tmhpvsim_torch.models import tables as tt

    sim = _port("grid", "reduce")
    h = sim.host_arrays(0)
    state = sim.init_state()
    _, _, site = sim.geometry_args(state)
    assert site.stride == 60 and site.mode == "strided"
    assert h.rows_f.shape == (len(k3.ROWS_F_STRIDE), SMALL["block_s"])
    rows = torch.from_numpy(h.rows_f)
    g = k3._geometry(rows, None, None, site, "table")
    S = SMALL["block_s"] // 60 + 1
    samp = tsolar.device_geometry(
        rows[4, :S, None], rows[5, :S, None], rows[6, :S, None],
        *(site.site[f] for f in tcfg.SITE_FIELDS), site.turbidity,
        tt.table_kernels())
    for j in (0, 1, S - 1):  # each sample second lerps to its sample
        s = min(j * 60, SMALL["block_s"] - 1)
        if s % 60 == 0:
            for k in tsolar.STRIDE_LERP_FIELDS:
                assert torch.equal(g[k][s], samp[k][j]), k
    assert torch.equal(g["doy"][:, 0], rows[3])
    assert dataclasses.asdict(sim.plan) == {
        "kernel_impl": "table", "geom_stride": 60, "block_impl": "scan",
        "stats_fusion": "fused", "scan_unroll": 8, "blocks_per_dispatch": 1,
        "rng_batch": "scan", "compute_dtype": "f32", "telemetry": "off",
        "prng_impl": "threefry2x32", "slab_chains": 4}


def test_scenario_engine_serves_with_levers():
    """A served simulation with both levers (K10 shares the block-step
    template): the neutral scenario's reply is the run's own reduce
    statistics, bit for bit."""
    from tmhpvsim_torch.serve import schema
    from tmhpvsim_torch.serve.server import ScenarioEngine

    cfg = tcfg.SimConfig(**dict(SMALL, **LEVERS, output="reduce",
                                site_grid=tcfg.SiteGrid(**GRID4)))
    eng = ScenarioEngine(cfg, (1,), device="cpu")
    req = schema.Request(id="n", reply_to="r", mode="reduce",
                         scenario=schema.Scenario(
                             horizon_s=SMALL["duration_s"]))
    stats = eng.run([req])[0]["stats"]
    red = TSim(cfg, device="cpu").run_reduced()
    assert stats["n_seconds"] == int(red["n_seconds"].sum())
    for name, key in (("pv_sum", "pv_sum_w"), ("meter_sum", "meter_sum_w"),
                      ("residual_sum", "residual_sum_w")):
        assert stats[key] == float(red[name].astype(np.float64).sum())
    assert stats["pv_max_w"] == float(red["pv_max"].max())
