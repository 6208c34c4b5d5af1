"""``prng_impl='rbg'`` (K13) in the port against the JAX package, on the CPU.

What jax computes for rbg keys, and the port reproduces (tmhpvsim_torch/
rng.py): the bits are Philox4x32-10 with counter ``(w2, w3, w0, w1)`` and
key ``(w0, w1)``, a 128-bit counter that carries; 8- and 16-bit draws are
the low bits of the same words; ``split`` / ``fold_in`` run threefry on
each 2-word half; under ``vmap`` a batch draws from its FIRST key; gamma
draws per key.  Each is held bit for bit at the key and bit level, at the
draw sites of the model modules, and through the engine: the reduce
statistics of the scan, scan2 and wide formulations (each against its own
JAX formulation, ``block_impl`` pinned on both sides), the ensemble
series and the trace, a fleet, at the engine tolerance (``n_seconds``
exact, the rest rtol 2e-5 / atol 1e-2, tests/test_engine.py:139-150).

The key-, bit- and model-level checks run jax in x32 (the suite's x64
moves part of jax's arithmetic to float64; the port computes float32
throughout), the engine checks in the suite's x64 at the engine
tolerance.

Under rbg the formulations draw different values (a chain's draws depend
on its batch and on the layout), in the JAX package as in the port; the
strict gate refuses rbg and a plain run warns, in both.  The ``rbg``
section of tests/data/torch_port_reference.json holds the JAX results the
card's reference phase checks.
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmhpvsim_torch import config as tcfg
from tmhpvsim_torch import rng
from tmhpvsim_torch.engine import convert
from tmhpvsim_torch.engine.simulation import Simulation as TSim
from tmhpvsim_torch.fleet import FleetParams as TFleet
from tmhpvsim_torch.models import clearsky_index as tci
from tmhpvsim_torch.models import markov_hourly as tmh
from tmhpvsim_torch.models import renewal as tren
from tmhpvsim_tpu import config as jcfg
from tmhpvsim_tpu.engine import Simulation as JSim
from tmhpvsim_tpu.fleet import FleetParams as JFleet
from tmhpvsim_tpu.models import clearsky_index as jci
from tmhpvsim_tpu.models import markov_hourly as jmh
from tmhpvsim_tpu.models import renewal as jren

F32 = jnp.float32
#: key data with counters that carry: w2 into w3, w3 into w0
KEY_DATA = ([11, 22, 33, 44], [0, 7, 0, 7], [5, 6, 0xFFFFFFFE, 9],
            [1, 2, 0xFFFFFFFE, 0xFFFFFFFF], [5, 6, 0xFFFFFFFF, 0xFFFFFFFF])
SMALL = dict(start="2019-09-05 10:00:00", duration_s=7200, n_chains=3,
             seed=7, block_s=3600)
REF = os.path.join(os.path.dirname(__file__), "data",
                   "torch_port_reference.json")
#: the formulations whose draw layouts differ under rbg: (block_impl,
#: rng_batch)
FORMS = {"scan": ("scan", "scan"), "scan2": ("scan2", "scan"),
         "scan2_block": ("scan2", "block"), "wide": ("wide", "scan")}
#: seconds of chain 0's rbg trace the reference file keeps
TRACE_S = 900


@pytest.fixture
def x32():
    with jax.enable_x64(False):
        yield


def _jkey(data):
    return jax.random.wrap_key_data(jnp.asarray(data, jnp.uint32),
                                    impl="rbg")


def _kd(keys):
    """jax keys -> the port's int64 key data."""
    return torch.from_numpy(
        np.asarray(jax.random.key_data(keys)).astype(np.int64))


def _keys(seed, n):
    jk = jax.random.split(jax.random.key(seed, impl="rbg"), n)
    return jk, _kd(jk)


# --------------------------------------------------------------------------
# keys and bits
# --------------------------------------------------------------------------


@pytest.mark.parametrize("width", [32, 16, 8])
@pytest.mark.parametrize("shape", [(), (7,), (3, 5), (2, 3, 60)])
@pytest.mark.parametrize("data", KEY_DATA)
def test_philox_bits_bit_exact(x32, data, shape, width):
    want = np.asarray(jax.random.bits(
        _jkey(data), shape, getattr(jnp, f"uint{width}"))).astype(np.int64)
    got = rng.rbg_bits(torch.tensor(data, dtype=torch.int64), shape, width)
    assert np.array_equal(want, got.numpy())


def test_philox_block_function(x32):
    """rng.philox4x32_10 is the counter-mode function jax's stream is made
    of: words 4q .. 4q+3 are its output at counter (w2, w3, w0, w1) + q."""
    data = KEY_DATA[0]
    w = [torch.tensor(v, dtype=torch.int64) for v in data]
    stream = np.asarray(jax.random.bits(_jkey(data), (8,), jnp.uint32))
    out = rng.philox4x32_10(w[2] + 1, w[3], w[0], w[1], w[0], w[1])
    assert [int(v) for v in out] == stream[4:].tolist()


@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3])
def test_rbg_key_from_seed(seed):
    want = np.asarray(jax.random.key_data(jax.random.key(seed, impl="rbg")))
    assert np.array_equal(want, rng.rbg_key(seed).numpy())
    assert torch.equal(rng.root_key(seed, "rbg"), rng.rbg_key(seed))


@pytest.mark.parametrize("data", KEY_DATA[:3])
def test_split_and_fold_in_exact(x32, data):
    k = _jkey(data)
    t = torch.tensor(data, dtype=torch.int64)
    assert torch.equal(_kd(jax.random.split(k, 5)), rng.split(t, 5))
    for d in (0, 1, 123456, 2 ** 32 - 1):
        assert torch.equal(_kd(jax.random.fold_in(k, d)), rng.fold_in(t, d))
    ks = jax.random.split(k, 4)
    idx = jnp.arange(6)
    want = jax.vmap(lambda kk: jax.vmap(
        lambda i: jax.random.fold_in(kk, i))(idx))(ks)
    got = rng.fold_in(_kd(ks)[:, None, :], torch.arange(6))
    assert torch.equal(_kd(want), got)


def test_batched_draw_takes_the_first_key(x32):
    """jax's batching rule (finding 3): a vmapped draw of 3 keys is the
    (3, 5) block of the first key's stream, not three streams."""
    jk, tk = _keys(3, 3)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.bits(k, (5,), jnp.uint32))(jk))
    assert np.array_equal(want, np.asarray(
        jax.random.bits(jk[0], (3, 5), jnp.uint32)))
    per_key = np.stack([np.asarray(jax.random.bits(k, (5,), jnp.uint32))
                        for k in jk])
    assert np.array_equal(want[0], per_key[0])
    assert not np.array_equal(want[1:], per_key[1:])
    assert np.array_equal(want, rng.random_bits(tk, (5,)).numpy())
    assert np.array_equal(per_key,
                          rng.random_bits(tk, (5,), per_key=True).numpy())


def test_two_vmap_levels(x32):
    """Nested vmaps draw the (outer, inner, shape) block of the first key
    of the first row."""
    jk, _ = _keys(4, 3)
    ks2 = jax.vmap(lambda k: jax.random.split(k, 4))(jk)       # (3, 4)
    want = jax.vmap(jax.vmap(
        lambda k: jax.random.bits(k, (6,), jnp.uint32)))(ks2)
    got = rng.random_bits(_kd(ks2), (6,))
    assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())


@pytest.mark.parametrize("kind", ["uniform", "uniform_bf16", "normal",
                                  "normal_bf16", "gamma", "t"])
def test_draws_exact(x32, kind):
    jk, tk = _keys(11, 8)
    ks2 = jax.vmap(lambda k: jax.random.split(k, 3))(jk)
    if kind.startswith(("uniform", "normal")):
        name, _, bf = kind.partition("_")
        jd, td = (jnp.bfloat16, torch.bfloat16) if bf else (F32,
                                                           torch.float32)
        want = jax.vmap(jax.vmap(lambda k: getattr(jax.random, name)(
            k, (4,), jd)))(ks2)
        got = getattr(rng, name)(_kd(ks2), (4,), dtype=td)
        assert np.array_equal(np.asarray(want).astype(np.float32),
                              got.float().numpy())
    elif kind == "gamma":
        for a in (2.69, 5.0, 3.5624):
            want = jax.vmap(lambda k: jax.random.gamma(
                k, np.float32(a), (), F32))(jk)
            got = rng.gamma(tk, torch.tensor(a, dtype=torch.float32))
            assert np.array_equal(np.asarray(want), got.numpy())
    else:
        df = np.float32(11.150488007085713)
        want = jax.vmap(lambda k: jax.random.t(k, df, (), F32))(jk)
        assert np.array_equal(np.asarray(want),
                              rng.t(tk, torch.tensor(df)).numpy())


# --------------------------------------------------------------------------
# the models' draw sites
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_markov_chain_window(x32, seed):
    jk, tk = _keys(seed, 5)
    state = jnp.linspace(0.1, 0.9, 5, dtype=F32)
    want, wfin = jax.vmap(lambda k, s: jmh.chain_window(k, 40, 6, s))(
        jk, state)
    got, gfin = tmh.chain_window(tk, 40, 6, torch.tensor(np.asarray(state)))
    assert np.array_equal(np.asarray(want), got.numpy())
    assert np.array_equal(np.asarray(wfin), gfin.numpy())


def test_window_functions(x32):
    """cloudy, clear-day, windspeed and minute-noise windows, vmapped over
    chains (two vmap levels) as _windows_one_chain calls them."""
    jk, tk = _keys(5, 4)
    cc = jnp.linspace(0.05, 0.99, 4 * 9, dtype=F32).reshape(4, 9)
    cc0 = jnp.asarray([0.3, 0.8, 0.95, 0.5], F32)
    want = jax.vmap(lambda k, c, c0: jci.cloudy_window(k, 3, 7, c, 3, c0))(
        jk, cc, cc0)
    got = tci.cloudy_window(tk, 3, 7, torch.tensor(np.asarray(cc)),
                            3, torch.tensor(np.asarray(cc0)))
    assert np.array_equal(np.asarray(want), got.numpy())
    want = jax.vmap(lambda k: jci.clear_day_window(k, 12, 9))(jk)
    assert np.array_equal(np.asarray(want),
                          tci.clear_day_window(tk, 12, 9).numpy())
    want = jax.vmap(lambda k: jci.ws_window(k, 2, 3))(jk)
    assert np.array_equal(np.asarray(want), tci.ws_window(tk, 2, 3).numpy())
    h_idx = np.arange(10, dtype=np.int32) // 4
    h_frac = np.linspace(0, 0.9, 10).astype(np.float32)
    want = jax.vmap(lambda k, c: jci.minute_noise_values_device(
        k, c, 600, (jnp.asarray(h_idx), jnp.asarray(h_frac))))(jk, cc)
    got = tci.minute_noise_values(tk, torch.tensor(np.asarray(cc)), 600, (
        torch.tensor(h_idx).long(), torch.tensor(h_frac)))
    for k in want:
        assert np.array_equal(np.asarray(want[k]), got[k].numpy()), k


def test_renewal_init(x32):
    """renewal.init's two batched uniforms bit for bit; the carry they
    give to the power law's libm tolerance (rtol 2e-6, as
    tests/test_torch_models.py holds the threefry init)."""
    jk, tk = _keys(9, 6)
    for j in (0, 1):
        want = jax.vmap(lambda k: jax.random.uniform(
            jax.random.split(k)[j], (), F32))(jk)
        got = rng.uniform(rng.split(tk, 2)[:, j, :], ())
        assert np.array_equal(np.asarray(want), got.numpy())
    cc = jnp.linspace(0.1, 0.9, 6, dtype=F32)
    ws = jnp.linspace(1.0, 6.0, 6, dtype=F32)
    want = jax.vmap(lambda k, c, w: jren.init(k, c, w, F32))(jk, cc, ws)
    got = tren.init(tk, torch.tensor(np.asarray(cc)),
                    torch.tensor(np.asarray(ws)))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-6, err_msg=k)


def _jax_layout(layout, keys, g0, n_groups, dtype, meter):
    """The JAX formulation's per-second draws of a block, time-major."""
    n = keys.shape[0]
    if layout == "scan":
        if meter:
            return jci.meter_block_tmajor(keys, g0, n_groups, 1.0, dtype)
        return jci.scan_draws_tmajor(keys, g0, n_groups, dtype)
    if layout == "trace":
        t = g0 * 60 + jnp.arange(n_groups * 60)
        if meter:
            return jax.vmap(lambda k: jci.meter_block(k, t, 1.0, dtype))(
                keys).T
        u, z = jax.vmap(lambda k: jci.block_draws(k, t, dtype))(keys)
        return u.T, z.T

    def minute(g):   # the scan2 outer body's draws (simulation.py:1622)
        if meter:
            return jax.vmap(lambda k: jax.random.uniform(
                jax.random.fold_in(k, g), (60,), dtype), out_axes=1)(keys)

        def draws(k):
            kg = jax.random.fold_in(k, g)
            return (jax.random.uniform(jax.random.fold_in(kg, 0), (60,),
                                       dtype),
                    jax.random.normal(jax.random.fold_in(kg, 1), (60,),
                                      dtype))
        return jax.vmap(draws, out_axes=1)(keys)

    tiles = [minute(g0 + j) for j in range(n_groups)]
    if meter:
        return jnp.concatenate(tiles).reshape(-1, n)
    return tuple(jnp.concatenate([t[i] for t in tiles]).reshape(-1, n)
                 for i in range(2))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("layout", tci.DRAW_LAYOUTS)
def test_block_draw_layouts(x32, layout, dtype):
    jk, tk = _keys(13, 5)
    jd, td = (F32, torch.float32) if dtype == "f32" else (jnp.bfloat16,
                                                           torch.bfloat16)
    ju, jz = _jax_layout(layout, jk, 21, 3, jd, meter=False)
    tu, tz = tci.scan_draws_tmajor(tk, 21, 3, td, layout)
    assert np.array_equal(np.asarray(ju).astype(np.float32),
                          tu.float().numpy())
    assert np.array_equal(np.asarray(jz).astype(np.float32),
                          tz.float().numpy())
    jm = _jax_layout(layout, jk, 21, 3, F32, meter=True)
    assert np.array_equal(np.asarray(jm),
                          tci.meter_block_tmajor(tk, 21, 3, 1.0,
                                                 layout).numpy())


def test_layouts_differ_under_rbg_not_threefry():
    """Finding 3 in the port: the three layouts give three streams under
    rbg and one under threefry."""
    _, tk = _keys(13, 5)
    draws = [tci.scan_draws_tmajor(tk, 21, 3, layout=lay)[0]
             for lay in tci.DRAW_LAYOUTS]
    assert not torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    tf = rng.split(rng.key(13), 5)
    same = [tci.scan_draws_tmajor(tf, 21, 3, layout=lay)[0]
            for lay in tci.DRAW_LAYOUTS]
    assert torch.equal(same[0], same[1]) and torch.equal(same[0], same[2])


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------


def _jax_sim(impl="scan", rng_batch="scan", **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return JSim(jcfg.SimConfig(
            block_impl=impl, rng_batch=rng_batch, dtype="float32",
            prng_impl="rbg", scan_unroll=1, **dict(SMALL, **kw)))


def _port_sim(impl="scan", rng_batch="scan", **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return TSim(tcfg.SimConfig(block_impl=impl, rng_batch=rng_batch,
                                   prng_impl="rbg", **dict(SMALL, **kw)),
                    device="cpu")


def _close(want, got):
    np.testing.assert_array_equal(got["n_seconds"], want["n_seconds"])
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=2e-5,
                                   atol=1e-2, err_msg=k)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's rbg runs at ``SMALL``: every formulation's reduce
    statistics, the scan ensemble and the trace."""
    out = {name: _jax_sim(*form).run_reduced()
           for name, form in FORMS.items()}
    out["ensemble"] = list(_jax_sim().run_ensemble())
    out["trace"] = list(_jax_sim().run_blocks())
    return out


@pytest.mark.parametrize("form", list(FORMS))
def test_reduce_matches_jax_formulation(jax_runs, form):
    _close(jax_runs[form], _port_sim(*FORMS[form]).run_reduced())


def test_formulations_differ_under_rbg(jax_runs):
    """Under rbg the JAX formulations are different runs (finding 3):
    the port's scan and wide runs differ as the JAX ones do."""
    assert not np.array_equal(np.asarray(jax_runs["scan"]["pv_sum"]),
                              np.asarray(jax_runs["wide"]["pv_sum"]))
    np.testing.assert_array_equal(
        np.asarray(jax_runs["scan"]["pv_sum"]),
        np.asarray(jax_runs["scan2_block"]["pv_sum"]))


def test_ensemble_matches_jax(jax_runs):
    got = list(_port_sim().run_ensemble())
    assert len(got) == len(jax_runs["ensemble"])
    for w, g in zip(jax_runs["ensemble"], got):
        for k in ("meter", "pv", "residual"):
            np.testing.assert_allclose(getattr(g, k),
                                       np.asarray(getattr(w, k)),
                                       rtol=2e-5, atol=1e-2, err_msg=k)


def test_trace_matches_jax(jax_runs):
    got = list(_port_sim().run_blocks())
    for w, g in zip(jax_runs["trace"], got):
        np.testing.assert_array_equal(g.epoch, np.asarray(w.epoch))
        for k in ("meter", "pv", "residual"):
            np.testing.assert_allclose(getattr(g, k),
                                       np.asarray(getattr(w, k)),
                                       rtol=2e-5, atol=1e-2, err_msg=k)


def test_init_state_matches_jax():
    """The chain state a run starts from, keys bit for bit (the 4-word key
    data crosses over through engine/convert.py in both directions)."""
    js, ts = _jax_sim(), _port_sim()
    want = {k: np.asarray(jax.random.key_data(v) if k.startswith("k_")
                          else v) if k != "carry" else v
            for k, v in js.init_state().items()}
    got = convert.state_to_numpy(ts.init_state())
    for k in convert.KEY_LEAVES:
        assert got[k].shape == (3, 4)
        assert np.array_equal(got[k], want[k]), k
    for k in convert.FLOAT_LEAVES:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-6, err_msg=k)
    back = convert.state_from_numpy(got, "cpu")
    assert back["k_scan"].shape == (3, 4)
    assert torch.equal(back["k_scan"], ts.init_state()["k_scan"])


def test_fleet_matches_jax():
    """A heterogeneous fleet (weather regimes, transforms) under rbg."""
    want = _jax_sim(fleet=JFleet.synthetic(6, seed=3)).run_reduced()
    got = _port_sim(fleet=TFleet.synthetic(6, seed=3)).run_reduced()
    _close(want, got)


def test_strict_refuses_and_plain_run_warns():
    """As in the JAX package (engine/simulation.py:292-305): rbg warns at
    build and raises under ``telemetry_strict`` (bf16 included)."""
    for strict_kw in (dict(telemetry_strict=True),
                      dict(telemetry_strict=True, compute_dtype="bf16")):
        with pytest.raises(ValueError, match="rbg"):
            JSim(jcfg.SimConfig(prng_impl="rbg", **strict_kw))
        with pytest.raises(ValueError, match="rbg"):
            TSim(tcfg.SimConfig(prng_impl="rbg", **strict_kw),
                 device="cpu")
    with pytest.warns(RuntimeWarning, match="rbg"):
        sim = TSim(tcfg.SimConfig(prng_impl="rbg", compute_dtype="bf16"),
                   device="cpu")
    assert sim.plan.prng_impl == "rbg" and sim.plan.telemetry == "light"
    assert tcfg.resolve_plan(tcfg.SimConfig()).prng_impl == "threefry2x32"


def test_cli_prng_impl_rbg(tmp_path):
    """``pvsim --prng-impl rbg`` through the entry point gives the rbg
    run's statistics."""
    from tmhpvsim_torch.cli import main

    out = str(tmp_path / "r.csv")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert main(["pvsim", out, "--output", "reduce", "--no-realtime",
                     "--chains", "3", "--duration", "7200", "--block-s",
                     "3600", "--seed", "7", "--start", SMALL["start"],
                     "--prng-impl", "rbg", "--device", "cpu"]) == 0
    rows = np.genfromtxt(out, delimiter=",", names=True)
    want = _port_sim().run_reduced()
    np.testing.assert_array_equal(rows["pv_sum"][:3].astype(np.float32),
                                  want["pv_sum"])


def test_reference_section_tracks_jax(jax_runs):
    """The ``rbg`` section of the reference file: the JAX rbg results at
    ``SMALL`` for chip_smoke.py's reference phase (each formulation's
    reduce statistics and chain 0's trace over the first ``TRACE_S``
    seconds, from 10:00); written
    when missing, it must equal what the JAX package computes."""
    sec = {"config": SMALL,
           "reduced": {name: {k: np.asarray(v).tolist()
                              for k, v in jax_runs[name].items()}
                       for name in FORMS},
           "forms": {k: list(v) for k, v in FORMS.items()},
           "trace": {"chain": 0, **{k: [float(np.format_float_positional(
               x, unique=True, trim="-")) for x in np.asarray(
               getattr(jax_runs["trace"][0], k), np.float32)[0, :TRACE_S]]
               for k in ("meter", "pv")}}}
    with open(REF) as f:
        doc = json.load(f)
    if "rbg" not in doc:
        doc["rbg"] = sec
        with open(REF, "w") as f:
            json.dump(doc, f, separators=(",", ":"))
    assert os.path.getsize(REF) < 300_000
    with open(REF) as f:
        assert json.load(f)["rbg"] == json.loads(json.dumps(sec))
