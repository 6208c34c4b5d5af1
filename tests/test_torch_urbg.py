"""``prng_impl='unsafe_rbg'`` (K14) in the port against the JAX package, on
the CPU.

What jax computes for unsafe_rbg keys (jax/_src/prng.py
``_unsafe_rbg_split`` / ``_unsafe_rbg_fold_in``), and the port reproduces
(tmhpvsim_torch/rng.py): the key data and the bits are rbg's, but
``split(k, n)[i]`` is Philox counter ``10 i`` of ``k``'s stream and
``fold_in(k, d)`` is ``k ^`` counter 9 of the stream of ``[0, d, 0, d]``.
Under ``vmap`` those draws take their batch's first key (or datum), member
``p`` at its offset, so each call site's vmap nesting decides a chain's
keys; jax's gamma splits its flattened keys batched before its serial
loop, so a vmapped gamma differs from a looped one.  Each is held bit for
bit at the key level, at every call site's nesting, through the model
windows and the block draw layouts, and through the engine: the initial
keys (also under ``chain_offset``), each formulation's reduce statistics,
the ensemble series, chain 0's trace, a 12-site fleet and the float32 and
bf16 scenario replies, at the engine tolerance (``n_seconds`` exact, the
rest rtol 2e-5 / atol 1e-2, tests/test_engine.py:139-150).

The key-, bit- and model-level checks run jax in x32, the engine checks in
the suite's x64 at the engine tolerance.  The ``unsafe_rbg`` section of
tests/data/torch_port_reference.json holds the JAX results the card's
reference phase checks.
"""

import json
import os
import re
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
from tmhpvsim_torch.kernels import block_step as k3
from tmhpvsim_torch.kernels import build
from tmhpvsim_torch.kernels import threefry as k1
from tmhpvsim_torch.models import clearsky_index as tci
from tmhpvsim_torch.models import markov_hourly as tmh
from tmhpvsim_torch.models import renewal as tren
from tmhpvsim_torch.serve import schema as tschema
from tmhpvsim_torch.serve import server as tserver
from tmhpvsim_tpu import config as jcfg
from tmhpvsim_tpu.engine import Simulation as JSim
from tmhpvsim_tpu.fleet import FleetParams as JFleet
from tmhpvsim_tpu.models import clearsky_index as jci
from tmhpvsim_tpu.models import renewal as jren
from tmhpvsim_tpu.serve import schema as jschema

from test_torch_rbg import _jax_layout
from test_torch_threads import one_torch_thread  # noqa: F401

F32 = jnp.float32
U = "unsafe_rbg"
SMALL = dict(start="2019-09-05 10:00:00", duration_s=7200, n_chains=3,
             seed=7, block_s=3600)
REF = os.path.join(os.path.dirname(__file__), "data",
                   "torch_port_reference.json")
#: the formulations whose draw layouts differ: (block_impl, rng_batch)
FORMS = {"scan": ("scan", "scan"), "scan2": ("scan2", "scan"),
         "scan2_block": ("scan2", "block"), "wide": ("wide", "scan")}
#: seconds of chain 0's trace the reference file keeps
TRACE_S = 300
#: the scenario checks' shape (tests/test_serve.py's) and requests
SERVE = dict(start="2019-09-05 10:00:00", duration_s=120, n_chains=4,
             seed=7, block_s=60, output="reduce")
SCENARIOS = [dict(horizon_s=120),
             dict(demand_scale=1.5, demand_shift_w=250.0, horizon_s=120),
             dict(weather_bias=0.5, dc_capacity_scale=2.0, curtail_w=40.0,
                  horizon_s=60),
             dict(demand_scale=0.7, demand_shift_w=-300.0, horizon_s=90)]


@pytest.fixture
def x32():
    with jax.enable_x64(False):
        yield


def _kd(keys):
    """jax keys -> the port's int64 key data."""
    return torch.from_numpy(
        np.asarray(jax.random.key_data(keys)).astype(np.int64))


def _keys(seed, n):
    jk = jax.random.split(jax.random.key(seed, impl=U), n)
    return jk, _kd(jk)


# --------------------------------------------------------------------------
# keys
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3])
def test_root_key(seed):
    """unsafe_rbg shares rbg's ``_rbg_seed``."""
    want = np.asarray(jax.random.key_data(jax.random.key(seed, impl=U)))
    assert np.array_equal(want, rng.root_key(seed, U).numpy())
    assert torch.equal(rng.root_key(seed, U), rng.root_key(seed, "rbg"))


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_split_and_fold_in_unbatched(x32, seed):
    k = jax.random.key(seed, impl=U)
    t = rng.root_key(seed, U)
    for n in (1, 2, 5, 33):
        assert torch.equal(_kd(jax.random.split(k, n)), rng.split(t, n, U))
    for d in (0, 1, 9, 123456, 2 ** 31, 2 ** 32 - 1):
        assert torch.equal(_kd(jax.random.fold_in(k, d)),
                           rng.fold_in(t, d, U))


def _site(name, jk):
    """(jax keys, the port's keys) of one JAX call site's derivation on
    the keys ``jk`` (a batch of 3), vmapped as the site is."""
    tk = _kd(jk)
    lo, n = 40, 6
    idx = lo + jnp.arange(n)
    if name == "split_chains":        # engine :510-511, :798; renewal :85
        return (jax.vmap(lambda k: jax.random.split(k, 4))(jk),
                rng.split(tk, 4, U))
    if name == "split_chain_values":  # clearsky_index :106 (cloudy draw)
        ks = jax.vmap(lambda k: jax.random.split(k, 4))(jk)
        return (jax.vmap(jax.vmap(lambda k: jax.random.split(k, 2)))(ks),
                rng.split(_kd(ks), 2, U))
    if name == "fold_scan":           # markov_hourly :113 (chain_window)
        def body(c, i):
            return c, jax.vmap(lambda k: jax.random.fold_in(k, i))(jk)
        _, want = jax.lax.scan(body, 0, idx)
        return want, torch.stack([rng.fold_in(tk, int(i), U)
                                  for i in np.asarray(idx)])
    if name == "fold_values":         # markov :138, clearsky :149-169
        return (jax.vmap(lambda k: jax.vmap(
            lambda i: jax.random.fold_in(k, i))(idx))(jk),
            rng.fold_in(tk[:, None, :], torch.arange(lo, lo + n), U))
    if name == "fold_values_then_sub":  # clearsky :229-231
        def one(k):
            ks = jax.vmap(lambda i: jax.random.fold_in(k, i))(idx)
            return jax.vmap(lambda kk: jax.random.fold_in(kk, 1))(ks)
        got = rng.fold_in(rng.fold_in(tk[:, None, :],
                                      torch.arange(lo, lo + n), U), 1, U)
        return jax.vmap(one)(jk), got
    if name == "fold_groups_outer":   # clearsky :286-300 (scan layout)
        g = 21 + jnp.arange(4)
        return (jax.vmap(lambda gg: jax.vmap(
            lambda k: jax.random.fold_in(k, gg))(jk))(g),
            rng.fold_in(tk[None], torch.arange(21, 25)[:, None], U))
    raise KeyError(name)


SITES = ("split_chains", "split_chain_values", "fold_scan", "fold_values",
         "fold_values_then_sub", "fold_groups_outer")


@pytest.mark.parametrize("site", SITES)
def test_call_site_nesting(x32, site):
    """Each call site's derivation, vmapped as in the JAX source, bit for
    bit; a batched derivation differs from the per-key loop beyond its
    first member."""
    jk, _ = _keys(4, 3)
    want, got = _site(site, jk)
    assert torch.equal(_kd(want), got)


def test_batched_split_takes_the_first_key(x32):
    """A vmapped split of 3 keys is the first key's rows at each member's
    offset: equal to the loop for key 0 only; ``per_key`` is the loop."""
    jk, tk = _keys(3, 3)
    want = _kd(jax.vmap(lambda k: jax.random.split(k, 2))(jk))
    loop = torch.stack([_kd(jax.random.split(k, 2)) for k in jk])
    assert torch.equal(want[0], loop[0])
    assert not torch.equal(want[1:], loop[1:])
    assert torch.equal(rng.split(tk, 2, U, per_key=True), loop)
    fw = _kd(jax.vmap(lambda i: jax.random.fold_in(jk[0], i))(
        jnp.arange(3)))
    fl = torch.stack([_kd(jax.random.fold_in(jk[0], i)) for i in range(3)])
    assert torch.equal(fw[0], fl[0]) and not torch.equal(fw[1:], fl[1:])


def test_vmapped_gamma_depends_on_its_batch(x32):
    """jax's ``_gamma_impl`` splits its flattened keys under vmap before
    the serial loop: a vmapped gamma over 3 keys differs from the looped
    one beyond key 0 (under rbg both are per key, as
    tests/test_torch_rbg.py holds)."""
    keys = jax.random.split(jax.random.key(3, impl=U), 3)
    tk = _kd(keys)
    a = np.float32(2.69)
    want = np.asarray(jax.vmap(lambda k: jax.random.gamma(k, a))(keys))
    loop = np.asarray([jax.random.gamma(k, a) for k in keys])
    got = rng.gamma(tk, torch.tensor(a), U).numpy()
    got_loop = np.asarray([rng.gamma(k, torch.tensor(a), U).item()
                           for k in tk], np.float32)
    assert np.array_equal(want, got)
    assert np.array_equal(loop, got_loop)
    assert want[0] == loop[0] and not np.array_equal(want[1:], loop[1:])
    np.testing.assert_allclose(want, [3.986, 5.415, 3.981], atol=1e-3)
    np.testing.assert_allclose(loop, [3.986, 0.930, 4.226], atol=1e-3)


@pytest.mark.parametrize("shape", [(8,), (3, 4)])
def test_gamma_and_t_batched(x32, shape):
    """gamma at several alphas and t, over one and two vmap levels."""
    jk, _ = _keys(11, shape[0])
    if len(shape) == 2:
        jk = jax.vmap(lambda k: jax.random.split(k, shape[1]))(jk)
    tk = _kd(jk)
    vm = jax.vmap if len(shape) == 1 else (lambda f: jax.vmap(jax.vmap(f)))
    draw = jax.jit(vm(lambda k, a: jax.random.gamma(k, a, (), F32)))
    for a in (2.69, 5.0, 3.5624, 0.7):
        want = draw(jk, jnp.full(shape, a, F32))
        got = rng.gamma(tk, torch.tensor(a, dtype=torch.float32), U)
        assert np.array_equal(np.asarray(want), got.numpy()), a
    df = np.float32(11.150488007085713)
    want = vm(lambda k: jax.random.t(k, df, (), F32))(jk)
    assert np.array_equal(np.asarray(want),
                          rng.t(tk, torch.tensor(df), U).numpy())


def test_keys_refuse_another_width_and_nothing_infers():
    """The key implementation is an argument: a 4-word key given as the
    default threefry, or a 2-word key as unsafe_rbg, is refused, in the
    plain functions and the wrappers alike."""
    k4 = rng.root_key(3, U)
    for fn in (lambda: rng.split(k4, 2), lambda: rng.fold_in(k4, 1),
               lambda: rng.random_bits(k4, (3,)),
               lambda: rng.split(rng.key(3), 2, U),
               lambda: k1.split(k4[None], 2),
               lambda: k3.block_step_trace(None, None, None, k4[None],
                                           k4[None], None, 1.0, 0.0, 0.2)):
        with pytest.raises(ValueError, match="keys are"):
            fn()


# --------------------------------------------------------------------------
# the models' windows and the block draws
# --------------------------------------------------------------------------


def test_markov_cc_window(x32):
    """cc_window (the persistent chain: a scan-index fold per key, the
    transition's and Student-t's splits batched over the chains)."""
    jk, tk = _keys(0, 5)
    state = jnp.linspace(0.1, 0.9, 5, dtype=F32)
    opts = jcfg.ModelOptions()
    want, wfin = jax.vmap(lambda k, s: jci.cc_window(k, 40, 6, s, opts))(
        jk, state)
    got, gfin = tmh.chain_window(tk, 40, 6, torch.tensor(np.asarray(state)),
                                 impl=U)
    assert np.array_equal(np.asarray(want), got.numpy())
    assert np.array_equal(np.asarray(wfin), gfin.numpy())


@pytest.mark.parametrize("lo", [0, 3])
def test_window_functions(x32, lo):
    """cloudy, clear-day, windspeed and minute-noise windows vmapped over
    chains as _windows_one_chain calls them: the batched folds depend on
    the window's first index ``lo``."""
    jk, tk = _keys(5, 4)
    cc = jnp.linspace(0.05, 0.99, 4 * 9, dtype=F32).reshape(4, 9)
    cc0 = jnp.asarray([0.3, 0.8, 0.95, 0.5], F32)
    want = jax.vmap(lambda k, c, c0: jci.cloudy_window(k, lo, 7, c, lo,
                                                       c0))(jk, cc, cc0)
    got = tci.cloudy_window(tk, lo, 7, torch.tensor(np.asarray(cc)), lo,
                            torch.tensor(np.asarray(cc0)), U)
    assert np.array_equal(np.asarray(want), got.numpy())
    want = jax.vmap(lambda k: jci.clear_day_window(k, 12 + lo, 9))(jk)
    assert np.array_equal(np.asarray(want),
                          tci.clear_day_window(tk, 12 + lo, 9, U).numpy())
    want = jax.vmap(lambda k: jci.ws_window(k, 2 + lo, 3))(jk)
    assert np.array_equal(np.asarray(want),
                          tci.ws_window(tk, 2 + lo, 3, U).numpy())
    h_idx = np.arange(10, dtype=np.int32) // 4
    h_frac = np.linspace(0, 0.9, 10).astype(np.float32)
    want = jax.vmap(lambda k, c: jci.minute_noise_values_device(
        k, c, 600 + lo, (jnp.asarray(h_idx), jnp.asarray(h_frac))))(jk, cc)
    got = tci.minute_noise_values(tk, torch.tensor(np.asarray(cc)), 600 + lo,
                                  (torch.tensor(h_idx).long(),
                                   torch.tensor(h_frac)), U)
    for k in want:
        assert np.array_equal(np.asarray(want[k]), got[k].numpy()), k


def test_renewal_init(x32):
    """renewal.init's batched split and uniforms bit for bit; the carry
    to the power law's libm tolerance (rtol 2e-6)."""
    jk, tk = _keys(9, 6)
    for j in (0, 1):
        want = jax.vmap(lambda k: jax.random.uniform(
            jax.random.split(k)[j], (), F32))(jk)
        got = rng.uniform(rng.split(tk, 2, U)[:, j, :], (), impl=U)
        assert np.array_equal(np.asarray(want), got.numpy())
    cc = jnp.linspace(0.1, 0.9, 6, dtype=F32)
    ws = jnp.linspace(1.0, 6.0, 6, dtype=F32)
    want = jax.vmap(lambda k, c, w: jren.init(k, c, w, F32))(jk, cc, ws)
    got = tren.init(tk, torch.tensor(np.asarray(cc)),
                    torch.tensor(np.asarray(ws)), U)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-6, err_msg=k)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("layout", tci.DRAW_LAYOUTS)
def test_block_draw_layouts(x32, layout, dtype):
    """The minute-grouped draws of each formulation (the fold over the
    minutes batched in the scan and trace layouts, a scan index in
    scan2), float32 and bf16."""
    jk, tk = _keys(13, 5)
    jd, td = (F32, torch.float32) if dtype == "f32" else (jnp.bfloat16,
                                                           torch.bfloat16)
    ju, jz = _jax_layout(layout, jk, 21, 3, jd, meter=False)
    tu, tz = tci.scan_draws_tmajor(tk, 21, 3, td, layout, U)
    assert np.array_equal(np.asarray(ju).astype(np.float32),
                          tu.float().numpy())
    assert np.array_equal(np.asarray(jz).astype(np.float32),
                          tz.float().numpy())
    jm = _jax_layout(layout, jk, 21, 3, F32, meter=True)
    assert np.array_equal(np.asarray(jm),
                          tci.meter_block_tmajor(tk, 21, 3, 1.0, layout,
                                                 U).numpy())


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------


def _jax_sim(impl="scan", rng_batch="scan", **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return JSim(jcfg.SimConfig(
            block_impl=impl, rng_batch=rng_batch, dtype="float32",
            prng_impl=U, scan_unroll=1, **dict(SMALL, **kw)))


def _port_sim(impl="scan", rng_batch="scan", **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return TSim(tcfg.SimConfig(block_impl=impl, rng_batch=rng_batch,
                                   prng_impl=U, **dict(SMALL, **kw)),
                    device="cpu")


def _close(want, got):
    np.testing.assert_array_equal(got["n_seconds"], want["n_seconds"])
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=2e-5,
                                   atol=1e-2, err_msg=k)


@pytest.mark.parametrize("slab", [dict(), dict(n_chains_total=8,
                                               chain_offset=2)])
def test_init_state_matches_jax(slab):
    """The initial keys bit for bit (engine :333-334, :510-511, :546; the
    slab's 5- and 4-way splits batched from its first key, so
    ``chain_offset`` and ``n_chains_total`` change the values), the
    primers to rtol 2e-6; the key data crosses engine/convert.py with its
    implementation named."""
    js, ts = _jax_sim(**slab), _port_sim(**slab)
    jstate = js.init_state()
    got = convert.state_to_numpy(ts.init_state(), U)
    for k in convert.KEY_LEAVES:
        want = np.asarray(jax.random.key_data(jstate[k]))
        assert got[k].shape == (3, 4)
        assert np.array_equal(got[k], want), k
    for k in convert.FLOAT_LEAVES:
        np.testing.assert_allclose(got[k], np.asarray(jstate[k]),
                                   rtol=2e-6, err_msg=k)
    back = convert.state_from_numpy(got, "cpu", U)
    assert torch.equal(back["k_scan"], ts.init_state()["k_scan"])
    with pytest.raises(ValueError, match="threefry2x32"):
        convert.state_from_numpy(got, "cpu", "threefry2x32")


def test_slab_keys_depend_on_the_slab():
    """Finding: under unsafe_rbg a slab's keys are not the full run's
    rows (the batched split takes the slab's first key)."""
    whole = _port_sim(n_chains=5).init_state()["k_arr"]
    part = _port_sim(n_chains=3, n_chains_total=5,
                     chain_offset=2).init_state()["k_arr"]
    assert not torch.equal(whole[2:], part)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's unsafe_rbg runs at ``SMALL``: every formulation's
    reduce statistics, the scan ensemble and the trace."""
    out = {name: _jax_sim(*form).run_reduced()
           for name, form in FORMS.items() if name != "scan"}
    js = _jax_sim()                 # one init_state compile for three runs
    out["scan"] = js.run_reduced()
    out["ensemble"] = list(js.run_ensemble())
    out["trace"] = list(js.run_blocks())
    return out


@pytest.mark.parametrize("form", list(FORMS))
def test_reduce_matches_jax_formulation(jax_runs, form):
    _close(jax_runs[form], _port_sim(*FORMS[form]).run_reduced())


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


def test_fleet_matches_jax():
    """A 12-site heterogeneous fleet (weather regimes, transforms)."""
    want = _jax_sim(fleet=JFleet.synthetic(12, seed=3)).run_reduced()
    got = _port_sim(fleet=TFleet.synthetic(12, seed=3)).run_reduced()
    _close(want, got)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_scenario_replies_match_jax(dtype):
    """``ScenarioEngine.run`` under unsafe_rbg (float32, and bf16: the
    JAX engine runs its step in the compute dtype, K12 in K10): one batch
    of 4 reduce requests, each reply's statistics against the JAX
    ``scenario_step``'s accumulator over the same blocks (``block_impl=
    'scan'`` pinned), summed over the chains as a reply sums them, at the
    engine tolerance."""
    kw = dict(prng_impl=U, compute_dtype=dtype)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        js = JSim(jcfg.SimConfig(**SERVE, **kw, dtype="float32",
                                 block_impl="scan", scan_unroll=1))
        teng = tserver.ScenarioEngine(tcfg.SimConfig(**SERVE, **kw), (4,),
                                      device="cpu")
    assert teng.sim.plan.prng_impl == U
    scs = [jschema.parse_scenario(d, max_horizon_s=120) for d in SCENARIOS]
    scen = jschema.encode_batch(scs, 4, np.float32)
    jstate, jacc = js.init_state(), js.init_scenario_acc(4)
    for bi in range(js.n_blocks):
        jstate, jacc, _ = js.scenario_step(jstate, js.host_inputs(bi)[0],
                                           jacc, scen)
    got = teng.run([tschema.Request(
        id=f"r{i}", reply_to="r", mode="reduce",
        scenario=tschema.parse_scenario(d, max_horizon_s=120))
        for i, d in enumerate(SCENARIOS)])
    for i, g in enumerate(got):
        row = {k: np.asarray(v)[i] for k, v in jacc.items()}
        want = {"n_seconds": int(row["n_seconds"].sum()),
                "pv_max_w": float(row["pv_max"].max()),
                "residual_min_w": float(row["residual_min"].min()),
                "residual_max_w": float(row["residual_max"].max()),
                **{f"{k}_w": float(row[k].astype(np.float64).sum())
                   for k in ("pv_sum", "meter_sum", "residual_sum")}}
        assert g["mode"] == "reduce" and set(g["stats"]) == set(want)
        for k, v in want.items():
            if k == "n_seconds":
                assert g["stats"][k] == v
            else:
                assert g["stats"][k] == pytest.approx(v, rel=2e-5, abs=1e-2)
    assert got[0]["stats"]["n_seconds"] == 120 * 4


def test_strict_refuses_and_plain_run_warns():
    """As in the JAX package (engine/simulation.py:292-305): unsafe_rbg
    warns at build and raises under ``telemetry_strict`` (bf16 included)."""
    for strict_kw in (dict(telemetry_strict=True),
                      dict(telemetry_strict=True, compute_dtype="bf16")):
        with pytest.raises(ValueError, match="unsafe_rbg"):
            JSim(jcfg.SimConfig(prng_impl=U, **strict_kw))
        with pytest.raises(ValueError, match="unsafe_rbg"):
            TSim(tcfg.SimConfig(prng_impl=U, **strict_kw), device="cpu")
    with pytest.warns(RuntimeWarning, match="prng_impl='unsafe_rbg'"):
        sim = TSim(tcfg.SimConfig(prng_impl=U), device="cpu")
    assert sim.plan.prng_impl == U


def test_urbg_units_and_sources():
    """K14's four block-step units instantiate the template with the
    unsafe_rbg key type, build beside the others, and the K1 / K2
    entries take it."""
    for v, kset in (("", "Exact"), ("_table", "Table"),
                    ("_bf16", "Exact"), ("_bf16_table", "Table")):
        src = f"block_step_urbg{v}.cu"
        assert src in build.SOURCES
        text = open(os.path.join(build.CSRC, src)).read()
        assert f"#define KSET {kset}" in text
        assert "#define PRNG URBG" in text
        assert ("#define CDTYPE BF16" in text) == ("bf16" in v)
        assert '#include "block_step.cuh"' in text
        assert k3._library("table" if "table" in v else "exact",
                           "bf16" if "bf16" in v else "f32", U) == src
    text = open(os.path.join(build.CSRC, "philox.cu")).read()
    assert re.search(r'extern "C" int philox_derive\(', text)
    # K2's window kernel is one template over the key implementation
    win = open(os.path.join(build.CSRC, "windows.cu")).read()
    assert "launch<URBG>" in win and "urbg_shared(" in win


def test_reference_section_tracks_jax(jax_runs):
    """The ``unsafe_rbg`` section of the reference file: the JAX results
    at ``SMALL`` for chip_smoke.py's reference phase (each formulation's
    reduce statistics and chain 0's trace over the first ``TRACE_S``
    seconds, from 10:00); written when missing, it must equal what the
    JAX package computes."""
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
    if U not in doc:
        doc[U] = sec
        with open(REF, "w") as f:
            json.dump(doc, f, separators=(",", ":"))
    assert os.path.getsize(REF) < 300_000
    with open(REF) as f:
        assert json.load(f)[U] == json.loads(json.dumps(sec))
