"""The port's reduce-mode observers (obs/telemetry.py, obs/analytics.py)
against the JAX package's, on the same numpy-seeded per-second inputs.

The JAX folds run as the engine runs them, jitted inside a ``lax.scan``
over the seconds (XLA then contracts the telemetry's ``sumsq + v * v``
into a multiply-add, which the port's fold and kernel do too).

Tolerances:
* integer leaves (counts, histograms, run lengths, seen flags): exact;
* per-chain float32 leaves (extrema, ramp slots, per-chain sums): bit for
  bit — the same float32 operations in the same order;
* sums over chains: rel 1e-4, the JAX package's own bound for
  reassociated fleet sums (tests/test_analytics.py:363-374,
  tests/test_fleet.py:145): the port adds chains in float64 and rounds
  once, the JAX package adds float32 in XLA's order (and ``cohort_sum_*``
  as a running scatter over seconds);
* host summaries: the integers exact, the floats rel 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmhpvsim_torch import config as tcfg
from tmhpvsim_torch.obs import analytics as tflt
from tmhpvsim_torch.obs import telemetry as ttel
from tmhpvsim_tpu import config as jcfg
from tmhpvsim_tpu.obs import analytics as jflt
from tmhpvsim_tpu.obs import telemetry as jtel
from test_torch_threads import one_torch_thread  # noqa: F401

N, T = 16, 240
T0 = 3540  # the inputs' first global second: ramp grids are crossed
REL = 1e-4


def _inputs(seed, t0=T0):
    """Per-second (T, N) float32 meter, pv, csi, a covered mask and the
    duration mask (the last 30 s are padding), with NaN / inf samples."""
    r = np.random.default_rng(seed)
    meter = r.uniform(0, 9000, (T, N)).astype(np.float32)
    pv = r.uniform(0, 300, (T, N)).astype(np.float32)
    csi = r.uniform(-0.2, 2.4, (T, N)).astype(np.float32)
    for a in (meter, pv, csi):
        a[r.integers(0, T, 5), r.integers(0, N, 5)] = np.nan
        a[r.integers(0, T, 3), r.integers(0, N, 3)] = np.inf
    meter[r.integers(0, T, 40), r.integers(0, N, 40)] += 30000.0
    pv[r.integers(0, T, 40), r.integers(0, N, 40)] += 9000.0
    # long loss runs for a few chains
    meter[60:75, :3] = 8500.0
    return {"meter": meter, "pv": pv, "csi": csi,
            "residual": (meter - pv).astype(np.float32),
            "covered": r.uniform(size=(T, N)) < 0.6,
            "valid": np.arange(T) < T - 30,
            "t": (t0 + np.arange(T)).astype(np.int32),
            "cohort": r.integers(0, 3, N).astype(np.int32)}


def _jax_scan(fold, acc0, xs):
    def body(acc, x):
        return fold(acc, x), None

    return jax.jit(lambda a, x: jax.lax.scan(body, a, x)[0])(acc0, xs)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _torch_fold(fold, acc, x):
    for s in range(T):
        acc = fold(acc, {k: v[s] for k, v in x.items()})
    return acc


def _tx(x):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            x.items()}


def _assert_summary(got, want, path=""):
    """Host summaries: same structure, ints exact, floats rel 1e-4."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_summary(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_summary(g, w, f"{path}[{i}]")
    elif want is None or isinstance(want, (bool, str, int)):
        assert got == want, path
    else:
        assert got == pytest.approx(want, rel=REL, abs=1e-6), path


# --------------------------------------------------------------------------
# telemetry
# --------------------------------------------------------------------------


def _tel_runs(level, seed):
    x = _inputs(seed)
    del x["cohort"]

    def jfold(acc, s):
        return jtel.fold_second(acc, level, meter=s["meter"], pv=s["pv"],
                                csi=s["csi"], residual=s["residual"],
                                covered=s["covered"].astype(jnp.float32),
                                valid=s["valid"])

    def tfold(acc, s):
        return ttel.fold_second(acc, level, meter=s["meter"], pv=s["pv"],
                                csi=s["csi"], residual=s["residual"],
                                covered=s["covered"], valid=s["valid"])

    jacc = _np(_jax_scan(jfold, jtel.init_acc(level, n_chains=N),
                         {k: jnp.asarray(v) for k, v in x.items()}))
    tacc = _torch_fold(tfold, ttel.init_acc(level, N), _tx(x))
    return jacc, tacc


@pytest.mark.parametrize("level", ["light", "full"])
@pytest.mark.parametrize("seed", [0, 1])
def test_telemetry_fold_matches_jax(level, seed):
    jacc, tacc = _tel_runs(level, seed)
    assert set(jacc) == set(tacc)
    for k, want in jacc.items():
        got = tacc[k].numpy()
        assert got.shape == want.shape, k
        if k == "csi_hist":  # counted in int32 here, float32 in JAX
            assert np.array_equal(got.astype(np.float32), want), k
        else:
            assert got.dtype == want.dtype, k
            assert np.array_equal(got, want), k
    assert int(tacc["nan_meter"].sum()) > 0 and int(tacc["nf_pv"].sum()) > 0
    # the collapse and the host summary
    jred = _np(jtel.reduce_chainwise(jacc))
    tred = ttel.reduce_chainwise(tacc)
    assert set(jred) == set(tred)
    for k, want in jred.items():
        got = tred[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        if k.startswith(("sum_", "sumsq_")):
            np.testing.assert_allclose(got, want, rtol=REL, err_msg=k)
        else:
            assert np.array_equal(got, want), k
    _assert_summary(ttel.summarize(tred), jtel.summarize(jred))


def test_telemetry_sumsq_is_one_multiply_add():
    """The jitted JAX fold rounds sumsq + v * v once: a fold that rounds
    the product first differs from it (so the test above would see it)."""
    x = _inputs(2)
    jacc, tacc = _tel_runs("light", 2)
    v0 = np.where(np.isfinite(x["meter"]) & x["valid"][:, None],
                  x["meter"], 0).astype(np.float32)
    twice = np.zeros(N, np.float32)
    for s in range(T):
        twice = (twice + v0[s] * v0[s]).astype(np.float32)
    assert np.array_equal(tacc["sumsq_meter"].numpy(), jacc["sumsq_meter"])
    assert not np.array_equal(twice, jacc["sumsq_meter"])


def test_telemetry_init_and_kinds_match_jax():
    for level in ("light", "full"):
        for n in (None, 5):
            j = _np(jtel.init_acc(level, n_chains=n))
            t = ttel.init_acc(level, n)
            assert set(j) == set(t)
            for k in j:
                tv = t[k].numpy()
                assert tv.shape == j[k].shape, k
                assert np.array_equal(tv.astype(j[k].dtype), j[k]), k
            assert ttel.leaf_kinds(t) == jtel.leaf_kinds(j)
    with pytest.raises(ValueError):
        ttel.init_acc("off")


# --------------------------------------------------------------------------
# analytics
# --------------------------------------------------------------------------

PARAMS = dict(lo=-1000.0, hi=9000.0, bins=64,
              thresholds=(-100.0, 500.0, 2000.0, 5000.0), capacity_w=3000.0,
              lolp_k=4, ramp_windows=(1, 7, 60))


def _flt_fold_pair(level, cohorts):
    jp, tp = jflt.FleetParams(**PARAMS), tflt.FleetParams(**PARAMS)

    def jfold(acc, s):
        return jflt.fold_second(
            acc, level, jp, meter=s["meter"], pv=s["pv"],
            residual=s["residual"], covered=s["covered"].astype(jnp.float32),
            t=s["t"], valid=s["valid"],
            cohort=s["cohort"] if cohorts else None)

    def tfold(acc, s):
        return tflt.fold_second(
            acc, level, tp, meter=s["meter"], pv=s["pv"],
            residual=s["residual"], covered=s["covered"], t=s["t"],
            valid=s["valid"], cohort=s["cohort"] if cohorts else None)

    return jp, tp, jfold, tfold


def _flt_block(level, cohorts, seed, t0=T0):
    jp, tp, jfold, tfold = _flt_fold_pair(level, cohorts)
    x = _inputs(seed, t0)
    xs = {k: jnp.asarray(v) for k, v in x.items()}
    xs["cohort"] = jnp.broadcast_to(xs["cohort"], (T, N))
    jacc = _np(_jax_scan(jfold, jflt.init_acc(level, n_chains=N, params=jp,
                                              cohorts=cohorts), xs))
    tx = _tx(x)
    tx["cohort"] = tx["cohort"].expand(T, N)
    tacc = _torch_fold(tfold, tflt.init_acc(level, N, params=tp,
                                            cohorts=cohorts), tx)
    return jacc, tacc, torch.from_numpy(x["cohort"])


@pytest.mark.parametrize("level, cohorts", [("risk", 0), ("full", 3)])
@pytest.mark.parametrize("seed", [0, 1])
def test_analytics_fold_matches_jax(level, cohorts, seed):
    jacc, tacc, cohort = _flt_block(level, cohorts, seed)
    assert set(jacc) == set(tacc)
    for k, want in jacc.items():
        got = tacc[k].numpy()
        if k.startswith("cohort_sum_"):
            # a per-chain sum here, a running (C,) scatter in JAX: grouped
            # by cohort they are the same sums, reassociated
            grouped = np.zeros(cohorts)
            np.add.at(grouped, cohort.numpy(), got.astype(np.float64))
            np.testing.assert_allclose(grouped, want, rtol=REL, err_msg=k)
            continue
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert np.array_equal(got, want), k
    assert int(tacc["lol_events"].sum()) > 0
    assert int(tacc["res_hist"][0]) > 0 and int(tacc["res_hist"][-1]) > 0
    for w in PARAMS["ramp_windows"]:
        assert float(tacc[f"max_ramp_{w}s"].max()) > 0, w
    # the collapse
    jred = _np(jflt.reduce_chainwise(jacc))
    tred = tflt.reduce_chainwise(tacc, cohort=cohort)
    assert set(jred) == set(tred)
    for k, want in jred.items():
        got = tred[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        if got.dtype == np.float32 and ("sum_" in k):
            np.testing.assert_allclose(got, want, rtol=REL, err_msg=k)
        else:
            assert np.array_equal(got, want), k


def test_analytics_merge_and_summary_match_jax():
    """Two blocks' deltas merged on the host (int64 / float64) and
    summarised, against the JAX package's merge_host and summarize."""
    jt = tt = None
    for seed, t0 in ((3, T0), (4, T0 + T)):
        jacc, tacc, cohort = _flt_block("full", 3, seed, t0)
        jt = jflt.merge_host(jt, _np(jflt.reduce_chainwise(jacc)))
        tt = tflt.merge_host(tt, tflt.reduce_chainwise(tacc, cohort=cohort))
    assert set(jt) == set(tt)
    for k, want in jt.items():
        assert tt[k].dtype == want.dtype, k
        if want.dtype == np.float64:
            np.testing.assert_allclose(tt[k], want, rtol=REL, err_msg=k)
        else:
            assert np.array_equal(tt[k], want), k
    _assert_summary(tflt.summarize(tt, tflt.FleetParams(**PARAMS)),
                    jflt.summarize(jt, jflt.FleetParams(**PARAMS)))


@pytest.mark.parametrize("kw", [
    {},
    {"analytics_bins": 512, "analytics_capacity_w": 5000.0,
     "analytics_lolp_k": 30, "analytics_thresholds": (100.0, 4000.0)},
])
def test_params_from_config_match_jax(kw):
    j = jflt.params_from_config(jcfg.SimConfig(meter_max_w=8000.0, **kw))
    t = tflt.params_from_config(tcfg.SimConfig(meter_max_w=8000.0, **kw))
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


def test_analytics_init_and_kinds_match_jax():
    jp, tp = jflt.FleetParams(**PARAMS), tflt.FleetParams(**PARAMS)
    for level in ("risk", "full"):
        for n, c in ((None, 0), (None, 3), (5, 3)):
            j = _np(jflt.init_acc(level, n_chains=n, params=jp, cohorts=c))
            t = tflt.init_acc(level, n, params=tp, cohorts=c)
            assert set(j) == set(t)
            for k in j:
                if n is not None and k.startswith("cohort_sum_"):
                    assert t[k].shape == (n,), k  # per chain here
                    continue
                assert np.array_equal(t[k].numpy(), j[k]), k
            assert tflt.leaf_kinds(t) == jflt.leaf_kinds(j)


@pytest.mark.parametrize("bad", [
    dict(hi=-2000.0), dict(bins=0), dict(lolp_k=0), dict(thresholds=()),
    dict(thresholds=(5.0, 5.0)), dict(ramp_windows=(60, 1, 3)),
])
def test_sketch_params_refuse_like_jax(bad):
    with pytest.raises(ValueError) as je:
        jflt.FleetParams(**dict(PARAMS, **bad))
    with pytest.raises(ValueError) as te:
        tflt.FleetParams(**dict(PARAMS, **bad))
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("field, value", [("telemetry", "heavy"),
                                          ("analytics", "all")])
def test_config_refuses_unknown_levels(field, value):
    with pytest.raises(ValueError, match=field):
        tcfg.SimConfig(**{field: value})
