"""Chain-sharded runs of the port (``tmhpvsim_torch.parallel``) on the CPU:
two gloo ranks against the JAX package's ``ShardedSimulation`` on 2 of the
8 virtual CPU devices (at tests/test_parallel.py's shape: 8 chains, 3600 s
from 10:00 in 1800 s blocks; a 12-site fleet), and against the port's
unsharded run.

The ranks run outside this process, once per module: ``python -m
tmhpvsim_torch.parallel._check`` (every case of ``_cases``, each rank
writing an ``.npz``) and the CLI's ``pvsim --sharded`` pairs, all started
together over ``file://`` rendezvous (no TCP port) while this process
computes the references (the port's in a thread beside the JAX
package's).  The ranks import the port only.

Tolerances.  On a shared site a rank's per-chain rows are the unsharded
port run's rows of its chains bit for bit (the same keys, the host's
float64 geometry, the same plain versions), and so are its observers'
integers and extrema.  With per-site geometry (a site grid, a fleet) the
plain versions' per-chain float32 transcendentals can round differently
depending on where a chain falls in torch's vectorised loop, which a
rank's narrower batch moves: there ``n_seconds``, NaN and the meter are
exact, the rest at the engine tolerance (rtol 2e-5 / atol 1e-2), and
counts a sample can move across a bin edge within chip_smoke.py's
reference slack, max(2, 1e-4 of the samples).  What is summed over
chains is summed in another order: the fleet means, ``ensemble_stats``
sums and the observers' float sums rtol 1e-5 / atol 1e-3.  Against the
JAX package's sharded run: the engine tolerance, the means rtol 1e-5 /
atol 1e-3, the fleet's counts as chip_smoke.py holds the port's fleet to
the JAX package's, NaN where JAX has NaN (but in the extrema of
``ensemble_stats``, which JAX's sharded run computes without a shard's
NaN: ROADMAP, reference-side caveats).
"""

import csv
import datetime
import json
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from tmhpvsim_torch import config as tcfg
from tmhpvsim_torch.engine.simulation import REDUCE_STATS
from tmhpvsim_torch.engine.simulation import Simulation as TSim
from tmhpvsim_torch.fleet import FleetParams as TFleet
from tmhpvsim_torch.kernels import build
from tmhpvsim_torch.obs import telemetry as ttel
from tmhpvsim_torch.obs.report import validate_report
from tmhpvsim_torch.parallel import ShardedSimulation, distributed
from tmhpvsim_tpu import config as jcfg
from tmhpvsim_tpu.apps.pvsim import _write_reduced_csv
from tmhpvsim_tpu.fleet import FleetParams as JFleet
from tmhpvsim_tpu.obs.report import validate_report as j_validate_report
from tmhpvsim_tpu.parallel import ShardedSimulation as JSharded
from tmhpvsim_tpu.parallel import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: tests/test_parallel.py's shape
SHAPE = dict(start="2019-09-05 10:00:00", duration_s=3600, n_chains=8,
             seed=11, block_s=1800)
RANKS = 2
#: tests/test_torch_engine.py's fleet: 12 synthetic sites (regimes 0-2,
#: 3 cohorts, clipped inverters, per-site demand), both observers full
FLEET = (12, 3)
FLEET_KW = dict(telemetry="full", analytics="full",
                analytics_capacity_w=6000.0, analytics_lolp_k=5)
#: NaN fleet leaves, all in rank 1's rows (chains 6-11): a NaN meter, a
#: NaN pv and a NaN inverter limit
NAN = (("demand_scale", 7), ("pv_scale", 9), ("ac_limit_w", 10))
GRID = ((46, 50), (9, 13), 2, 2)
ENGINE = dict(rtol=2e-5, atol=1e-2)
SUMS = dict(rtol=1e-5, atol=1e-3)


def _fleet(pkg):
    return (JFleet if pkg is jcfg else TFleet).synthetic(FLEET[0],
                                                         seed=FLEET[1])


#: the fleet's run: two 900 s blocks from 10:00 (the NaN case: the first)
FLEET_SHAPE = dict(duration_s=1800, block_s=900)
#: the port-only cases' run: two 600 s blocks from 10:00
SHORT = dict(duration_s=1200, block_s=600)


def _cases(pkg):
    """name -> (config kwargs, outputs) of the sharded cases: the JAX
    comparisons' (main at the shape above, the fleet and its NaN case),
    and a bf16 run in the wide formulation with its telemetry and two
    blocks a dispatch, and a site grid, each against the port's unsharded
    run."""
    return {
        "main": ({}, ("reduce", "ensemble", "trace")),
        "fleet": (dict(fleet=_fleet(pkg), **FLEET_KW, **FLEET_SHAPE),
                  ("reduce",)),
        "nan": (dict(fleet=_fleet(pkg), **FLEET_KW, duration_s=900,
                     block_s=900), ("reduce",)),
        "bf16w": (dict(compute_dtype="bf16", block_impl="wide",
                       blocks_per_dispatch=2, **SHORT),
                  ("reduce", "ensemble")),
        "grid": (dict(site_grid=pkg.SiteGrid.regular(*GRID), **SHORT),
                 ("reduce", "trace")),
    }


def _tcfg(name):
    kw, _ = _cases(tcfg)[name]
    return tcfg.SimConfig(**dict(SHAPE, **kw))


CLI = ["--device", "cpu", "--no-realtime", "--duration", "3600", "--chains",
       "8", "--seed", "11", "--start", SHAPE["start"], "--block-s", "1800",
       "--sharded", "--num-processes", str(RANKS)]


class Spawned:
    """The module's rank processes: started at once, waited for on the
    first read."""

    def __init__(self, tmp):
        self.tmp = tmp
        # one thread each: the ranks' tensors are a few chains wide
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        jobs = [{"name": n, "config": _tcfg(n), "outputs": out,
                 **({"nan": NAN} if n == "nan" else {})}
                for n, (_, out) in _cases(tcfg).items()]
        with open(tmp / "jobs.pkl", "wb") as f:
            pickle.dump(jobs, f)
        self.procs = []

        def start(cmd, tag):
            log = open(tmp / f"{tag}.log", "w")
            self.procs.append((tag, log, subprocess.Popen(
                [sys.executable, "-m", *cmd], env=env, cwd=tmp,
                stdout=log, stderr=subprocess.STDOUT)))

        for r in range(RANKS):
            start(["tmhpvsim_torch.parallel._check", str(tmp / "jobs.pkl"),
                   str(tmp), f"file://{tmp}/jobs.rdv", str(RANKS), str(r),
                   "cpu"], f"jobs{r}")
            start(["tmhpvsim_torch", "pvsim", "reduce.csv", "--output",
                   "reduce", "--run-report", "reduce.json", *CLI,
                   "--coordinator", f"file://{tmp}/reduce.rdv",
                   "--process-id", str(r)], f"reduce{r}")
            start(["tmhpvsim_torch", "pvsim", "trace.csv", "--chain", "5",
                   *CLI, "--duration", "1800", "--coordinator",
                   f"file://{tmp}/trace.rdv", "--process-id", str(r)],
                  f"trace{r}")
        self._done = False

    def wait(self):
        if not self._done:
            for tag, log, p in self.procs:
                rc = p.wait(timeout=600)
                log.close()
                assert rc == 0, (tag, (self.tmp / f"{tag}.log").read_text())
            self._done = True
        return self.tmp

    def job(self, name):
        """The ranks' outputs of case ``name``: a list of dicts."""
        tmp = self.wait()
        out = []
        for r in range(RANKS):
            with np.load(tmp / f"{name}.rank{r}.npz") as z:
                out.append({k: z[k] for k in z.files})
        return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The ranks, started, and the port's unsharded references made in a
    thread of this process meanwhile (the JAX references in its main
    thread)."""
    sp = Spawned(tmp_path_factory.mktemp("sharded"))
    pool = ThreadPoolExecutor(1)
    sp.port = pool.submit(_port_reference)
    yield sp
    pool.shutdown(wait=True)
    for _, log, p in sp.procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()


def _cat(parts, key, axis=0):
    return np.concatenate([p[key] for p in parts], axis=axis)


def _stats(part):
    return json.loads(str(part["ensemble_stats"]))


# --------------------------------------------------------------------------
# references
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs(spawned):
    """``_jax_reference()``, made while the ranks and the port's
    references run."""
    return _jax_reference()


def _jax_reference():
    """The JAX package's ShardedSimulation on 2 virtual CPU devices: the
    main case's reduce (rows, ensemble_stats) and trace (rows and
    ``.ensemble``, its psum consumer's per-second means, which stand for
    ``run_ensemble``'s), the fleet's reduce and the NaN fleet's (its state
    leaves set to NaN); the scan at ``scan_unroll`` 1 (a
    performance knob of the JAX package's SimConfig), which compiles
    faster than the default 8."""
    mesh = make_mesh(chain_devices=jax.devices()[:RANKS])

    def sim(name, **kw):
        ckw, _ = _cases(jcfg)[name]
        return JSharded(jcfg.SimConfig(block_impl="scan", dtype="float32",
                                       scan_unroll=1,
                                       **dict(SHAPE, **ckw, **kw)),
                        mesh=mesh)

    out = {}
    s = sim("main")
    out["reduce"] = {k: np.asarray(v) for k, v in s.run_reduced().items()}
    out["stats"] = s.ensemble_stats()
    out["trace"] = list(s.run_blocks())  # the reduce run's sim, shared
    s = sim("fleet")
    out["fleet"] = ({k: np.asarray(v) for k, v in s.run_reduced().items()},
                    s)
    s = sim("nan")
    st = s.init_state()
    for leaf, c in NAN:
        st["fleet"][leaf] = st["fleet"][leaf].at[c].set(np.nan)
    out["nan"] = ({k: np.asarray(v)
                   for k, v in s.run_reduced(state=st).items()}, s)
    return out


@pytest.fixture(scope="module")
def port_runs(spawned, jax_runs):
    """``_port_reference()`` (made in ``spawned``'s thread; the JAX
    references first, so that both run at once)."""
    return spawned.port.result(timeout=600)


def _port_reference():
    """The port's unsharded runs of every case (on the CPU)."""
    out = {}
    for name, (_, outputs) in _cases(tcfg).items():
        res = {}
        for what in outputs:
            sim = TSim(_tcfg(name), device="cpu")
            if what == "reduce":
                state = None
                if name == "nan":
                    state = sim.init_state()
                    for leaf, c in NAN:
                        state["fleet"][leaf][c] = float("nan")
                res["reduce"] = sim.run_reduced(state=state)
                res["stats"] = sim.ensemble_stats()
                res["sim"] = sim
            else:
                runner = sim.run_ensemble if what == "ensemble" \
                    else sim.run_blocks
                res[what] = list(runner())
        out[name] = res
    return out


def _assert_rows(got, want, exact):
    for k in REDUCE_STATS:
        if exact or k == "n_seconds":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_array_equal(np.isnan(got[k]),
                                          np.isnan(want[k]), err_msg=k)
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **ENGINE)


def _assert_stats(got, want, exact):
    """``ensemble_stats`` against the unsharded run's: counts exact, NaN
    where it is NaN, extrema exact (``exact``) or at the engine tolerance,
    sums rtol 1e-5 / atol 1e-3."""
    assert set(got) == set(want)
    for k, (kind, dkind) in REDUCE_STATS.items():
        assert np.isnan(got[k]) == np.isnan(want[k]), k
        if dkind == "i" or (exact and kind != "sum"):
            assert got[k] == want[k] or np.isnan(want[k]), k
        else:
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **(SUMS if kind == "sum" else ENGINE))


# --------------------------------------------------------------------------
# against the port's unsharded run
# --------------------------------------------------------------------------

#: the shared-site cases, whose rank rows keep the unsharded bits on the
#: CPU too (see the module docstring)
SHARED = ("main", "bf16w")


def _slack(count) -> int:
    """chip_smoke.py's reference slack for counts whose samples can cross
    a sketch bin edge: max(2, 1e-4 of the samples)."""
    return max(2, int(1e-4 * int(count)))


@pytest.mark.parametrize("name", ["main", "fleet", "nan", "bf16w",
                                  "grid"])
def test_rank_rows_are_the_unsharded_rows(spawned, port_runs, name):
    """Each rank's reduce rows are the unsharded run's rows of its chains
    (bit for bit on a shared site; with per-site geometry ``n_seconds``
    and NaN exact, the rest at the engine tolerance); every rank's
    ``ensemble_stats`` is the unsharded run's (counts exact, NaN where it
    is NaN, extrema exact on a shared site, sums rtol 1e-5)."""
    parts = spawned.job(name)
    n = port_runs[name]["sim"].config.n_chains
    assert [(int(p["chain_start"]), int(p["chain_stop"])) for p in parts] \
        == [(r * n // RANKS, (r + 1) * n // RANKS) for r in range(RANKS)]
    got = {k: _cat(parts, f"reduce.{k}") for k in REDUCE_STATS}
    _assert_rows(got, port_runs[name]["reduce"], exact=name in SHARED)
    for p in parts[1:]:
        np.testing.assert_array_equal(
            np.asarray(list(_stats(p).values())),
            np.asarray(list(_stats(parts[0]).values())))
    for p in parts:
        _assert_stats(_stats(p), port_runs[name]["stats"],
                      exact=name in SHARED)


@pytest.mark.parametrize("name", ["main", "grid"])
def test_rank_trace_is_the_unsharded_trace(spawned, port_runs, name):
    """Trace mode: the ranks' chains, concatenated, are the unsharded
    trace (bit for bit on a shared site; a site grid's meter bit for bit,
    its pv and residual at the engine tolerance); ``.ensemble`` is the
    whole run's mean on every rank (rtol 1e-5 / atol 1e-3)."""
    parts = spawned.job(name)
    want = port_runs[name]["trace"]
    for f in ("meter", "pv", "residual"):
        g = _cat(parts, f"trace.{f}", axis=0)
        w = np.concatenate([getattr(b, f) for b in want], axis=1)
        if name == "main" or f == "meter":
            np.testing.assert_array_equal(g, w, f)
        else:
            np.testing.assert_allclose(g, w, err_msg=f, **ENGINE)
    pv = np.concatenate([b.pv for b in want], axis=1)
    res = np.concatenate([b.residual for b in want], axis=1)
    for p in parts:
        np.testing.assert_allclose(p["trace.pv_mean"], pv.mean(0), **SUMS)
        np.testing.assert_allclose(p["trace.residual_mean"], res.mean(0),
                                   rtol=1e-5, atol=1e-2)
    assert all(p["trace.all_reduce_calls"] == 2 for p in parts)


@pytest.mark.parametrize("name", ["main", "bf16w"])
def test_ensemble_means_are_the_unsharded_means(spawned, port_runs, name):
    """Ensemble mode: every rank writes the whole run's per-second means
    (one packed all_reduce a block), within rtol 1e-5 / atol 1e-3 of the
    unsharded run's."""
    parts = spawned.job(name)
    want = port_runs[name]["ensemble"]
    for f in ("meter", "pv", "residual"):
        w = np.concatenate([getattr(b, f) for b in want], axis=1)
        for p in parts:
            np.testing.assert_allclose(p[f"ensemble.{f}"], w, err_msg=f,
                                       **SUMS)
    assert all(p["ensemble.all_reduce_calls"] == 2 for p in parts)


@pytest.mark.parametrize("name", ["fleet", "nan", "bf16w"])
def test_observers_are_the_unsharded_observers(spawned, port_runs, name):
    """The observers' block deltas are reduced right after each launch:
    every rank's analytics run totals and last telemetry delta are the
    unsharded run's, and so are the fleet and telemetry summaries: on a
    shared site integer leaves and extrema exact; with per-site geometry
    ``count``, ``cohort_count`` and the NaN counts exact, the other
    counts within ``_slack`` (a sample an ULP off can cross a bin edge),
    extrema at the engine tolerance; float sums rtol 1e-5 / atol 1e-3; a
    handful of all_reduce calls a block, not one per leaf."""
    parts = spawned.job(name)
    sim = port_runs[name]["sim"]
    exact = name in SHARED
    for p in parts:
        for prefix, tree in (("fleet_total", sim._fleet_total),
                             ("tel_last", sim._tel_last)):
            if tree is None:
                assert not any(k.startswith(prefix) for k in p)
                continue
            slack = 0 if exact else _slack(tree["count"])
            for k, v in tree.items():
                w = v.numpy() if isinstance(v, torch.Tensor) else v
                g = p[f"{prefix}.{k}"]
                assert g.dtype == w.dtype and g.shape == w.shape, k
                if g.dtype.kind == "f" and not k.startswith(
                        ("min", "max")):
                    np.testing.assert_allclose(g, w, err_msg=k, **SUMS)
                elif exact or k in ("count", "cohort_count") or \
                        k.startswith("nan_"):
                    np.testing.assert_array_equal(g, w, err_msg=k)
                elif g.dtype.kind == "f":
                    np.testing.assert_allclose(g, w, err_msg=k, **ENGINE)
                else:
                    assert np.abs(g - w).max() <= slack, k
        summaries = [(p["tel_summary"], ttel.summarize(sim._tel_last))]
        if sim.fleet_summary() is not None:
            summaries.append((p["fleet_summary"], sim.fleet_summary()))
        for got, want in summaries:
            want = json.loads(json.dumps(want, default=float))
            _assert_counts(json.loads(str(got)), want,
                           slack=0 if exact else _slack(want["count"]))
    # ensemble_stats: float sums, extrema keys, the count; then the
    # observers' packed tree once a block: a few calls, not one per leaf
    per_run = int(parts[0]["reduce.all_reduce_calls"]) - 3
    assert per_run % sim.n_blocks == 0
    assert 0 < per_run // sim.n_blocks <= 4


def _assert_counts(got, want, path="", slack=0, rel=1e-5, atol=1e-3):
    """A summary against another (tests/test_torch_engine.py's
    ``_assert_summary``): the same structure, ints within ``slack``
    (``count`` exact), floats within ``rel`` / ``atol``."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_counts(got[k], want[k], f"{path}.{k}",
                           0 if k == "count" else slack, rel, atol)
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_counts(g, w, f"{path}[{i}]", slack, rel, atol)
    elif want is None or isinstance(want, (bool, str)):
        assert got == want, path
    elif isinstance(want, int):
        assert abs(got - want) <= slack, path
    else:
        assert got == pytest.approx(want, rel=rel, abs=atol,
                                    nan_ok=True), path


# --------------------------------------------------------------------------
# against the JAX package's ShardedSimulation
# --------------------------------------------------------------------------

def test_reduce_follows_jax_sharded(spawned, jax_runs):
    """The main case's rows at the engine tolerance and ``ensemble_stats``
    (counts exact, extrema and sums at the engine tolerance) against the
    JAX package's sharded run."""
    parts = spawned.job("main")
    got = {k: _cat(parts, f"reduce.{k}") for k in REDUCE_STATS}
    _assert_rows(got, jax_runs["reduce"], exact=False)
    want = jax_runs["stats"]
    for p in parts:
        got = _stats(p)
        assert got["n_seconds"] == want["n_seconds"]
        for k in REDUCE_STATS:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **ENGINE)


def test_ensemble_follows_jax_sharded(spawned, jax_runs):
    """run_ensemble's per-second means against the JAX package's sharded
    means (its trace's psum consumer: ``pv_mean`` and ``residual_mean``,
    and the meter's mean over its chains), rtol 1e-5 / atol 1e-3, epochs
    exact."""
    parts = spawned.job("main")
    want = jax_runs["trace"]
    np.testing.assert_array_equal(parts[0]["epoch"], np.concatenate(
        [np.asarray(b.epoch) for b in want]))
    means = {
        "meter": np.concatenate([np.asarray(b.meter, np.float64).mean(0)
                                 for b in want]),
        "pv": np.concatenate([np.asarray(b.ensemble["pv_mean"])
                              for b in want]),
        "residual": np.concatenate([np.asarray(b.ensemble["residual_mean"])
                                    for b in want])}
    for f, w in means.items():
        for p in parts:
            np.testing.assert_allclose(p[f"ensemble.{f}"][0], w, err_msg=f,
                                       **SUMS)


def test_trace_follows_jax_sharded(spawned, jax_runs):
    """run_blocks: the ranks' rows at the engine tolerance (meter, the
    integer draws' product, exact) and ``.ensemble`` against JAX's."""
    parts = spawned.job("main")
    want = jax_runs["trace"]
    np.testing.assert_array_equal(
        _cat(parts, "trace.meter"),
        np.concatenate([np.asarray(b.meter) for b in want], axis=1))
    for f in ("pv", "residual"):
        np.testing.assert_allclose(
            _cat(parts, f"trace.{f}"),
            np.concatenate([np.asarray(getattr(b, f)) for b in want],
                           axis=1), err_msg=f, **ENGINE)
    for f in ("pv_mean", "residual_mean"):
        w = np.concatenate([np.asarray(b.ensemble[f]) for b in want])
        for p in parts:
            np.testing.assert_allclose(p[f"trace.{f}"], w, err_msg=f,
                                       **ENGINE)


@pytest.mark.parametrize("name", ["fleet", "nan"])
def test_fleet_follows_jax_sharded(spawned, jax_runs, name):
    """The 12-site fleet with both observers at level full (and with NaN
    fleet leaves in rank 1's rows): rows at the engine tolerance, NaN
    where JAX has NaN; the analytics run totals and the fleet summary as
    chip_smoke.py's reference phase holds the port's fleet to the JAX
    package's: ``count``, ``cohort_count`` and ``regime_observed`` exact,
    every other count within max(2, 1e-4 of the samples) (the suite runs
    JAX with x64, so a daylight residual can differ by a float32 ULP and
    cross a sketch bin edge; tests/test_torch_engine.py counts those
    samples at its shape), the rest rel 1e-4; ``ensemble_stats`` at the
    engine tolerance and NaN wherever a row is (a NaN on one rank wins
    MIN and MAX over the other's numbers)."""
    parts = spawned.job(name)
    want, jsim = jax_runs[name]
    got = {k: _cat(parts, f"reduce.{k}") for k in REDUCE_STATS}
    _assert_rows(got, want, exact=False)
    jt = jsim._fleet_total
    slack = _slack(np.asarray(jt["count"]))
    for k, w in jt.items():
        w = np.asarray(w)
        for p in parts:
            g = p[f"fleet_total.{k}"]
            assert g.dtype == w.dtype and g.shape == w.shape, k
            if k in ("count", "cohort_count", "regime_observed"):
                np.testing.assert_array_equal(g, w, err_msg=k)
            elif w.dtype.kind == "i":
                assert np.abs(g - w).max() <= slack, k
            else:
                np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=k)
    jsum = json.loads(json.dumps(jsim.fleet_summary(), default=float))
    for p in parts:
        _assert_counts(json.loads(str(p["fleet_summary"])), jsum,
                       slack=slack, rel=1e-4, atol=1e-6)
    # ensemble_stats: a NaN row makes the port's statistic NaN on every
    # rank, as the unsharded runs of both packages do (a plain max of the
    # rows); the JAX sharded run's sums are NaN too, but its pmin / pmax
    # over the CPU mesh drop a shard's NaN (ROADMAP, reference-side
    # caveats), so there it is finite where a row is NaN
    jstats = jsim.ensemble_stats()
    for p in parts:
        st = _stats(p)
        for k, (kind, _) in REDUCE_STATS.items():
            row_nan = bool(np.isnan(got[k]).any())
            assert np.isnan(st[k]) == row_nan, k
            if kind == "sum" or not row_nan:
                assert np.isnan(jstats[k]) == row_nan, k
                if not row_nan:
                    np.testing.assert_allclose(st[k], jstats[k], err_msg=k,
                                               **ENGINE)
    if name == "nan":
        nan = {k: set(np.flatnonzero(np.isnan(got[k])))
               for k in REDUCE_STATS if k != "n_seconds"}
        assert nan["meter_sum"] == {7}
        assert nan["pv_max"] == nan["pv_sum"] == {9, 10}
        assert np.isnan(_stats(parts[0])["residual_min"])
        assert np.isnan(_stats(parts[0])["pv_max"])


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def _csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_cli_reduce_writes_host_files_like_jax(spawned, jax_runs, tmp_path):
    """Two ``pvsim --sharded`` processes write ``OUT.host0`` and
    ``OUT.host1``: each its chains under global ids and the same whole-run
    ``ensemble`` row, matching the JAX sharded run's rows written through
    its ``_write_reduced_csv`` at the engine tolerance; process 0 writes
    the run report (``mesh`` and ``processes``), valid to both packages'
    validators."""
    tmp = spawned.wait()
    want = jax_runs["reduce"]
    ens = []
    for r in range(RANKS):
        got = _csv(tmp / f"reduce.csv.host{r}")
        sl = slice(r * 4, r * 4 + 4)
        ref = tmp_path / f"jax{r}.csv"
        _write_reduced_csv(str(ref), {k: v[sl] for k, v in want.items()},
                           jax_runs["stats"], chain_start=sl.start)
        ref = _csv(ref)
        assert got[0] == ref[0] and len(got) == len(ref) == 6
        assert [row[0] for row in got] == [row[0] for row in ref]
        np.testing.assert_allclose(
            np.asarray([row[1:] for row in got[1:]], np.float64),
            np.asarray([row[1:] for row in ref[1:]], np.float64), **ENGINE)
        ens.append(got[-1])
    assert ens[0] == ens[1] and ens[0][0] == "ensemble"
    assert not os.path.exists(tmp / "reduce.csv")
    with open(tmp / "reduce.json") as f:
        doc = json.load(f)
    validate_report(doc)
    j_validate_report(doc)
    assert doc["mesh"]["shape"] == [RANKS] and doc["mesh"]["n_chains"] == 8
    assert doc["mesh"]["chain_stop"] == 4
    assert doc["device"]["process_count"] == RANKS
    assert len(doc["processes"]) == RANKS


def test_cli_trace_is_written_by_the_chains_owner(spawned, port_runs):
    """``--chain 5`` in trace mode: only rank 1 (chains 4-7) writes
    ``OUT.host1``, the unsharded run's chain 5 rows; rank 0 runs every
    block and writes nothing."""
    tmp = spawned.wait()
    assert not os.path.exists(tmp / "trace.csv.host0")
    rows = _csv(tmp / "trace.csv.host1")
    assert rows[0] == ["time", "meter", "pv", "residual load"]
    want = port_runs["main"]["trace"]
    meter = want[0].meter[5]          # the first 1800 s: the CLI's run
    assert len(rows) == 1 + meter.size
    np.testing.assert_array_equal(
        np.asarray([r[1] for r in rows[1:]], np.float32), meter)


class _Clock:
    """A wall clock that moves only when slept on."""

    def __init__(self):
        self.now = 0.0

    def monotonic(self):
        return self.now

    perf_counter = monotonic

    def sleep(self, s):
        self.now += s


def test_cli_realtime_trace_paces_every_process(monkeypatch, tmp_path):
    """Under ``--realtime`` (the default) the process that does not hold
    ``--chain`` paces the same blocks as the one that does, so both reach
    each block's all_reduce at the same time on the wall clock and no
    collective waits for a whole paced block.  Rank 1 of 2 (chains 4-7)
    as ``distributed.world`` reports it, with a clock that moves only
    when the pacing sleeps: the times of the per-block series reduction
    with ``--chain 5`` (the owner's) and ``--chain 0`` are the same."""
    from tmhpvsim_torch.apps import pvsim as pvsim_app
    from tmhpvsim_torch.cli import main

    monkeypatch.setattr(distributed, "world", lambda: (1, 2))
    clock = _Clock()
    monkeypatch.setattr(pvsim_app, "time", clock)
    seen = []
    share = ShardedSimulation._share_series

    def timed_share(self, m_sum, p_sum):
        seen.append(clock.now)
        return share(self, m_sum, p_sum)

    monkeypatch.setattr(ShardedSimulation, "_share_series", timed_share)
    times = {}
    for chain in (5, 0):
        clock.now, seen[:] = 0.0, []
        out = tmp_path / f"c{chain}.csv"
        assert main(["pvsim", str(out), "--device", "cpu", "--duration",
                     "240", "--block-s", "60", "--chains", "8", "--seed",
                     "11", "--start", SHAPE["start"], "--sharded",
                     "--chain", str(chain)]) == 0
        times[chain] = list(seen)
        assert clock.now == 4 * 59   # each block paced, its last row at 59 s
    assert len(_csv(f"{tmp_path}/c5.csv.host1")) == 1 + 240
    assert not os.path.exists(f"{tmp_path}/c0.csv.host1")
    assert len(times[5]) == 4 and times[5][-1] >= 2 * 59
    assert times[0] == times[5]


@pytest.mark.parametrize("argv, match", [
    (["--coordinator", "file:///x"], "require --sharded"),
    (["--sharded", "--coordinator", "file:///x"], "go together"),
    (["--sharded", "--coordinator", "file:///x", "--num-processes", "2",
      "--process-id", "2"], r"\[0, --num-processes\)"),
    (["--sharded", "--prng-impl", "rbg"], "not sharded"),
    (["--sharded", "--mesh-scenario", "2"], "--mesh-scenario"),
])
def test_cli_refuses_sharded_misuse(tmp_path, capsys, argv, match):
    from tmhpvsim_torch.cli import main

    with pytest.raises(SystemExit):
        main(["pvsim", str(tmp_path / "x.csv"), "--duration", "60",
              "--device", "cpu", "--no-realtime"] + argv)
    assert __import__("re").search(match, capsys.readouterr().err)


# --------------------------------------------------------------------------
# in process: refusals and the collective wrappers
# --------------------------------------------------------------------------

def test_uneven_chains_raise_divisible(monkeypatch):
    """Rank 1 of a two-rank world (as ``distributed.world`` reports it)
    refuses 7 chains before it joins any collective."""
    monkeypatch.setattr(distributed, "world", lambda: (1, 2))
    with pytest.raises(ValueError, match="divisible"):
        ShardedSimulation(tcfg.SimConfig(**dict(SHAPE, n_chains=7)),
                          device="cpu")


@pytest.mark.parametrize("impl", ["rbg", "unsafe_rbg"])
def test_rbg_keys_refused_by_name(impl):
    with pytest.raises(NotImplementedError, match="prng_impl"):
        ShardedSimulation(tcfg.SimConfig(**dict(SHAPE, prng_impl=impl)),
                          device="cpu")


def test_world_of_one_without_a_group_is_the_unsharded_run():
    """No process group: the whole run on this process, every collective
    the identity, no ``.host`` suffix needed."""
    cfg = tcfg.SimConfig(**dict(SHAPE, duration_s=900, block_s=900))
    sim = ShardedSimulation(cfg, device="cpu")
    assert (sim.rank, sim.world, sim.chain_slice) == (0, 1, slice(0, 8))
    ref = TSim(cfg, device="cpu")
    a, b = sim.run_reduced(), ref.run_reduced()
    for k in REDUCE_STATS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert sim.ensemble_stats() == ref.ensemble_stats()
    assert sim.mesh_doc()["chain_stop"] == 8


def test_failed_rendezvous_raises(tmp_path):
    """A rank whose peers never come raises after its timeout instead of
    running alone."""
    with pytest.raises(RuntimeError, match="rank 1 of 2"):
        distributed.initialize(f"file://{tmp_path}/rdv", 2, 1, device="cpu",
                               timeout_s=1)
    assert distributed.world() == (0, 1)


#: every pairing of NaN, infinities, signed zeros and numbers
VALS = (float("nan"), -float("inf"), -2.5, -1.0, -0.0, 0.0, 0.75, 3.0,
        float("inf"))


def _pairs(dtype):
    a = torch.tensor([x for x in VALS for _ in VALS], dtype=dtype)
    b = torch.tensor([y for _ in VALS for y in VALS], dtype=dtype)
    return a, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_order_key_keeps_nan_and_signed_zeros(dtype):
    """The MIN / MAX of two ranks' leaves, as the all_reduce computes it
    (a MAX of their encoded keys for either kind): NaN where either is
    NaN, -0.0 below +0.0, every other value the minimum / maximum, and
    decoding gives back each bit of a non-NaN value."""
    a, b = _pairs(dtype)
    for kind, pick in (("min", torch.minimum), ("max", torch.maximum)):
        ka, kb = (distributed._encode(v, kind) for v in (a, b))
        got = distributed._decode(torch.maximum(ka, kb), kind, a.dtype)
        want = pick(a, b)
        assert torch.equal(got.isnan(), want.isnan())
        ok = ~want.isnan()
        zero = ok & (want == 0)
        both = zero & (a == 0) & (b == 0)
        sign = torch.signbit(a) | torch.signbit(b) if kind == "min" else \
            torch.signbit(a) & torch.signbit(b)
        assert torch.equal(torch.signbit(got[both]), sign[both])
        assert torch.equal(got[ok & ~both], want[ok & ~both])
    k = distributed.order_key(a)
    finite = ~a.isnan()
    back = distributed.from_order_key(k, dtype)
    kind = {4: torch.int32, 8: torch.int64}[a.element_size()]
    assert torch.equal(back[finite].view(kind), a[finite].view(kind))


@pytest.fixture
def group_of_one(tmp_path):
    """A gloo group of this process alone (rendezvous in a file)."""
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/g1", world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=60))
    yield
    distributed.shutdown()


def test_collectives_in_a_group_of_one(group_of_one):
    """In a group of one every wrapper gives its input back bit for bit
    (NaN and signed zeros included), packing one all_reduce per (kind,
    dtype) of the tree; the gather returns this rank's snapshot."""
    a, _ = _pairs(torch.float32)
    tree = {"min_x": a, "max_x": a.clone(), "sum_x": a[:4].clone(),
            "nan_x": torch.arange(5, dtype=torch.int32),
            "count": torch.tensor(3.0), "max_i": torch.tensor(7),
            "min_y": torch.tensor([-0.0, 0.0])}
    distributed.reset_counts()
    assert distributed.allreduce_deltas(None, None) == (None, None)
    out, none = distributed.allreduce_deltas(tree, None)
    assert none is None and list(out) == list(tree)
    for k, v in tree.items():
        assert out[k].dtype == v.dtype and out[k].shape == v.shape, k
        kind = {4: torch.int32, 8: torch.int64}[v.element_size()]
        assert torch.equal(out[k].view(kind), v.view(kind)), k
    # sum f32 | sum i32 | the float extrema's int32 keys | max i64
    assert distributed.ALL_REDUCE.calls == 4
    m, p = distributed.allreduce_sums(torch.ones(3), torch.zeros(3))
    assert torch.equal(m, torch.ones(3)) and distributed.ALL_REDUCE.calls == 5
    stats = {"pv_sum": 1.5, "pv_max": float("nan"), "meter_sum": 2.0,
             "residual_sum": 0.5, "residual_min": -0.0,
             "residual_max": 4.0, "n_seconds": 9}
    got = distributed.allreduce_stats(stats, REDUCE_STATS, "cpu")
    assert np.isnan(got["pv_max"]) and got["n_seconds"] == 9
    assert str(got["residual_min"]) == "-0.0"
    assert distributed.gather_metrics({"a": 1}) == [{"a": 1}]
    assert distributed.mesh_doc(8)["chain_stop"] == 8


def test_launch_on_another_card_is_refused(monkeypatch):
    """The kernels launch on the current device's stream: a tensor of
    another card is refused before anything launches."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError, match="set_device"):
        build.stream_ptr(torch.device("cuda", 1))
