"""The port's runtime autotuner (tmhpvsim_torch/engine/autotune.py) and the
executor's build report (engine/compilecache.py) against the JAX
package's (tmhpvsim_tpu/engine/autotune.py, tests/test_autotune.py).

The grid cases compare the two packages' candidate grids and stage-2
variants record for record, at the JAX suite's ``small_config`` shape.
The JAX package resolves ``stats_fusion='auto'`` by backend ('split' on
the CPU) where the port resolves it as on an accelerator ('fused'), so
the compared configs pin it.  The cache cases are the JAX suite's, run
against the port with the same fake prober (a deterministic rater: the
wide / unroll 4 / unslabbed candidate wins; stage 2 collapsed to the
defaults); ``probe_grid`` still walks the real grid and counts
``PROBE_COUNT``.  The bit cases run the tuned plan through ``Simulation``
on the CPU (the kernels' plain versions) against the static run.  Real
probes on the card: tests/test_torch_kernels.py (``cuda``).
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from tmhpvsim_torch import config as tcfg
from tmhpvsim_torch.engine import autotune as tat
from tmhpvsim_torch.engine import compilecache
from tmhpvsim_torch.engine.simulation import Simulation as TSim
from tmhpvsim_torch.fleet import FleetParams as TFleet
from tmhpvsim_torch.kernels import build
from tmhpvsim_torch.obs import metrics as tmetrics
from tmhpvsim_torch.obs.sentinel import DriftError
from tmhpvsim_tpu import config as jcfg
from tmhpvsim_tpu.engine import autotune as jat
from tmhpvsim_tpu.fleet import FleetParams as JFleet
from tmhpvsim_tpu.obs import report as jreport
from test_torch_threads import one_torch_thread  # noqa: F401

#: tests/test_autotune.py's small_config
SMALL = dict(start="2019-09-05 10:00:00", duration_s=7200, n_chains=3,
             seed=7, block_s=3600)
#: the bit cases' run: four one-minute blocks of four chains
BITS = dict(start="2019-09-05 11:00:00", duration_s=240, n_chains=4,
            seed=7, block_s=60)
WINNER = dict(block_impl="wide", scan_unroll=4)


def tcfg_of(**kw):
    return tcfg.SimConfig(**dict(SMALL, **kw))


def jcfg_of(**kw):
    return jcfg.SimConfig(**dict(SMALL, dtype="float32", **kw))


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    """Point the plan cache at a per-test file; returns its path."""
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv("TMHPVSIM_AUTOTUNE_CACHE", path)
    return path


def _collapse_stage2(monkeypatch):
    for name, value in (("CANDIDATE_COMPUTE_DTYPES", ("f32",)),
                        ("CANDIDATE_KERNEL_IMPLS", ("exact",)),
                        ("CANDIDATE_RNG_BATCHES", ("scan",)),
                        ("CANDIDATE_GEOM_STRIDES", (1,))):
        monkeypatch.setattr(tat, name, value)


@pytest.fixture
def fake_prober(monkeypatch):
    """tests/test_autotune.py's fake rater, on the port."""
    def fake(config, plan, n_timed=tat.PROBE_TIMED_BLOCKS, device=None):
        if (plan.block_impl == "wide" and plan.scan_unroll == 4
                and plan.slab_chains == config.n_chains):
            return 1000.0
        return 10.0 + plan.scan_unroll

    monkeypatch.setattr(tat, "probe_plan", fake)
    _collapse_stage2(monkeypatch)
    return fake


def probes_during(fn):
    """(result, number of candidate probes performed by fn())."""
    before = tat.PROBE_COUNT
    out = fn()
    return out, tat.PROBE_COUNT - before


def resolve(cfg, **kw):
    return tat.resolve_plan(cfg, device="cpu", **kw)


# --------------------------------------------------------------------------
# the grid is the JAX grid
# --------------------------------------------------------------------------

def _fleets(n):
    return (dict(fleet=JFleet.synthetic(n, seed=2), n_chains=n),
            dict(fleet=TFleet.synthetic(n, seed=2), n_chains=n))


GRIDS = {
    "auto": {},
    "pinned_impl": dict(block_impl="scan2", stats_fusion="split"),
    "pinned_dispatch": dict(blocks_per_dispatch=3),
    "pinned_precision": dict(compute_dtype="bf16", kernel_impl="table"),
    "pinned_restructure": dict(rng_batch="block", geom_stride=60),
    "telemetry": dict(telemetry="full", scan_unroll=2),
    "wide_batch": dict(n_chains=70000),
    "rbg": dict(prng_impl="rbg"),
}


@pytest.mark.parametrize("slabs", [True, False])
@pytest.mark.parametrize("name", [*GRIDS, "fleet"])
def test_grid_is_the_jax_grid(name, slabs):
    """The structural grid and the stage-2 variants of its first candidate
    are the JAX package's, record for record and in order, with the same
    telemetry escalation."""
    if name == "fleet":
        jkw, tkw = _fleets(6)
    else:
        jkw = tkw = GRIDS[name]
    jc = jcfg_of(**dict(dict(stats_fusion="fused"), **jkw))
    tc = tcfg_of(**dict(dict(stats_fusion="fused"), **tkw))
    jg = jat.candidate_plans(jc, slabs=slabs)
    tg = tat.candidate_plans(tc, slabs=slabs)
    assert [jat._candidate_record(p) for p in jg] == \
        [tat._candidate_record(p) for p in tg]
    assert {p.source for p in tg} == {"probe"}
    jv = jat._precision_variants(jc, jg[0])
    tv = tat._precision_variants(tc, tg[0])
    assert [(jat._candidate_record(p), p.telemetry) for p in jv] == \
        [(tat._candidate_record(p), p.telemetry) for p in tv]


def test_static_plan_is_the_jax_static_plan():
    """``static_plan`` is the JAX package's on an accelerator (its 'auto'
    formulation and topology resolve by backend), with no slabbing."""
    for kw in ({}, dict(compute_dtype="bf16"), dict(rng_batch="block",
                                                    geom_stride=60)):
        j = jat.static_plan(jcfg_of(block_impl="scan", stats_fusion="fused",
                                    **kw))
        t = tat.static_plan(tcfg_of(**kw))
        assert tat._candidate_record(t) == jat._candidate_record(j)
        assert (t.source, t.telemetry, t.slab_chains) == (
            j.source, j.telemetry, SMALL["n_chains"])


# --------------------------------------------------------------------------
# the plan cache (tests/test_autotune.py TestPlanCache, on the port)
# --------------------------------------------------------------------------

def test_auto_probes_once_then_hits(tmp_cache, fake_prober):
    cfg = tcfg_of(tune="auto")
    plan, n1 = probes_during(lambda: resolve(cfg))
    assert n1 == len(tat.candidate_plans(cfg))
    assert plan.source == "probe"
    assert (plan.block_impl, plan.scan_unroll) == tuple(WINNER.values())
    assert plan.slab_chains == cfg.n_chains
    again, n2 = probes_during(lambda: resolve(cfg))
    assert n2 == 0
    assert again.source == "cache"
    assert dataclasses.replace(again, source=plan.source) == plan


def test_cache_round_trips_through_json(tmp_cache, fake_prober):
    cfg = tcfg_of(tune="auto")
    resolve(cfg)
    with open(tmp_cache) as f:
        entry = json.load(f)[tat.plan_key(cfg, device="cpu")]
    assert entry["plan"]["block_impl"] == WINNER["block_impl"]
    assert entry["plan"]["scan_unroll"] == WINNER["scan_unroll"]
    assert set(entry) == {"plan", "candidates", "ts"}  # no compile_s: fake
    cands = tat.cached_candidates(cfg, device="cpu")
    assert len(cands) == len(tat.candidate_plans(cfg))
    assert all("rate" in c for c in cands)


def test_key_mismatch_reprobes(tmp_cache, fake_prober):
    resolve(tcfg_of(tune="auto"))
    other = tcfg_of(tune="auto", n_chains=5)
    plan, n = probes_during(lambda: resolve(other))
    assert n == len(tat.candidate_plans(other))
    assert plan.source == "probe"
    with open(tmp_cache) as f:
        assert len(json.load(f)) == 2


def test_off_is_static_and_free(tmp_cache, fake_prober):
    cfg = tcfg_of(tune="off")
    plan, n = probes_during(lambda: resolve(cfg))
    assert n == 0
    assert plan.source == "static"
    assert plan.slab_chains == cfg.n_chains
    assert not os.path.exists(tmp_cache)


def test_force_reprobes_on_a_hit(tmp_cache, fake_prober):
    resolve(tcfg_of(tune="auto"))
    cfg = tcfg_of(tune="force")
    plan, n = probes_during(lambda: resolve(cfg))
    assert n == len(tat.candidate_plans(cfg))
    assert plan.source == "probe"


def test_corrupt_cache_file_tolerated(tmp_cache, fake_prober):
    with open(tmp_cache, "w") as f:
        f.write("{not json")
    cfg = tcfg_of(tune="auto")
    plan, n = probes_during(lambda: resolve(cfg))
    assert n > 0 and plan.source == "probe"
    with open(tmp_cache) as f:
        assert tat.plan_key(cfg, device="cpu") in json.load(f)


def test_malformed_entry_reprobed(tmp_cache, fake_prober):
    cfg = tcfg_of(tune="auto")
    with open(tmp_cache, "w") as f:
        json.dump({tat.plan_key(cfg, device="cpu"): {"plan": {
            "block_impl": "warp", "scan_unroll": 8,
            "stats_fusion": "split", "slab_chains": 3}}}, f)
    plan, n = probes_during(lambda: resolve(cfg))
    assert n > 0 and plan.source == "probe"


def test_bad_tune_value_raises(tmp_cache, fake_prober):
    with pytest.raises(ValueError, match="tune"):
        resolve(tcfg_of(tune="always"))


def test_all_candidates_failing_falls_back_static(tmp_cache, monkeypatch):
    def boom(config, plan, n_timed=2, device=None):
        raise RuntimeError("no device")

    monkeypatch.setattr(tat, "probe_plan", boom)
    cfg = tcfg_of(tune="auto")
    plan, n = probes_during(lambda: resolve(cfg))
    assert n == len(tat.candidate_plans(cfg))
    assert plan.source == "static"
    assert not os.path.exists(tmp_cache)


@pytest.mark.parametrize("pin", [
    dict(blocks_per_dispatch=2), dict(compute_dtype="bf16"),
    dict(kernel_impl="table"), dict(rng_batch="block"),
    dict(geom_stride=30)])
def test_pins_override_a_hit(tmp_cache, fake_prober, pin):
    """An explicit pin overrides the cached value on a hit (the JAX
    ``resolve_plan``), and the telemetry escalates under the final
    compute dtype."""
    resolve(tcfg_of(tune="auto"))
    cfg = tcfg_of(tune="auto", **pin)
    plan, n = probes_during(lambda: resolve(cfg))
    assert n == 0 and plan.source == "cache"
    assert (plan.block_impl, plan.scan_unroll) == tuple(WINNER.values())
    (field, value), = pin.items()
    assert getattr(plan, field) == value
    assert plan.telemetry == ("light" if field == "compute_dtype" else "off")


def test_cached_plan_missing_axes_means_defaults(tmp_cache, fake_prober):
    cfg = tcfg_of(tune="auto")
    resolve(cfg)
    with open(tmp_cache) as f:
        cache = json.load(f)
    (key, entry), = cache.items()
    for axis in ("rng_batch", "geom_stride", "blocks_per_dispatch",
                 "compute_dtype", "kernel_impl"):
        entry["plan"].pop(axis)
    with open(tmp_cache, "w") as f:
        json.dump({key: entry}, f)
    plan, n = probes_during(lambda: resolve(cfg))
    assert n == 0
    assert (plan.rng_batch, plan.geom_stride, plan.blocks_per_dispatch,
            plan.compute_dtype, plan.kernel_impl) == (
        "scan", 1, 1, "f32", "exact")


def test_plan_key_shape():
    """The key's parts: card name ('cpu'), backend, n_chains, block_s,
    dtype, prng_impl, engine version, and a fleet's length and digest."""
    assert tat.plan_key(tcfg_of(), device="cpu") == \
        "cpu|cpu|3|3600|float32|threefry2x32|1"
    fleet = TFleet.synthetic(6, seed=2)
    key = tat.plan_key(tcfg_of(fleet=fleet, n_chains=6), device="cpu")
    assert key.endswith(f"|fleet6-{fleet.digest()[:12]}")
    jfleet = JFleet.synthetic(6, seed=2)
    assert fleet.digest() == jfleet.digest()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_entries_cross_between_the_packages(tmp_path, writer):
    """An entry written by either package's ``_store_plan`` loads through
    the other's ``_plan_from_entry`` to the same tuned fields."""
    fields = dict(block_impl="scan2", scan_unroll=12, stats_fusion="split",
                  slab_chains=16384, blocks_per_dispatch=4,
                  compute_dtype="bf16", kernel_impl="table",
                  rng_batch="block", geom_stride=60)
    path = str(tmp_path / "c.json")
    cands = [dict(fields, rate=5.0, compile_s=1.25)]
    if writer == "jax":
        jat._store_plan(path, "k", jat.Plan(**fields), cands)
    else:
        tat._store_plan(path, "k", tcfg.Plan(**fields), cands)
    with open(path) as f:
        entry = json.load(f)["k"]
    assert entry["compile_s"] == 1.25
    t = tat._plan_from_entry(entry)
    j = jat._plan_from_entry(entry)
    assert tat._candidate_record(t) == jat._candidate_record(j) == fields
    assert t.source == j.source == "cache"


# --------------------------------------------------------------------------
# the sentinel gate
# --------------------------------------------------------------------------

def test_gate_failure_is_recorded_and_cannot_win(tmp_cache, monkeypatch):
    """Stage 2 under a gate run that raises ``DriftError`` for bf16: the
    bf16 variants are recorded ``"sentinel": "fail"`` without a rate and
    the fastest passing variant (the table set) wins."""
    def fake(config, plan, n_timed=2, device=None):
        return {("f32", "exact"): 10.0, ("f32", "table"): 20.0}.get(
            (plan.compute_dtype, plan.kernel_impl), 1e9)

    def gate_run(self, *a, **kw):
        if self.plan.compute_dtype == "bf16":
            raise DriftError("bf16 drifted")
        return {}

    monkeypatch.setattr(tat, "probe_plan", fake)
    monkeypatch.setattr(tat, "CANDIDATE_IMPLS", ("scan",))
    monkeypatch.setattr(tat, "CANDIDATE_UNROLLS", (8,))
    monkeypatch.setattr(tat, "CANDIDATE_RNG_BATCHES", ("scan",))
    monkeypatch.setattr(tat, "CANDIDATE_GEOM_STRIDES", (1,))
    monkeypatch.setattr(TSim, "run_reduced", gate_run)
    cfg = tcfg_of(tune="auto")
    plan = resolve(cfg)
    assert (plan.compute_dtype, plan.kernel_impl, plan.telemetry) == (
        "f32", "table", "off")
    recs = tat.cached_candidates(cfg, device="cpu")
    gated = {(r["compute_dtype"], r["kernel_impl"]): r for r in recs
             if "sentinel" in r}
    assert set(gated) == {("bf16", "exact"), ("bf16", "table"),
                          ("f32", "table")}
    for key in (("bf16", "exact"), ("bf16", "table")):
        assert gated[key]["sentinel"] == "fail" and "rate" not in gated[key]
    assert gated[("f32", "table")]["sentinel"] == "pass"


def test_gate_rejects_a_run_that_cannot_finish(monkeypatch):
    def broken(self, *a, **kw):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(TSim, "run_reduced", broken)
    cfg = tcfg_of()
    assert not tat._sentinel_gate(cfg, tat.static_plan(cfg), device="cpu")


# --------------------------------------------------------------------------
# a tuned run keeps the static run's bits
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pick", [
    dict(block_impl="wide", blocks_per_dispatch=4),
    dict(block_impl="scan", slab_chains=2),
    dict(block_impl="scan2", scan_unroll=1, blocks_per_dispatch=4,
         slab_chains=2)])
def test_tuned_run_keeps_the_static_bits(tmp_cache, monkeypatch, pick):
    """A float32 / exact plan the tuner picks (the formulation, K = 4, a
    slab below n_chains) gives the static run's rows bit for bit under
    threefry2x32."""
    def fake(config, plan, n_timed=2, device=None):
        return 1000.0 if all(getattr(plan, f) == v
                             for f, v in pick.items()) else 1.0

    monkeypatch.setattr(tat, "probe_plan", fake)
    monkeypatch.setattr(tat, "CANDIDATE_SLAB_CHAINS", (None, 2))
    _collapse_stage2(monkeypatch)
    tuned = TSim(tcfg.SimConfig(tune="auto", **BITS), device="cpu")
    assert tuned.plan.source == "probe"
    assert all(getattr(tuned.plan, f) == v for f, v in pick.items())
    static = TSim(tcfg.SimConfig(**BITS), device="cpu").run_reduced()
    got = tuned.run_reduced()
    for k, v in static.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


# --------------------------------------------------------------------------
# the mesh (tests/test_autotune.py TestMeshPlan, on the port)
# --------------------------------------------------------------------------

def test_mesh_plan_pins_slabbing_off(tmp_cache, fake_prober):
    """Probed at the per-rank shape (2 of 8 chains on 4 ranks), without
    the slab axis; the plan never slabs a rank's chains."""
    cfg = tcfg_of(n_chains=8, tune="auto")
    plan, n = probes_during(
        lambda: tat.resolve_plan_for_mesh(cfg, n_dev=4, device="cpu"))
    per = dataclasses.replace(cfg, n_chains=2)
    assert n == len(tat.candidate_plans(per, slabs=False))
    assert plan.slab_chains == 2 and plan.source == "probe"
    assert tat.cached_candidates(per, device="cpu")
    jplan = jat.resolve_plan_for_mesh(jcfg_of(n_chains=8), n_dev=4)
    assert jplan.slab_chains >= 2  # the JAX pin, the whole run's chains


def test_mesh_plan_off_is_static(tmp_cache, fake_prober):
    cfg = tcfg_of(n_chains=8, tune="off")
    plan, n = probes_during(
        lambda: tat.resolve_plan_for_mesh(cfg, n_dev=4, device="cpu"))
    assert n == 0 and plan.source == "static"
    assert plan.slab_chains == 2
    assert not os.path.exists(tmp_cache)


def test_broadcast_plan_on_another_rank(monkeypatch):
    """A rank past 0 takes rank 0's tuned fields from the broadcast, as
    'broadcast', and escalates its telemetry under rank 0's dtype."""
    from tmhpvsim_torch.parallel import distributed

    sent = dataclasses.replace(tat.static_plan(tcfg_of()),
                               block_impl="scan2", scan_unroll=12,
                               stats_fusion="split", slab_chains=5,
                               blocks_per_dispatch=4, compute_dtype="bf16",
                               kernel_impl="table", rng_batch="block",
                               geom_stride=60, source="probe",
                               telemetry="light")
    enc = []

    def bcast(values, device=None):
        enc.append(list(values))
        return [int(v) for v in values]

    monkeypatch.setattr(distributed, "broadcast_ints", bcast)
    monkeypatch.setattr(distributed, "world", lambda: (0, 2))
    assert tat.broadcast_plan(sent) == sent
    own = tat.static_plan(tcfg_of())
    monkeypatch.setattr(distributed, "broadcast_ints",
                        lambda values, device=None: enc[0])
    monkeypatch.setattr(distributed, "world", lambda: (1, 2))
    got = tat.broadcast_plan(own)
    assert tat._candidate_record(got) == tat._candidate_record(sent)
    assert (got.source, got.telemetry) == ("broadcast", "light")
    monkeypatch.setattr(distributed, "world", lambda: (0, 1))
    assert tat.broadcast_plan(own) is own


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def _pvsim(tmp_path, *extra):
    from tmhpvsim_torch.cli import main

    out, rep = str(tmp_path / "r.csv"), str(tmp_path / "r.json")
    assert main(["pvsim", out, "--output", "reduce", "--no-realtime",
                 "--chains", "3", "--duration", "120", "--block-s", "60",
                 "--seed", "7", "--start", BITS["start"], "--device", "cpu",
                 "--run-report", rep, *extra]) == 0
    with open(rep) as f:
        return json.load(f)


def test_cli_tune_probes_then_hits(tmp_path, tmp_cache, fake_prober,
                                   monkeypatch):
    """``pvsim --tune auto --run-report`` twice in one process: the plan
    is probed, then taken from the cache."""
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    first = _pvsim(tmp_path, "--tune", "auto")
    assert first["plan"]["source"] == "probe"
    assert first["plan"]["block_impl"] == WINNER["block_impl"]
    second = _pvsim(tmp_path, "--tune", "auto")
    assert second["plan"] == dict(first["plan"], source="cache")
    assert _pvsim(tmp_path)["plan"]["source"] == "static"


def test_cli_tune_choices_are_the_jax_choices():
    from tmhpvsim_torch.cli import _parser
    from tmhpvsim_tpu.cli import pvsim as jpvsim
    from tmhpvsim_tpu.cli import serve as jserve

    sub = next(a for a in _parser()._actions if a.dest == "command")
    for name, jcmd in (("pvsim", jpvsim), ("serve", jserve)):
        opt = next(a for a in sub.choices[name]._actions
                   if a.dest == "tune")
        jopt = next(p for p in jcmd.params if p.name == "tune")
        assert (list(opt.choices), opt.default) == (
            list(jopt.type.choices), jopt.default)


def test_cli_tune_needs_the_device_backend(capsys):
    from tmhpvsim_torch.cli import main

    with pytest.raises(SystemExit):
        main(["pvsim", "out.csv", "--backend", "asyncio", "--tune", "auto"])
    assert "--tune requires --backend=device" in capsys.readouterr().err


def test_serve_tune_reaches_the_served_config(monkeypatch):
    from tmhpvsim_torch.cli import main
    from tmhpvsim_torch.serve import server

    seen = []

    async def serve_main(cfg):
        seen.append(cfg)

    monkeypatch.setattr(server, "serve_main", serve_main)
    assert main(["serve", "--device", "cpu", "--chains", "2", "--duration",
                 "120", "--tune", "auto"]) == 0
    assert seen[0].sim.tune == "auto"


# --------------------------------------------------------------------------
# the executor's build report
# --------------------------------------------------------------------------

def test_executor_section_on_the_cpu(tmp_path, monkeypatch):
    """With ``--compile-cache DIR`` on the CPU (nothing built) the section
    holds zero build counts, the run's dispatch groups and the build
    directory."""
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    cache = tmp_path / "kcache"
    doc = _pvsim(tmp_path, "--compile-cache", str(cache),
                 "--blocks-per-dispatch", "2")
    assert doc["executor"] == {"compile_warm": 0, "compile_cold": 0,
                               "dispatches": 1, "blocks_per_dispatch": 2,
                               "cache_dir": str(cache)}


def test_executor_doc_is_none_without_a_record(monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", build.DEFAULT_BUILD_DIR)
    assert compilecache.executor_doc(tmetrics.MetricsRegistry()) is None


def test_executor_section_is_the_jax_section():
    """The section's keys are the JAX report's ``executor_section`` but
    the AOT warm-up's, which has no counterpart in the port."""
    reg = tmetrics.MetricsRegistry()
    reg.counter("executor.compile_warm_total").inc(18)
    reg.counter("executor.dispatches_total").inc(20)
    reg.gauge("executor.blocks_per_dispatch").set(4)
    snap = reg.snapshot()
    want = jreport.executor_section(snap)
    for k in ("aot_warmup", "aot_warmup_errors"):
        assert want.pop(k) == 0
    assert compilecache.executor_section(snap) == want
    doc = compilecache.executor_doc(reg)
    assert doc == dict(want, cache_dir=build.BUILD_DIR)
