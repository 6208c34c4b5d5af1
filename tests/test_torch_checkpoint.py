"""The port's checkpoint format (tmhpvsim_torch/engine/checkpoint.py) on the
CPU: the round trip, the refusals, the generations and their integrity
fallback, the async writer, the run report's checkpoint section, and the
format against the JAX package's (the config echo, the flat keys and the
JAX ``tools/ckpt_report.py`` verifying a port checkpoint).

Port meets port here: every comparison is bit for bit.  The state is a
small run's (8 chains, 360 s from 10:00 in 120 s blocks) after its first
block.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tmhpvsim_torch import config as tcfg
from tmhpvsim_torch.engine import checkpoint as ckpt
from tmhpvsim_torch.engine.simulation import Simulation as TSim
from tmhpvsim_torch.fleet import FleetParams as TFleet
from tmhpvsim_torch.obs import report as trep
from tmhpvsim_torch.obs.metrics import MetricsRegistry, use_registry
from tmhpvsim_tpu import config as jcfg
from tmhpvsim_tpu.engine import checkpoint as jckpt
from tmhpvsim_tpu.fleet import FleetParams as JFleet
from tmhpvsim_tpu.obs import report as jrep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = dict(start="2019-09-05 10:00:00", duration_s=360, n_chains=8,
             seed=13, block_s=120)


def cfg(**kw):
    return tcfg.SimConfig(**dict(SHAPE, **kw))


@pytest.fixture(scope="module")
def saved():
    """A run's state and accumulator after its first block (tensors)."""
    sim = TSim(cfg(output="reduce"), device="cpu")
    out = {}

    def hook(bi, state, acc):
        if bi == 0:
            out.update(state=ckpt._unflatten(ckpt._flatten(state)),
                       acc=ckpt._unflatten(ckpt._flatten(acc)),
                       tstate={k: v for k, v in state.items()})
    sim.run_reduced(on_block=hook)
    out["sim"] = sim
    return out


def _flat_eq(a, b):
    fa, fb = ckpt._flatten(a), ckpt._flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _save(path, tree, nb=1, **kw):
    ckpt.save(str(path), tree, nb, cfg(output="reduce"), **kw)


def test_roundtrip_identical_tree(saved, tmp_path):
    """save then load gives the tree back, leaf for leaf, in the JAX
    layout (uint32 key data), whether the tree went in as tensors or as
    numpy."""
    path = tmp_path / "s.npz"
    tree = {"state": saved["state"], "acc": saved["acc"]}
    _save(path, tree)
    got, nb = ckpt.load(str(path), cfg(output="reduce"))
    assert nb == 1
    _flat_eq(got, tree)
    assert got["state"]["k_scan"].dtype == np.uint32
    _save(tmp_path / "t.npz", {"state": saved["tstate"]})
    got, _ = ckpt.load(str(tmp_path / "t.npz"))
    _flat_eq(got["state"], saved["state"])


def test_flat_keys_and_meta_are_the_jax_packages(saved, tmp_path):
    """The npz holds the JAX package's keys (``key:`` key data, '/' paths,
    ``__meta__``); the meta names the config's key implementation and
    echoes the config as the JAX package does."""
    path = tmp_path / "m.npz"
    _save(path, {"state": saved["state"], "acc": saved["acc"]})
    with np.load(path) as z:
        files = set(z.files)
        meta = json.loads(str(z["__meta__"]))
    assert {"key:state/k_arr", "state/carry/sec", "acc/n_seconds",
            "__meta__"} <= files
    assert list(meta)[:3] == ["next_block", "prng_impl", "config"]
    assert meta["prng_impl"] == "threefry2x32"
    jc = jcfg.SimConfig(dtype="float32", output="reduce", **SHAPE)
    assert meta["config"] == json.loads(json.dumps(jckpt._config_echo(jc)))


def _echo_pairs():
    grid = ((46, 50), (9, 13), 2, 2)
    return {
        "default": ({}, {}),
        "rbg": (dict(prng_impl="rbg"), dict(prng_impl="rbg")),
        "grid": (dict(site_grid=tcfg.SiteGrid.regular(*grid)),
                 dict(site_grid=jcfg.SiteGrid.regular(*grid))),
        "fleet": (dict(fleet=TFleet.synthetic(12, seed=3)),
                  dict(fleet=JFleet.synthetic(12, seed=3))),
        "options": (dict(meter_max_w=6000.0, output="ensemble"),
                    dict(meter_max_w=6000.0, output="ensemble")),
    }


@pytest.mark.parametrize("case", list(_echo_pairs()))
def test_config_echo_is_the_jax_packages(case):
    """Each package refuses the other's checkpoint unless the config echo
    is the same JSON: a shared site, rbg keys, a site grid, a fleet (its
    digest) and other identity fields, through each package's chain
    resolution (a fleet derives its site grid)."""
    from tmhpvsim_torch.engine.simulation import resolve_chains
    from tmhpvsim_tpu.engine import Simulation as JSim

    tkw, jkw = _echo_pairs()[case]
    tc = resolve_chains(cfg(**tkw))
    jc = JSim(jcfg.SimConfig(dtype="float32", **dict(SHAPE, **jkw))).config
    got = json.loads(json.dumps(ckpt._config_echo(tc)))
    want = json.loads(json.dumps(jckpt._config_echo(jc)))
    assert got == want


def test_save_without_config_raises(saved, tmp_path):
    """The key implementation is written from the config, never guessed
    from the key width (rbg and unsafe_rbg data are both 4 words)."""
    with pytest.raises(ValueError, match="needs the run's config"):
        ckpt.save(str(tmp_path / "b.npz"), {"state": saved["state"]}, 1)
    w = ckpt.AsyncCheckpointWriter(str(tmp_path / "w.npz"))
    with pytest.raises(ValueError, match="needs the run's config"):
        w.submit({"state": saved["state"]}, 1)
    w.close(timeout=10)
    assert not os.path.exists(tmp_path / "b.npz")
    assert not os.path.exists(tmp_path / "w.npz")


def test_key_width_must_match_the_config(saved, tmp_path):
    """A threefry state saved under an unsafe_rbg config is refused, and a
    saved unsafe_rbg run is labelled unsafe_rbg."""
    with pytest.raises(ValueError, match="unsafe_rbg key data"):
        ckpt.save(str(tmp_path / "u.npz"), saved["state"], 1,
                  cfg(prng_impl="unsafe_rbg"))
    sim = TSim(cfg(prng_impl="unsafe_rbg"), device="cpu")
    state = sim.init_state()
    ckpt.save(str(tmp_path / "u.npz"), state, 0, sim.config)
    assert ckpt.peek_meta(str(tmp_path / "u.npz"))["prng_impl"] == \
        "unsafe_rbg"


def test_config_mismatch_rejected(saved, tmp_path):
    path = str(tmp_path / "s.npz")
    _save(path, {"state": saved["state"]})
    with pytest.raises(ValueError, match="different configuration"):
        ckpt.load(path, cfg(output="reduce", seed=14))
    with pytest.raises(ValueError, match="prng_impl"):
        ckpt.load(path, cfg(output="reduce", prng_impl="rbg"))


def test_old_stream_layout_checkpoint_refused(saved, tmp_path,
                                              monkeypatch):
    path = str(tmp_path / "v1.npz")
    monkeypatch.setattr(ckpt, "RNG_STREAM_VERSION", 1)
    _save(path, {"state": saved["state"]})
    monkeypatch.undo()
    with pytest.raises(ValueError, match="rng_stream"):
        ckpt.load(path, cfg(output="reduce"))


def _resume(state=None, acc=None, mode="reduce"):
    sim = TSim(cfg(output=mode), device="cpu")
    if mode == "reduce":
        return sim.run_reduced(state=state, acc=acc, start_block=1)
    return list(sim.run_blocks(state=state, start_block=1))


def test_foreign_state_leaf_named_in_error(saved):
    state = dict(saved["state"])
    state["arrays"] = state.pop("cc_carry")
    with pytest.raises(ValueError, match=r"missing leaves \['cc_carry'\], "
                       r"unexpected leaves \['arrays'\]"):
        _resume(state, saved["acc"])


def test_foreign_dtype_leaf_named_in_error(saved):
    state = dict(saved["state"])
    state["cc_carry"] = state["cc_carry"].astype(np.float64)
    with pytest.raises(ValueError, match="cc_carry: expected"):
        _resume(state, mode="trace")
    tstate = dict(saved["tstate"])
    tstate["k_arr"] = tstate["k_arr"].to(torch.int32)
    with pytest.raises(ValueError, match="k_arr: expected"):
        _resume(tstate, mode="trace")


def test_foreign_and_missing_acc_named_in_error(saved):
    acc = dict(saved["acc"])
    acc["bogus_stat"] = acc.pop("pv_sum")
    with pytest.raises(ValueError, match="bogus_stat"):
        _resume(saved["state"], acc)
    with pytest.raises(ValueError, match="accumulator"):
        _resume(saved["state"])


def test_chain_count_checked_on_placement(saved):
    state = ckpt._unflatten({k: v[:4] for k, v in
                             ckpt._flatten(saved["state"]).items()})
    with pytest.raises(ValueError, match="do not hold this run's 8 chains"):
        _resume(state, saved["acc"])


def test_matching_layout_passes_check(saved):
    sim = TSim(cfg(output="reduce"), device="cpu")
    assert sim._check_resume_layout(saved["state"]) is saved["state"]
    assert sim._check_resume_layout(saved["acc"], "acc") is saved["acc"]
    assert sim._check_resume_layout(saved["tstate"]) is saved["tstate"]


# ---------------------------------------------------------------------------
# generations, integrity, typed errors
# ---------------------------------------------------------------------------

def test_rotation_keeps_n_generations(saved, tmp_path):
    path = str(tmp_path / "r.npz")
    for nb in range(1, 6):
        _save(path, saved["state"], nb, keep=3)
    man = ckpt.read_manifest(path)
    assert man["format"] == ckpt.MANIFEST_FORMAT
    assert man["latest"] == 5 and man["keep"] == 3
    assert [e["gen"] for e in man["generations"]] == [3, 4, 5]
    for g in (1, 2):
        assert not os.path.exists(f"{path}.g{g}")
    with open(path, "rb") as a, open(f"{path}.g5", "rb") as b:
        assert a.read() == b.read()
    assert ckpt.load(path, cfg(output="reduce"))[1] == 5


def test_load_survives_anchor_loss(saved, tmp_path):
    path = str(tmp_path / "a.npz")
    _save(path, saved["state"], 1)
    _save(path, saved["state"], 2)
    os.remove(path)
    assert ckpt.resumable(path)
    state, nb = ckpt.load(path, cfg(output="reduce"))
    assert nb == 2
    _flat_eq(state, saved["state"])
    assert not ckpt.resumable(str(tmp_path / "never_saved.npz"))


@pytest.mark.parametrize("where", ["header", "mid", "tail"])
def test_torn_write_falls_back_to_last_good_generation(saved, tmp_path,
                                                       where):
    path = str(tmp_path / f"t_{where}.npz")
    _save(path, saved["state"], 1)
    other = dict(saved["state"], cc0=saved["state"]["cc0"] + 1)
    _save(path, other, 2)
    size = os.path.getsize(path)
    os.truncate(path, {"header": 8, "mid": size // 2,
                       "tail": size - 8}[where])
    reg = MetricsRegistry()
    with use_registry(reg):
        state, nb = ckpt.load(path, cfg(output="reduce"))
    assert nb == 1
    _flat_eq(state, saved["state"])
    c = reg.snapshot()["counters"]
    assert c["checkpoint.verify_fail_total"] == 1.0
    assert c["checkpoint.fallback_total"] == 1.0


def test_bitflip_detected_by_checksum(saved, tmp_path):
    path = str(tmp_path / "b.npz")
    _save(path, saved["state"], 1)
    _save(path, saved["state"], 2)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        byte = f.read(1)
        f.seek(size // 2)
        f.write(bytes([byte[0] ^ 0xFF]))
    assert os.path.getsize(path) == size
    assert ckpt.load(path, cfg(output="reduce"))[1] == 1


def test_all_generations_torn_raises_corrupt_error(saved, tmp_path):
    path = str(tmp_path / "dead.npz")
    _save(path, saved["state"], 1, keep=1)
    os.truncate(path, 4)
    with pytest.raises(ckpt.CheckpointCorruptError) as ei:
        ckpt.load(path, cfg(output="reduce"))
    msg = str(ei.value)
    assert "no generation passed integrity verification" in msg
    assert "delete the checkpoint" in msg
    assert isinstance(ei.value, ckpt.CheckpointError)


def test_missing_garbage_and_metaless_files_typed_errors(tmp_path):
    path = str(tmp_path / "nope.npz")
    with pytest.raises(ckpt.CheckpointError, match="missing"):
        ckpt.load(path)
    with pytest.raises(ckpt.CheckpointError, match="missing"):
        ckpt.peek_meta(path)
    junk = tmp_path / "junk.npz"
    junk.write_bytes(b"this is not an npz checkpoint")
    with pytest.raises(ckpt.CheckpointError,
                       match="unreadable as a checkpoint npz"):
        ckpt.load(str(junk))
    with pytest.raises(ckpt.CheckpointError, match="no readable metadata"):
        ckpt.peek_meta(str(junk))
    bare = str(tmp_path / "m.npz")
    np.savez(bare, a=np.zeros(3))
    with pytest.raises(ckpt.CheckpointError, match="KeyError"):
        ckpt.load(bare)


def test_legacy_single_file_loads_as_generation_zero(saved, tmp_path):
    path = str(tmp_path / "legacy.npz")
    _save(path, saved["state"], 1)
    os.remove(ckpt.manifest_path(path))
    os.remove(path + ".g1")
    assert ckpt.read_manifest(path) is None and ckpt.resumable(path)
    state, nb = ckpt.load(path, cfg(output="reduce"))
    assert nb == 1
    _flat_eq(state, saved["state"])
    _save(path, saved["state"], 2)
    assert ckpt.read_manifest(path)["latest"] == 1
    assert ckpt.load(path)[1] == 2


def test_peek_meta_falls_back_over_torn_anchor(saved, tmp_path):
    path = str(tmp_path / "p.npz")
    _save(path, saved["state"], 1)
    _save(path, saved["state"], 2)
    os.truncate(path, 16)  # the anchor and g2 share an inode
    assert ckpt.peek_meta(path)["next_block"] == 1


# ---------------------------------------------------------------------------
# the async writer
# ---------------------------------------------------------------------------

def test_async_writer_matches_sync(saved, tmp_path):
    spath, apath = str(tmp_path / "sync.npz"), str(tmp_path / "async.npz")
    tree = {"state": saved["tstate"]}
    _save(spath, tree)
    reg = MetricsRegistry()
    with use_registry(reg):
        w = ckpt.AsyncCheckpointWriter(apath, config=cfg(output="reduce"))
        w.submit(tree, 1)
        assert w.flush(timeout=60)
        w.close(timeout=60)
    sa, na = ckpt.load(apath, cfg(output="reduce"))
    ss, ns = ckpt.load(spath, cfg(output="reduce"))
    assert na == ns == 1
    _flat_eq(sa, ss)
    assert reg.snapshot()["counters"]["checkpoint.async_saves_total"] == 1


def test_async_writer_takes_host_copies(saved, tmp_path):
    """submit copies the tree to host memory before it returns: a state
    the run then updates in place does not reach the file."""
    path = str(tmp_path / "h.npz")
    state = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
             for k, v in saved["tstate"].items()}
    want = ckpt._flatten(state)
    with use_registry(MetricsRegistry()):
        w = ckpt.AsyncCheckpointWriter(path, config=cfg(output="reduce"))
        w.submit(state, 1)
        state["cc0"].add_(1.0)
        w.close(timeout=60)
    got = ckpt._flatten(ckpt.load(path)[0])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_async_writer_latest_wins(saved, tmp_path, monkeypatch):
    """While the writer thread writes one snapshot (held at a gate here),
    a newer submit replaces the one waiting: the newest is what lands,
    the replaced one is counted as dropped."""
    import threading

    gate, entered = threading.Event(), threading.Event()
    real = ckpt._write_generation

    def held(*a, **kw):
        entered.set()
        assert gate.wait(30)
        return real(*a, **kw)

    monkeypatch.setattr(ckpt, "_write_generation", held)
    path = str(tmp_path / "lw.npz")
    reg = MetricsRegistry()
    with use_registry(reg):
        w = ckpt.AsyncCheckpointWriter(path, config=cfg(output="reduce"),
                                       keep=5)
        try:
            w.submit(saved["state"], 1)   # taken: the writer is busy
            assert entered.wait(30)
            w.submit(saved["state"], 2)   # waits
            w.submit(saved["state"], 3)   # replaces 2: latest wins
        finally:
            gate.set()
        w.close(timeout=60)
    assert ckpt.load(path)[1] == 3
    assert [e["next_block"] for e in
            ckpt.read_manifest(path)["generations"]] == [1, 3]
    c = reg.snapshot()["counters"]
    assert c["checkpoint.async_dropped_total"] == 1.0
    assert c["checkpoint.async_saves_total"] == 2.0


def test_async_writer_under_contention(saved, tmp_path):
    """Many submits while the writer thread writes: every submit is
    written or counted as dropped, and the file holds the last one."""
    reg = MetricsRegistry()
    with use_registry(reg):
        w = ckpt.AsyncCheckpointWriter(str(tmp_path / "c.npz"),
                                       config=cfg(output="reduce"), keep=2)
        for nb in range(1, 41):
            w.submit(saved["state"], nb)
        w.close(timeout=60)
    c = reg.snapshot()["counters"]
    assert c["checkpoint.async_saves_total"] + \
        c.get("checkpoint.async_dropped_total", 0) == 40
    assert ckpt.load(str(tmp_path / "c.npz"))[1] == 40


def test_async_writer_close_raises_on_final_failure(saved, tmp_path):
    """A run must not finish pretending its last snapshot is durable:
    close() raises when the final write failed (here its directory is
    missing)."""
    reg = MetricsRegistry()
    with use_registry(reg):
        w = ckpt.AsyncCheckpointWriter(str(tmp_path / "gone" / "x.npz"),
                                       config=cfg(output="reduce"))
        w.submit(saved["state"], 1)
        with pytest.raises(ckpt.CheckpointError,
                           match="final async checkpoint write failed"):
            w.close(timeout=60)
    assert reg.snapshot()["counters"][
        "checkpoint.async_write_failures_total"] == 1.0


# ---------------------------------------------------------------------------
# the report section and the JAX tool
# ---------------------------------------------------------------------------

def test_report_sections_are_the_jax_reports(saved, tmp_path):
    """The run report's checkpoint, slabs and resilience sections derive
    from a registry as the JAX RunReport's ``attach_metrics`` derives
    them (here after a torn newest generation fell back one)."""
    from tmhpvsim_tpu.obs.metrics import MetricsRegistry as JRegistry

    reg = MetricsRegistry()
    path = str(tmp_path / "r.npz")
    with use_registry(reg):
        _save(path, saved["state"], 1)
        _save(path, saved["state"], 2)
        os.truncate(path, 8)
        ckpt.load(path, cfg(output="reduce"))
        reg.counter("checkpoint.preempt_snapshots_total").inc()
        reg.counter("resilience.resumed_total").inc()
        reg.gauge("resilience.resumed_block").set(1)
        reg.gauge("slab.total").set(4)
        reg.gauge("slab.completed").set(4)
    snap = reg.snapshot()
    jreg = JRegistry()
    for name, v in snap["counters"].items():
        jreg.counter(name).inc(v)
    for name, v in snap["gauges"].items():
        jreg.gauge(name).set(v)
    for name, h in snap["histograms"].items():
        for _ in range(h["count"]):
            jreg.histogram(name).observe(h["sum"] / h["count"])
    doc = jrep.RunReport("pvsim")
    doc.attach_metrics(jreg)
    got = trep.registry_sections(snap)
    assert got["slabs"] == doc.slabs == {"completed": 4, "total": 4}
    assert got["resilience"] == doc.resilience
    want = dict(doc.checkpoint)
    for k in ("save_total_s", "restore_total_s"):
        assert got["checkpoint"].pop(k) == pytest.approx(want.pop(k))
    assert got["checkpoint"] == want
    assert (want["saves"], want["restores"], want["verify_failures"],
            want["fallbacks"], want["preempt_snapshots"]) == (2, 1, 1, 1, 1)


def test_jax_ckpt_report_verifies_a_port_checkpoint(saved, tmp_path):
    """The JAX package's ``tools/ckpt_report.py`` reads a port checkpoint's
    generations and verifies them."""
    path = str(tmp_path / "ck.npz")
    for nb in (1, 2):
        _save(path, {"state": saved["state"], "acc": saved["acc"]}, nb)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                     "ckpt_report.py"),
                        path], capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "resumable: yes" in r.stdout
