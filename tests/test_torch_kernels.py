"""The port's kernel wrappers, build and package boundary.

On the CPU every wrapper must run its plain torch version (and count no
launch); on a CUDA tensor it launches its kernel, which the ``cuda``-marked
tests hold against the plain version bit for bit (K1, K2, the K4 trace's
meter) or to the engine tolerance (K3, K6 and the K4 trace's pv:
rtol 2e-5 / atol 1e-2, n_seconds exact; the K4 series sums, reduced in
another order: rtol 1e-6).  Those skip where there is no card;
``python3 chip_smoke.py`` runs the same checks at the main path's shapes.

The three epilogues of the block step share one body: the trace summed
over seconds in second order is the acc fold bit for bit, and the series
is the trace summed over chains.
"""

import ast
import dataclasses
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from tmhpvsim_torch import kernels, rng
from tmhpvsim_torch.config import SimConfig, SiteGrid
from tmhpvsim_torch.engine.simulation import Simulation
from tmhpvsim_torch.kernels import block_step as k3
from tmhpvsim_torch.kernels import build
from tmhpvsim_torch.kernels import tables as k11
from tmhpvsim_torch.kernels import threefry as k1
from tmhpvsim_torch.kernels import windows as k2
from tmhpvsim_torch.fleet import FleetParams
from tmhpvsim_torch.models import solar

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tmhpvsim_torch")
CFG = dict(start="2019-09-05 11:00:00", duration_s=2400, n_chains=6,
           seed=5, block_s=1200)
GRID = SiteGrid.regular((46, 50), (9, 13), 2, 3)
#: the precision levers: the table set alone, and with the stride
TABLE = dict(kernel_impl="table")
LEVERS = dict(kernel_impl="table", geom_stride=60)


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in sorted(files) if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_never_imports_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "tmhpvsim_tpu"), \
                f"{path} imports {name}"


def _block(sim, bi=0):
    state = sim.init_state()
    ins = sim.host_inputs(bi)
    return state, ins


def test_cpu_wrappers_run_plain_versions():
    kernels.reset_counts()
    keys = rng.split(rng.key(3), 16)
    assert torch.equal(k1.split(keys, 5), rng.split(keys, 5))
    assert torch.equal(k1.fold_in(keys, 9), rng.fold_in(keys, 9))
    assert torch.equal(k1.bits(keys, 7), rng.random_bits(keys, (7,)))
    assert torch.equal(k1.uniform(keys), rng.uniform(keys))
    assert torch.equal(k1.normal(keys, 4), rng.normal(keys, (4,)))
    sim = Simulation(SimConfig(**CFG), device="cpu")
    state, ins = _block(sim)
    args = (state["k_arr"], state["k_min"], state["cc_carry"], state["cc0"],
            ins.bounds, ins.mh_idx, ins.mh_frac)
    tw, cw = k2.sampler_windows(*args)
    tp, cp = k2.windows_plain(*args)
    assert torch.equal(cw, cp)
    for k in tp:
        assert torch.equal(tw[k], tp[k]), k
    acc = sim.init_reduce_acc()
    tail = (CFG["duration_s"], 9000.0, 48.12, 0.25)
    head = (tw, ins.rows_i, ins.rows_f, state["k_scan"], state["k_meter"])
    cw3, aw = k3.block_step_acc(*head, state["carry"], acc, *tail)
    cp3, ap = k3.block_step_plain(*head, state["carry"], acc, *tail)
    for k in ap:
        assert torch.equal(aw[k], ap[k]), k
    assert all(c.launches == 0 for c in kernels.COUNTERS)
    assert int(ap["n_seconds"][0]) == 1200
    assert float(ap["pv_max"].max()) > 10


def _epilogue_inputs(site_grid, duration_s=2400, block_i=1, levers=None):
    """One block's inputs (the last one padded when ``duration_s`` ends
    inside it), on the CPU."""
    cfg = SimConfig(**dict(CFG, duration_s=duration_s, site_grid=site_grid,
                           **(levers or {})))
    sim = Simulation(cfg, device="cpu")
    state, ins = _block(sim, block_i)
    tables, _ = k2.sampler_windows(
        state["k_arr"], state["k_min"], state["cc_carry"], state["cc0"],
        ins.bounds, ins.mh_idx, ins.mh_frac)
    head = (tables, ins.rows_i, ins.rows_f, state["k_scan"],
            state["k_meter"], state["carry"])
    return sim, state, ins, head, sim.geometry_args(state)


@pytest.mark.parametrize("grid, levers", [
    (None, None), (GRID, None), (None, TABLE), (GRID, LEVERS)],
    ids=["shared", "site", "shared-table", "strided-table"])
def test_epilogues_share_one_body(grid, levers):
    """acc, series and trace (plain and through the CPU wrappers) run the
    same per-second body: the trace folded over seconds in second order is
    the acc fold bit for bit, its sums over chains are the series, and
    every epilogue leaves the same renewal carry (with either kernel set
    and in the strided mode too)."""
    kernels.reset_counts()
    sim, state, ins, head, (tilt, alb, site) = _epilogue_inputs(
        grid, duration_s=2000, levers=levers)
    dur, mw = sim.config.duration_s, sim.config.meter_max_w
    ks = sim.plan.kernel_impl
    carry_a, acc = k3.block_step_acc(*head, sim.init_reduce_acc(), dur, mw,
                                     tilt, alb, site=site, kernels=ks)
    carry_t, meter, pv_ = k3.block_step_trace(*head, mw, tilt, alb,
                                              site=site, kernels=ks)
    carry_s, m_sum, p_sum = k3.block_step_series(*head, mw, tilt, alb,
                                                 site=site, kernels=ks)
    assert all(c.launches == 0 for c in kernels.COUNTERS)
    for c in (carry_t, carry_s):
        for k in k3.CARRY:
            assert torch.equal(c[k], carry_a[k]), k
    T, n = meter.shape
    assert (T, n) == (1200, sim.config.n_chains)
    valid = ins.rows_i[0] < dur
    assert int(valid.sum()) == 800  # the last 400 s are padding
    fold = {k: torch.zeros(n) for k in ("pv_sum", "meter_sum",
                                        "residual_sum")}
    for s in range(T):
        if valid[s]:
            fold["pv_sum"] = fold["pv_sum"] + pv_[s]
            fold["meter_sum"] = fold["meter_sum"] + meter[s]
            fold["residual_sum"] = fold["residual_sum"] + (meter[s] - pv_[s])
    for k, v in fold.items():
        assert torch.equal(acc[k], v), k
    res = (meter - pv_)[valid]
    assert torch.equal(acc["pv_max"], pv_[valid].max(0).values)
    assert torch.equal(acc["residual_min"], res.min(0).values)
    assert torch.equal(acc["residual_max"], res.max(0).values)
    assert torch.equal(acc["n_seconds"], torch.full((n,), 800,
                                                    dtype=torch.int32))
    # the series sums every second, padding included (trimmed by the engine)
    assert torch.equal(m_sum, meter.double().sum(1).float())
    assert torch.equal(p_sum, pv_.double().sum(1).float())
    torch.testing.assert_close(p_sum[valid].double().sum(),
                               acc["pv_sum"].double().sum(), rtol=1e-6,
                               atol=0.0)
    assert float(pv_.max()) > 10.0


def test_device_geometry_fields_cpu_is_plain():
    """The geometry test entry runs ``solar.device_geometry`` on the CPU,
    one ``(T, n)`` plane per field."""
    sim, state, ins, _, (_, _, site) = _epilogue_inputs(GRID)
    got = k3.device_geometry_fields(ins.rows_f, site)
    assert got.shape == (len(k3.GEOM_FIELDS), 1200, len(GRID))
    r = {k: ins.rows_f[i][:, None] for i, k in enumerate(k3.ROWS_F_SITE)}
    s = site.site
    want = solar.device_geometry(
        r["day2000"], r["sec_of_day"], r["doy"], s["latitude"],
        s["longitude"], s["altitude"], s["surface_tilt"],
        s["surface_azimuth"], s["albedo"], site.turbidity)
    for i, k in enumerate(k3.GEOM_FIELDS):
        assert torch.equal(got[i], torch.broadcast_to(want[k], got[i].shape))
    assert torch.equal(got, k3.geometry_fields_plain(ins.rows_f, site))


def test_every_instantiation_counts_its_launches():
    """One launch counter per (epilogue, geometry mode, kernel set); the
    exact set's keep their names from before the kernel sets."""
    for epi in ("acc", "series", "trace", "scen"):
        for geo in k3.GEOMS:
            for ks in ("exact", "table"):
                assert k3.STEP[epi, geo, ks] in kernels.COUNTERS
    names = kernels.counts()
    for name in ("block_step", "block_step_site", "block_step_series_site",
                 "block_step_trace", "block_step_scenario",
                 "block_step_strided", "block_step_strided_table",
                 "block_step_table", "block_step_scenario_table",
                 "table_eval"):
        assert name in names, name
    assert k3.STEP["scen", "site", "table"] is \
        k3.STEP["scen", "strided", "table"]


def test_strided_rows_carry_the_sample_grid():
    """The strided mode's rows: calendar, the second's doy, then the
    stride samples' split time and doy, padded to the block."""
    sim, state, ins, _, (_, _, site) = _epilogue_inputs(GRID, levers=LEVERS)
    T = CFG["block_s"]
    S = T // 60 + 1
    rows = ins.rows_f
    assert rows.shape == (len(k3.ROWS_F_STRIDE), T)
    assert site.stride == 60 and site.mode == "strided"
    blk = sim.spec.block(T, T)  # block 1
    ep_s, doy_s = solar.stride_samples(blk.epoch, blk.doy, 60)
    assert torch.equal(rows[3], torch.from_numpy(
        np.asarray(blk.doy, np.float32)))
    assert torch.equal(rows[4, :S], torch.from_numpy(
        np.asarray(ep_s // 86400 - 10957, np.float32)))
    assert torch.equal(rows[5, :S], torch.from_numpy(
        np.asarray(ep_s % 86400, np.float32)))
    assert torch.equal(rows[6, :S], torch.from_numpy(
        np.asarray(doy_s, np.float32)))
    assert not bool(rows[4:, S:].any())
    with pytest.raises(ValueError, match="stride 1"):
        k3.device_geometry_fields(rows, site)


@pytest.mark.parametrize("fn", ["block_step_series", "block_step_trace"])
def test_epilogue_wrappers_refuse_other_devices(fn):
    _, _, _, head, (_, _, site) = _epilogue_inputs(GRID)
    k_scan = head[3].to(torch.device("meta"))
    with pytest.raises(ValueError):  # neither cpu nor cuda
        getattr(k3, fn)(*head[:3], k_scan, *head[4:], 9000.0, None, None,
                        site=site)


def test_wrappers_refuse_other_devices():
    keys = torch.zeros((4, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        k1.split(keys, 2)


def test_kernel_constants_are_the_models():
    """consts.cuh is generated from the models as exact float32 literals,
    and every constant it defines is read by its kernel source."""
    header = build.consts_header()
    for table, src in ((rng.kernel_constants(), "threefry.cuh"),
                       (k2.kernel_constants(), "windows.cu"),
                       (k3.kernel_constants(), "block_step.cuh"),
                       (k11.kernel_constants(), "tables.cuh")):
        text = open(os.path.join(build.CSRC, src)).read()
        for name, value in table.items():
            assert re.search(rf"\b{name}\b", text), f"{src} never reads {name}"
            vals = value if isinstance(value, (list, tuple)) else [value]
            m = re.search(rf"\b{name}\b(?:\[\d+\] = \{{| \()([^}})]*)", header)
            lits = [float.fromhex(v.strip()[:-1]) for v in m.group(1).split(",")]
            assert lits == [float(np.float32(v)) for v in vals], name


def test_build_flags():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    for src in build.SOURCES + build.HEADERS:
        assert os.path.exists(os.path.join(build.CSRC, src))
    # one C entry per epilogue, the cross-CTA sum and the geometry entry,
    # in the template both kernel sets' translation units include
    text = open(os.path.join(build.CSRC, "block_step.cuh")).read()
    for entry in ("block_step_acc", "block_step_series", "block_step_trace",
                  "series_sum", "device_geometry_fields"):
        assert re.search(rf'extern "C" int {entry}\(', text), entry
    for src, kset in (("block_step.cu", "Exact"),
                      ("block_step_table.cu", "Table"),
                      ("block_step_rbg.cu", "Exact"),
                      ("block_step_rbg_table.cu", "Table"),
                      ("block_step_rbg_bf16.cu", "Exact"),
                      ("block_step_rbg_bf16_table.cu", "Table")):
        text = open(os.path.join(build.CSRC, src)).read()
        assert f"#define KSET {kset}" in text
        assert '#include "block_step.cuh"' in text
        assert ("#define PRNG RBG" in text) == ("rbg" in src)
    assert re.search(r'extern "C" int table_eval\(', open(
        os.path.join(build.CSRC, "tables.cu")).read())


def test_build_without_nvcc_raises(monkeypatch):
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here")
    monkeypatch.setattr(build, "BUILD_DIR", "/nonexistent-unused")
    with pytest.raises(RuntimeError, match="nvcc"):
        build._nvcc()


def test_compile_cache_chooses_the_build_dir(monkeypatch, tmp_path):
    """``--compile-cache DIR`` (pvsim and serve) makes DIR the directory the
    kernels are built into and loaded from: the generated header lands
    there before nvcc would run, and the package's default directory is
    not written (nvcc stubbed out, so no compiler is needed)."""
    from tmhpvsim_torch.cli import main

    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)

    def no_nvcc():
        raise RuntimeError("nvcc stubbed out")

    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    cache = tmp_path / "kernels"
    out = str(tmp_path / "r.csv")
    assert main(["pvsim", out, "--output", "reduce", "--no-realtime",
                 "--duration", "120", "--block-s", "60", "--device", "cpu",
                 "--start", "2019-09-05 12:00:00",
                 "--compile-cache", str(cache)]) == 0
    assert build.BUILD_DIR == str(cache)
    before = (set(os.listdir(build.DEFAULT_BUILD_DIR))
              if os.path.isdir(build.DEFAULT_BUILD_DIR) else set())
    with pytest.raises(RuntimeError, match="stubbed"):
        build.build_all()
    gen = [d for d in os.listdir(cache) if d.startswith("include-")]
    assert len(gen) == 1
    assert os.path.exists(os.path.join(cache, gen[0], "consts.cuh"))
    after = (set(os.listdir(build.DEFAULT_BUILD_DIR))
             if os.path.isdir(build.DEFAULT_BUILD_DIR) else set())
    assert after == before
    from tmhpvsim_torch.cli import _parser

    assert _parser().parse_args(["serve", "--compile-cache", "d"]
                                ).compile_cache == "d"
    assert build.set_build_dir(None) == build.DEFAULT_BUILD_DIR


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a card,
    and in a directory that holds nothing else of the repository."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = dict(os.environ, PYTHONPATH="")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    res = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode != 0 and '"ok"' not in res.stdout


def _fleet_block(n=8, device="cpu", **kw):
    """One daylight block of a synthetic fleet with both observers at
    level full: (sim, state, head, tail, site, fleet, obs)."""
    cfg = SimConfig(**dict(CFG, fleet=FleetParams.synthetic(n, seed=1),
                           telemetry="full", analytics="full", **kw))
    sim = Simulation(cfg, device=device)
    state = sim.init_state()
    ins = sim.host_inputs(0)
    tables, _ = sim._windows(state, ins)
    head = (tables, ins.rows_i, ins.rows_f, state["k_scan"],
            state["k_meter"])
    tail = (cfg.duration_s, cfg.meter_max_w, None, None)
    _, _, site = sim.geometry_args(state)
    return (sim, state, head, tail, site, sim.fleet_leaves(state),
            sim.observers(state))


def test_cpu_fleet_and_observer_wrappers_run_plain():
    """On the CPU the fleet and observer entries are their plain versions
    (no launch counted); the observers' statistics are the acc fold's, and
    the trace with the fleet folds to them."""
    kernels.reset_counts()
    sim, state, head, tail, site, fleet, obs = _fleet_block()
    assert obs.n_cohorts >= 2 and fleet.pv_scale is not None
    carry = state["carry"]
    _, acc_o, out = k3.block_step_obs(*head, carry, sim.init_reduce_acc(),
                                      *tail, site=site, fleet=fleet, obs=obs)
    _, acc_p, out_p = k3.block_step_obs_plain(
        *head, carry, sim.init_reduce_acc(), *tail, site=site, fleet=fleet,
        obs=obs)
    _, acc_a = k3.block_step_acc(*head, carry, sim.init_reduce_acc(), *tail,
                                 site=site, fleet=fleet)
    for k in acc_a:
        assert torch.equal(acc_o[k], acc_a[k]) and \
            torch.equal(acc_p[k], acc_a[k]), k
    for d in ("telemetry", "fleet"):
        assert out[d].keys() == out_p[d].keys()
        for k in out[d]:
            assert torch.equal(out[d][k], out_p[d][k]), (d, k)
    _, meter, pv_ = k3.block_step_trace(*head, carry, tail[1], None, None,
                                        site=site, fleet=fleet)
    fold = {"meter": torch.zeros(meter.shape[1]),
            "pv": torch.zeros(meter.shape[1])}
    for s in range(meter.shape[0]):
        fold["meter"] = fold["meter"] + meter[s]
        fold["pv"] = fold["pv"] + pv_[s]
    for k, v in fold.items():
        assert torch.equal(v, acc_a[f"{k}_sum"]), k
    assert int(out["fleet"]["count"]) == meter.numel()
    assert all(c.launches == 0 for c in kernels.COUNTERS)


def test_observer_layout_mirrors_the_kernel():
    """The wrapper's ctypes ``Obs`` has the kernel struct's fields in order,
    and the collapse kinds have the kernel's partial-row lengths (the
    struct and the leaf counts in fold.cuh, which the block step and the
    wide fold share)."""
    text = "".join(open(os.path.join(build.CSRC, f)).read()
                   for f in ("block_step.cuh", "fold.cuh"))
    body = re.search(r"struct Obs \{(.*?)\n\};", text, re.S).group(1)
    names = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        line = re.sub(r"^const\s+", "", line)
        if not line:
            continue
        decl = line.split(None, 1)[1]
        names += [re.sub(r"[\*\s]|\[\d+\]", "", d) for d in decl.split(",")]
    assert names == [f for f, _ in k3._Obs._fields_]
    assert len(k3.TEL_KINDS) == int(re.search(r"#define TEL_LEAVES (\d+)",
                                              text).group(1))
    flt_enum = re.search(r"enum FltLeaf \{(.*?)\};", text, re.S).group(1)
    assert len(k3.FLT_KINDS) == flt_enum.count(",")
    assert len(k3.COH_KINDS) == int(re.search(r"#define COH_LEAVES (\d+)",
                                              text).group(1))
    assert len(k3.TEL_CHAIN_I) == int(re.search(
        r"#define TEL_CHAIN_I (\d+)", text).group(1))
    assert len(k3.FLT_CHAIN_F) == int(re.search(
        r"#define FLT_CHAIN_F (\d+)", text).group(1))
    for entry in ("collapse_partials", "obs_struct_size"):
        assert re.search(rf'extern "C" int {entry}\(', text), entry


@pytest.mark.parametrize("kw, match", [
    (dict(analytics="risk"), "params"),
    (dict(telemetry="heavy"), "telemetry"),
    (dict(n_cohorts=3), "cohort"),
    (dict(n_cohorts=3, cohort=torch.tensor([0, 3], dtype=torch.int32)),
     "outside"),
])
def test_observers_refuse_bad_arguments(kw, match):
    with pytest.raises(ValueError, match=match):
        k3.Observers(**kw)


def test_observer_counts_stay_within_int32():
    """One block's counts are int32: the kernel's buffers refuse a block
    of 2**31 chain-seconds or more (65536 x 1080 is 2**26.1)."""
    obs = k3.Observers(telemetry="light")
    k3._obs_buffers(obs, 65536, 1080, torch.device("cpu"))
    with pytest.raises(ValueError, match="int32"):
        k3._obs_buffers(obs, 2 ** 21, 1080, torch.device("cpu"))


def test_collapse_plain_combines_by_kind():
    part = torch.tensor([[1.0, 5.0, -2.0], [2.0, 3.0, 7.0], [4.0, 9.0, 1.0]],
                        dtype=torch.float64)
    assert k3.collapse_plain(part, (0, 1, 2)).tolist() == [7.0, 3.0, 7.0]


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_k1_matches_plain_on_card(card):
    keys = rng.split(rng.key(11, device=card), 4096)
    idx = torch.arange(4096, device=card) * 31
    assert torch.equal(k1.split(keys, 3), rng.split(keys, 3))
    assert torch.equal(k1.fold_in(keys, idx), rng.fold_in(keys, idx))
    assert torch.equal(k1.bits(keys, 60), rng.random_bits(keys, (60,)))
    assert torch.equal(k1.uniform(keys, 60), rng.uniform(keys, (60,)))
    assert torch.equal(k1.normal(keys, 60), rng.normal(keys, (60,)))


@pytest.mark.cuda
def test_k2_k3_match_plain_on_card(card):
    sim = Simulation(SimConfig(**dict(CFG, n_chains=512)), device=card)
    state, ins = _block(sim)
    args = (state["k_arr"], state["k_min"], state["cc_carry"], state["cc0"],
            ins.bounds, ins.mh_idx, ins.mh_frac)
    tk, ck = k2.sampler_windows(*args)
    tp, cp = k2.windows_plain(*args)
    assert torch.equal(ck, cp)
    for k in tp:
        assert torch.equal(tk[k], tp[k]), k
    tail = (CFG["duration_s"], 9000.0, 48.12, 0.25)
    head = (tk, ins.rows_i, ins.rows_f, state["k_scan"], state["k_meter"])
    carry = {k: v.clone() for k, v in state["carry"].items()}
    _, ak = k3.block_step_acc(*head, carry, sim.init_reduce_acc(), *tail)
    _, ap = k3.block_step_plain(*head, state["carry"], sim.init_reduce_acc(),
                                *tail)
    assert torch.equal(ak["n_seconds"], ap["n_seconds"])
    for k in ap:
        torch.testing.assert_close(ak[k], ap[k], rtol=2e-5, atol=1e-2)


@pytest.mark.cuda
def test_port_on_card_matches_cpu(card):
    cfg = SimConfig(**CFG)
    want = Simulation(cfg, device="cpu").run_reduced()
    kernels.reset_counts()
    got = Simulation(cfg, device=card).run_reduced()
    assert all(c.launches > 0 for c in (k1.K1, k2.K2, k3.K3))
    np.testing.assert_array_equal(got["n_seconds"], want["n_seconds"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [None, GRID], ids=["shared", "site"])
def test_k4_k6_match_plain_on_card(card, grid):
    cfg = SimConfig(**dict(CFG, n_chains=512, site_grid=grid))
    sim = Simulation(cfg, device=card)
    state, ins = _block(sim)
    tables, _ = k2.sampler_windows(
        state["k_arr"], state["k_min"], state["cc_carry"], state["cc0"],
        ins.bounds, ins.mh_idx, ins.mh_frac)
    tilt, alb, site = sim.geometry_args(state)
    head = (tables, ins.rows_i, ins.rows_f, state["k_scan"],
            state["k_meter"])
    mw = cfg.meter_max_w

    def carry():
        return {k: v.clone() for k, v in state["carry"].items()}

    _, ak = k3.block_step_acc(*head, carry(), sim.init_reduce_acc(),
                              cfg.duration_s, mw, tilt, alb, site=site)
    _, ap = k3.block_step_plain(*head, carry(), sim.init_reduce_acc(),
                                cfg.duration_s, mw, tilt, alb, site=site)
    assert torch.equal(ak["n_seconds"], ap["n_seconds"])
    for k in ap:
        torch.testing.assert_close(ak[k], ap[k], rtol=2e-5, atol=1e-2)
    _, mk, pk = k3.block_step_trace(*head, carry(), mw, tilt, alb, site=site)
    _, mp, pp = k3.trace_plain(*head, carry(), mw, tilt, alb, site=site)
    assert torch.equal(mk, mp)
    torch.testing.assert_close(pk, pp, rtol=2e-5, atol=1e-2)
    _, sk, qk = k3.block_step_series(*head, carry(), mw, tilt, alb,
                                     site=site)
    _, sk2, qk2 = k3.block_step_series(*head, carry(), mw, tilt, alb,
                                       site=site)
    _, sp, qp = k3.series_plain(*head, carry(), mw, tilt, alb, site=site)
    assert torch.equal(sk, sk2) and torch.equal(qk, qk2)
    torch.testing.assert_close(sk, sp, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(qk, qp, rtol=1e-6, atol=1e-3)
    if site is not None:
        torch.testing.assert_close(
            k3.device_geometry_fields(ins.rows_f, site),
            k3.geometry_fields_plain(ins.rows_f, site), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("hist", ["shared", "cohort", "all"],
                         ids=["shared-hist", "global-hist",
                              "global-residual-hist"])
def test_k7_k8_k9_match_plain_on_card(card, hist):
    """The fleet transforms, telemetry and analytics kernels against their
    plain versions: per-chain leaves, counts, histograms and extrema bit
    for bit, sums over chains within 1e-6 of float64; with 64 cohorts the
    cohort histogram counts with global atomics, and with 30000 bins the
    residual histogram and the exceedance slots do too."""
    sim, state, head, tail, site, fleet, obs = _fleet_block(512, card)
    if hist == "cohort":
        obs = dataclasses.replace(obs, n_cohorts=64, cohort=(torch.arange(
            512, device=card, dtype=torch.int32) % 64))
    if hist == "all":
        obs = dataclasses.replace(obs, params=dataclasses.replace(
            obs.params, bins=30000))
    obs = dataclasses.replace(obs, per_chain=True)

    def carry():
        return {k: v.clone() for k, v in state["carry"].items()}

    _, ak, ok = k3.block_step_obs(*head, carry(), sim.init_reduce_acc(),
                                  *tail, site=site, fleet=fleet, obs=obs)
    _, ap, op = k3.block_step_obs_plain(*head, carry(), sim.init_reduce_acc(),
                                        *tail, site=site, fleet=fleet,
                                        obs=obs)
    for k in ap:
        torch.testing.assert_close(ak[k], ap[k], rtol=2e-5, atol=1e-2)
    for d in ("telemetry_chain", "fleet_chain"):
        for k in ok[d]:
            if k in op[d]:
                assert torch.equal(ok[d][k], op[d][k]), (d, k)
    for d in ("telemetry", "fleet"):
        for k, v in op[d].items():
            if v.dtype == torch.float32 and "sum" in k:
                torch.testing.assert_close(ok[d][k], v, rtol=1e-6, atol=0.0)
            else:
                assert torch.equal(ok[d][k], v), (d, k)
    # the transforms in the other two epilogues
    mw = tail[1]
    _, mk, pk = k3.block_step_trace(*head, carry(), mw, None, None,
                                    site=site, fleet=fleet)
    _, mp, pp = k3.trace_plain(*head, carry(), mw, None, None, site=site,
                               fleet=fleet)
    assert torch.equal(mk, mp)
    torch.testing.assert_close(pk, pp, rtol=2e-5, atol=1e-2)
    _, sk, qk = k3.block_step_series(*head, carry(), mw, None, None,
                                     site=site, fleet=fleet)
    _, sp, qp = k3.series_plain(*head, carry(), mw, None, None, site=site,
                                fleet=fleet)
    torch.testing.assert_close(sk, sp, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(qk, qp, rtol=1e-6, atol=1e-3)


def _k10_rows(duration_s, cohorts):
    """16 scenario rows for K10: neutral, padding, a horizon that ends
    mid-block, demand scale / shift, DC scale x weather bias, a binding
    curtailment cap, a site selector, a cohort selector (with cohorts),
    and seeded mixtures."""
    from tmhpvsim_torch.serve.schema import Scenario

    gen = np.random.default_rng(4)
    rows = [Scenario(horizon_s=duration_s), Scenario(horizon_s=0),
            Scenario(horizon_s=600),
            Scenario(demand_scale=1.7, demand_shift_w=350.0,
                     horizon_s=duration_s),
            Scenario(dc_capacity_scale=1.6, weather_bias=0.6,
                     horizon_s=duration_s),
            Scenario(curtail_w=150.0, horizon_s=duration_s),
            Scenario(site_index=3, horizon_s=duration_s),
            Scenario(cohort=1 if cohorts else -1, horizon_s=duration_s)]
    while len(rows) < 16:
        rows.append(Scenario(
            demand_scale=float(gen.uniform(0.2, 3.0)),
            demand_shift_w=float(gen.uniform(-2000.0, 2000.0)),
            dc_capacity_scale=float(gen.uniform(0.0, 4.0)),
            weather_bias=float(gen.uniform(0.25, 4.0)),
            curtail_w=float(gen.uniform(50.0, 400.0)),
            horizon_s=int(gen.integers(1, duration_s + 1))))
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["shared", "fleet", "wide"])
def test_k10_matches_plain_on_card(card, case):
    """K10 against scenario_plain at 512 chains x 16 rows: statistics
    (n_seconds, extrema) and every FleetAcc count, histogram, extremum
    and per-chain leaf bit for bit, sums to the engine tolerance; row i
    of the batch-of-16 launch equals a batch-of-1 launch of row i, and
    the neutral row equals K3's acc launch.  ``wide``: 30000 bins, whose
    histograms leave shared memory for global atomics."""
    from tmhpvsim_torch.serve import schema

    if case == "fleet":
        sim, state, head, tail, site, fleet, _ = _fleet_block(512, card)
        tilt = alb = None
    else:
        sim = Simulation(SimConfig(**dict(CFG, n_chains=512)), device=card)
        state, ins = _block(sim)
        tables, _ = sim._windows(state, ins)
        head = (tables, ins.rows_i, ins.rows_f, state["k_scan"],
                state["k_meter"])
        tail = (CFG["duration_s"], 9000.0, 48.12, 0.25)
        site = fleet = None
    cohort = sim.scenario_cohort()
    rows = _k10_rows(CFG["duration_s"], cohort is not None)
    params = sim.scenario_fleet_params()
    if case == "wide":
        params = dataclasses.replace(params, bins=30000)
        hist_bytes = 4 * (params.bins + 2 + len(params.thresholds) + 1)
        assert k3.SCN_STAGE_BYTES + hist_bytes > k3.SMEM_MAX

    def carry():
        return {k: v.clone() for k, v in state["carry"].items()}

    def launch(fn, scs):
        scen = schema.encode_batch(scs, len(scs), device=card)
        return fn(*head, carry(), sim.init_scenario_acc(len(scs)), *tail,
                  site=site, fleet=fleet, scen=scen, params=params,
                  cohort=cohort, per_chain=True)

    _, ak, dk = launch(k3.block_step_scenario, rows)
    _, ap, dp = launch(k3.scenario_plain, rows)
    for k in ap:
        if k in ("n_seconds", "pv_max", "residual_min", "residual_max"):
            assert torch.equal(ak[k], ap[k]), k
        else:
            torch.testing.assert_close(ak[k], ap[k], rtol=2e-5, atol=1e-2)
    for k, v in dp.items():
        if k == "chain":
            for c in v:
                assert torch.equal(dk["chain"][c], v[c]), c
        else:
            assert torch.equal(dk[k], v), k
    assert int(dk["count"][1]) == 0 and int(dk["count"][0]) > 0
    for i, row in enumerate(rows):
        _, a1, d1 = launch(k3.block_step_scenario, [row])
        for k in a1:
            assert torch.equal(a1[k][0], ak[k][i]), (i, k)
        for k in dp:
            if k != "chain":
                assert torch.equal(d1[k][0], dk[k][i]), (i, k)
    _, acc = k3.block_step_acc(*head, carry(), sim.init_reduce_acc(), *tail,
                               site=site, fleet=fleet)
    for k in acc:
        assert torch.equal(ak[k][0], acc[k]), k


@pytest.mark.cuda
def test_k11_matches_plain_on_card(card):
    """Each table function on the card, bit for bit against its plain
    version on the same 65536 seeded arguments."""
    gen = np.random.default_rng(0)
    n = 1 << 16
    for name in k11.FUNCS:
        if name == "arctan2":
            x, y = (torch.from_numpy(gen.uniform(-1e3, 1e3, n)
                                     .astype(np.float32)).to(card)
                    for _ in range(2))
        else:
            lo, hi = (1e-6, 1e4) if name == "log" else \
                (0.5, 100.0) if name == "powc" else (-400.0, 400.0)
            if name == "spencer_factor":
                lo, hi = 1.0, 366.0
            x = torch.from_numpy(gen.uniform(lo, hi, n).astype(np.float32)
                                 ).to(card)
            y = None
        p = -1.6364 if name == "powc" else None
        got = k11.table_eval(name, x, y, p)
        want = k11.table_eval_plain(name, x, y, p)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            name


@pytest.mark.cuda
@pytest.mark.parametrize("levers", [TABLE, dict(geom_stride=60), LEVERS],
                         ids=["table", "strided", "strided-table"])
def test_k6s_k11_match_plain_on_card(card, levers):
    """The block step with either lever against its plain version: acc and
    trace bit for bit, the series to rtol 1e-6 and bit-identical on a
    rerun, the K10 fold's statistics and FleetAcc leaves bit for bit."""
    grid = GRID if "geom_stride" in levers else None
    cfg = SimConfig(**dict(CFG, n_chains=512, site_grid=grid, **levers))
    sim = Simulation(cfg, device=card)
    state, ins = _block(sim)
    tables, _ = sim._windows(state, ins)
    tilt, alb, site = sim.geometry_args(state)
    ks = sim.plan.kernel_impl
    head = (tables, ins.rows_i, ins.rows_f, state["k_scan"],
            state["k_meter"])
    mw = cfg.meter_max_w

    def carry():
        return {k: v.clone() for k, v in state["carry"].items()}

    kw = dict(site=site, kernels=ks)
    _, ak = k3.block_step_acc(*head, carry(), sim.init_reduce_acc(),
                              cfg.duration_s, mw, tilt, alb, **kw)
    _, ap = k3.block_step_plain(*head, carry(), sim.init_reduce_acc(),
                                cfg.duration_s, mw, tilt, alb, **kw)
    for k in ap:
        assert torch.equal(ak[k], ap[k]), k
    _, mk, pk = k3.block_step_trace(*head, carry(), mw, tilt, alb, **kw)
    _, mp, pp = k3.trace_plain(*head, carry(), mw, tilt, alb, **kw)
    assert torch.equal(mk, mp) and torch.equal(pk, pp)
    _, sk, qk = k3.block_step_series(*head, carry(), mw, tilt, alb, **kw)
    _, sk2, qk2 = k3.block_step_series(*head, carry(), mw, tilt, alb, **kw)
    _, sp, qp = k3.series_plain(*head, carry(), mw, tilt, alb, **kw)
    assert torch.equal(sk, sk2) and torch.equal(qk, qk2)
    torch.testing.assert_close(sk, sp, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(qk, qp, rtol=1e-6, atol=1e-3)
    from tmhpvsim_torch.serve import schema

    rows = [schema.Scenario(horizon_s=cfg.duration_s),
            schema.Scenario(demand_scale=1.3, curtail_w=150.0,
                            horizon_s=cfg.duration_s)]
    scen = schema.encode_batch(rows, len(rows), device=card)
    prm = sim.scenario_fleet_params()
    _, sak, sdk = k3.block_step_scenario(
        *head, carry(), sim.init_scenario_acc(2), cfg.duration_s, mw, tilt,
        alb, scen=scen, params=prm, **kw)
    _, sap, sdp = k3.scenario_plain(
        *head, carry(), sim.init_scenario_acc(2), cfg.duration_s, mw, tilt,
        alb, scen=scen, params=prm, **kw)
    for k in sap:
        assert torch.equal(sak[k], sap[k]), k
    for k in sdp:
        assert torch.equal(sdk[k], sdp[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("levers", [{}, dict(site_grid=GRID), LEVERS],
                         ids=["shared", "site", "strided-table"])
def test_k12_matches_plain_on_card(card, levers):
    """K12 (the block step under compute_dtype='bf16') against its plain
    bf16 version: acc with telemetry and the trace bit for bit, the series
    to rtol 1e-6."""
    grid = GRID if "geom_stride" in levers else levers.get("site_grid")
    cfg = SimConfig(**dict(CFG, n_chains=512, compute_dtype="bf16",
                           **dict(levers, site_grid=grid)))
    sim = Simulation(cfg, device=card)
    state, ins = _block(sim)
    tables, _ = sim._windows(state, ins)
    tilt, alb, site = sim.geometry_args(state)
    head = (tables, ins.rows_i, ins.rows_f, state["k_scan"],
            state["k_meter"])
    mw = cfg.meter_max_w
    kw = dict(site=site, kernels=sim.plan.kernel_impl, compute_dtype="bf16")

    def carry():
        return {k: v.clone() for k, v in state["carry"].items()}

    obs = sim.observers(state)
    _, ak, ok = k3.block_step_obs(*head, carry(), sim.init_reduce_acc(),
                                  cfg.duration_s, mw, tilt, alb, obs=obs,
                                  **kw)
    _, ap, op = k3.block_step_obs_plain(*head, carry(), sim.init_reduce_acc(),
                                        cfg.duration_s, mw, tilt, alb,
                                        obs=obs, **kw)
    for k in ap:
        assert torch.equal(ak[k], ap[k]), k
    for k in ("nan_pv", "min_pv", "max_pv", "min_csi", "max_csi"):
        assert torch.equal(ok["telemetry"][k], op["telemetry"][k]), k
    _, mk, pk = k3.block_step_trace(*head, carry(), mw, tilt, alb, **kw)
    _, mp, pp = k3.trace_plain(*head, carry(), mw, tilt, alb, **kw)
    assert torch.equal(mk, mp) and torch.equal(pk, pp)
    _, sk, qk = k3.block_step_series(*head, carry(), mw, tilt, alb, **kw)
    _, sp, qp = k3.series_plain(*head, carry(), mw, tilt, alb, **kw)
    torch.testing.assert_close(sk, sp, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(qk, qp, rtol=1e-6, atol=1e-3)


@pytest.mark.cuda
def test_k13_matches_plain_on_card(card):
    """K13: the Philox bits of rbg keys on the card, batched (a counter
    that carries) and per key, and the rbg windows and block step, bit
    for bit against their plain versions."""
    from tmhpvsim_torch import rng
    from tmhpvsim_torch.kernels import threefry as k1

    key = torch.tensor([1, 2, 0xFFFFFFF0, 0xFFFFFFFF], dtype=torch.int64,
                       device=card)
    assert torch.equal(k1.philox_fill("bits", key[None], 1 << 12)[0],
                       rng.rbg_stream(key, 1 << 12))
    keys = rng.split(rng.rbg_key(3, card), 512)
    assert torch.equal(k1.philox_fill("bits", keys, 8, per_key=True),
                       rng.random_bits(keys, (8,), per_key=True))
    assert torch.equal(k1.uniform(keys), rng.uniform(keys, ()))
    cfg = SimConfig(start="2019-09-05 11:00:00", duration_s=2160,
                    n_chains=512, block_s=1080, prng_impl="rbg")
    with pytest.warns(RuntimeWarning, match="rbg"):
        sim = Simulation(cfg, device=card)
    state = sim.init_state()
    ins = sim.host_inputs(0)
    args = (state["k_arr"], state["k_min"], state["cc_carry"], state["cc0"],
            ins.bounds, ins.mh_idx, ins.mh_frac)
    tk, ck = k2.sampler_windows(*args)
    tp, cp = k2.windows_plain(*args)
    assert all(torch.equal(tk[k], tp[k]) for k in tk) and torch.equal(ck, cp)
    head = (tk, ins.rows_i, ins.rows_f, state["k_scan"], state["k_meter"])
    tail = (cfg.duration_s, cfg.meter_max_w, cfg.site.surface_tilt,
            cfg.site.albedo)
    for layout in ("scan", "scan2", "trace"):
        _, ak = k3.block_step_acc(
            *head, {k: v.clone() for k, v in state["carry"].items()},
            sim.init_reduce_acc(), *tail, layout=layout)
        _, ap = k3.block_step_plain(
            *head, {k: v.clone() for k, v in state["carry"].items()},
            sim.init_reduce_acc(), *tail, layout=layout)
        assert all(torch.equal(ak[k], ap[k]) for k in ak), layout
