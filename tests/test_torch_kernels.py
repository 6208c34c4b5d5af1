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
from test_torch_threads import one_torch_thread  # noqa: F401

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


@pytest.mark.parametrize("shape", [(2, 512, 1080), (2, 37, 61), (2, 3, 60),
                                   (2, 1, 7)],
                         ids=["main-path", "ragged", "few-ctas", "one-cta"])
def test_series_sum_plain_is_the_float64_sum(shape):
    """series_sum_plain's strand order (the card kernel's) stays within
    1e-6 of a float64 sum of the same partials, rounded once."""
    gen = np.random.default_rng(shape[1])
    part = torch.from_numpy(np.abs(gen.normal(2e5, 1e5, shape))
                            .astype(np.float32))
    got = k3.series_sum_plain(part)
    want = part.double().sum(1)
    assert got.dtype == torch.float32 and got.shape == (2, shape[2])
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=0.0)
    assert torch.equal(k3.series_sum(part), got)  # the CPU wrapper


def test_series_sum_plain_adds_in_strand_order():
    """Strand j adds partials j, j + SUM_STRANDS, ... from 0.0 in double;
    the strands are then added in index order from 0.0 and rounded once:
    a scalar loop in that order gives the same bits."""
    gen = np.random.default_rng(7)
    C, T = 70, 5
    part = gen.normal(0.0, 1e6, (2, C, T)).astype(np.float32)
    want = np.empty((2, T), np.float32)
    S = k3.SUM_STRANDS
    for a in range(2):
        for t in range(T):
            strands = []
            for j in range(S):
                x = 0.0
                for c in range(j, C, S):
                    x = x + float(part[a, c, t])
                strands.append(x)
            tot = 0.0
            for x in strands:
                tot = tot + x
            want[a, t] = np.float32(tot)
    got = k3.series_sum_plain(torch.from_numpy(part))
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    text = open(os.path.join(build.CSRC, "block_step.cuh")).read()
    assert int(re.search(r"#define SUM_STRANDS (\d+)", text).group(1)) == S


def _k10_inputs(compute_dtype="f32", n=200):
    """A daylight block of ``n`` chains (the main path's shape cut to a
    120 s block) with K10's 16 check rows: (sim, state, head, tail, rows,
    scen, params)."""
    from tmhpvsim_torch.serve import schema

    cfg = SimConfig(**dict(CFG, n_chains=n, block_s=120, duration_s=240,
                           compute_dtype=compute_dtype))
    sim = Simulation(cfg, device="cpu")
    state, ins = _block(sim, 1)
    tables, _ = sim._windows(state, ins)
    head = (tables, ins.rows_i, ins.rows_f, state["k_scan"],
            state["k_meter"])
    tail = (cfg.duration_s, cfg.meter_max_w, 48.12, 0.25)
    rows = _k10_rows(cfg.duration_s, False)
    rows[2] = schema.Scenario(horizon_s=180)  # ends inside the block
    scen = schema.encode_batch(rows, len(rows), device="cpu")
    return sim, state, head, tail, rows, scen, sim.scenario_fleet_params()


@pytest.mark.parametrize("compute_dtype", ["f32", "bf16"])
def test_k10_plain_composition_folds_each_row_alone(compute_dtype):
    """scenario_plain is its producer (the acc step's meter and pv, bf16
    draws under bf16) then its fold, all rows at once; each row equals an
    independent fold of that row alone (the statistics fold with the
    row's mask, a risk FleetAcc per second, reduce_chainwise), and the
    CPU wrappers of the two launches compose to it."""
    from tmhpvsim_torch.obs import analytics as flt

    sim, state, head, tail, rows, scen, params = _k10_inputs(compute_dtype)
    carry = state["carry"]
    cw, aw, dw = k3.block_step_scenario(
        *head, carry, sim.init_scenario_acc(len(rows)), *tail, scen=scen,
        params=params, per_chain=True, compute_dtype=compute_dtype)
    cp, meter, pv = k3.scenario_producer(*head, carry, *tail[1:],
                                         compute_dtype=compute_dtype)
    _, m2, p2 = k3.block_step_trace(*head, carry, *tail[1:],
                                    compute_dtype=compute_dtype,
                                    layout="scan")
    assert torch.equal(meter, m2)
    if compute_dtype == "f32":  # the trace draws float32 under bf16
        assert torch.equal(pv, p2)
    t = head[1][0]
    af, df = k3.scenario_fold(meter, pv, t, sim.init_scenario_acc(len(rows)),
                              tail[0], scen=scen, params=params,
                              per_chain=True)
    for k in aw:
        assert torch.equal(af[k], aw[k]), k
    for k in dw:
        if k != "chain":
            assert torch.equal(df[k], dw[k]), k
    for k in cw:
        assert torch.equal(cw[k], cp[k]), k
    n = meter.shape[1]
    iota = torch.arange(n, dtype=torch.int32)
    for b in range(len(rows)):
        one = {k: v[b] for k, v in scen.items()}
        m = rng.fma(meter, one["demand_scale"], one["demand_shift_w"])
        p = torch.minimum(pv * (one["pv_scale"] * one["weather_bias"]),
                          one["curtail_w"])
        sel = (one["site_index"] < 0) | (iota == one["site_index"])
        ok = sel[None] & ((t < tail[0]) & (t < one["horizon_s"]))[:, None]
        acc = {k: v[b] for k, v in sim.init_scenario_acc(len(rows)).items()}
        acc = k3.stats_fold_plain(acc, t, tail[0], m, p, valid=ok)
        fa = flt.init_acc("risk", n, params=params)
        for s in range(t.shape[0]):
            fa = flt.fold_second(fa, "risk", params, meter=m[s], pv=p[s],
                                 residual=m[s] - p[s], covered=None,
                                 t=int(t[s]), valid=ok[s])
        delta = flt.reduce_chainwise(fa)
        for k in acc:
            assert torch.equal(aw[k][b], acc[k]), (b, k)
        for k in delta:
            assert torch.equal(dw[k][b], delta[k]), (b, k)
        for k, v in dw["chain"].items():
            assert torch.equal(v[b], fa[k]), (b, k)
    assert int(dw["count"][1]) == 0
    assert int(aw["n_seconds"][2].max()) == 180 - int(t[0])


def test_scenario_fold_layout():
    """Where the fold's sketch lives and its dynamic shared bytes: shared
    memory while the sketch and the ramp flags fit in SCN_SMEM_MAX (a
    30000-bin sketch too), global atomics beyond (60000 bins); past
    MAX_THR thresholds the exceedance slots join the sketch."""
    from tmhpvsim_torch.obs import analytics as flt

    prm = flt.params_from_config(SimConfig(**CFG))
    nb = 4 * (prm.bins + 2)
    assert k3.scenario_fold_layout(1080, prm) == (True, nb + 1080)
    assert k3.scenario_fold_layout(61, prm) == (True, nb + 64)
    wide = dataclasses.replace(prm, bins=30000)
    assert k3.scenario_fold_layout(1080, wide) == (True, 4 * 30002 + 1080)
    wider = dataclasses.replace(prm, bins=60000)
    assert k3.scenario_fold_layout(1080, wider) == (False, 1080)
    many = dataclasses.replace(prm, thresholds=tuple(
        float(x) for x in range(-4000, 5000, 1000)))
    assert k3.scenario_fold_layout(60, many) == (
        True, 4 * (prm.bins + 2 + 10) + 60)
    with pytest.raises(ValueError, match="does not fit"):
        k3.scenario_fold_layout(4 * k3.SCN_SMEM_MAX, prm)


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
    for epi in ("acc", "series", "trace", "scen", "prod"):
        for geo in k3.GEOMS:
            for ks in ("exact", "table"):
                assert k3.STEP[epi, geo, ks] in kernels.COUNTERS
    names = kernels.counts()
    for name in ("block_step", "block_step_site", "block_step_series_site",
                 "block_step_trace", "block_step_scenario",
                 "block_step_strided", "block_step_strided_table",
                 "block_step_table", "block_step_scenario_table",
                 "table_eval", "scenario_fold", "block_step_prod_site",
                 "block_step_prod_strided_table", "obs_fold"):
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
    # one C entry per epilogue, the cross-CTA sum and the test entries of
    # the geometry and the NaN-keeping helpers, in the template both kernel sets' translation units include
    text = open(os.path.join(build.CSRC, "block_step.cuh")).read()
    for entry in ("block_step_acc", "block_step_series", "block_step_trace",
                  "series_sum", "device_geometry_fields", "nan_minmax",
                  "block_step_scenario", "scenario_fold", "block_step_prod",
                  "step_attrs"):
        assert re.search(rf'extern "C" int {entry}\(', text), entry
    # the observer fold, beside the wide fold (analytics left the step)
    wide_text = open(os.path.join(build.CSRC, "wide_fold.cu")).read()
    for entry in ("wide_fold", "obs_fold", "obs_fold_attrs",
                  "wide_fold_attrs"):
        assert re.search(rf'extern "C" int {entry}\(', wide_text), entry
    # the window kernel: one launcher for the three key implementations
    win_text = open(os.path.join(build.CSRC, "windows.cu")).read()
    for entry in ("sampler_windows", "windows_attrs"):
        assert re.search(rf'extern "C" int {entry}\(', win_text), entry
    assert win_text.count("<<<") == 1
    assert f"#define MAX_HOURS {k2.MAX_HOURS}" in win_text
    assert not re.search(r"\bbool FLT\b", text)
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


def test_kernels_keep_nans_in_min_max_and_clamp():
    """The sources whose minimum, maximum and clamp can meet a NaN use the
    NaN-keeping helpers of nanminmax.cuh (as jnp.minimum / maximum / clip
    and the plain versions' torch ones), never CUDA's fminf / fmaxf, which
    drop a NaN operand."""
    assert "nanminmax.cuh" in build.HEADERS
    for src in ("block_step.cuh", "fold.cuh", "wide_fold.cu", "bf16.cuh",
                "tables.cuh"):
        text = open(os.path.join(build.CSRC, src)).read()
        code = re.sub(r"//[^\n]*", "", text)
        assert not re.search(r"\bf(min|max)f\s*\(", code), src
        assert '#include "nanminmax.cuh"' in text or \
            '#include "fold.cuh"' in text, src


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


def _row_sets(n_parts, seed=0):
    """A block's row sets with their kinds as the callers pass them:
    telemetry (25 leaves), analytics (15), 3 cohorts x 6 (kinds of one
    cohort) and 16 scenario rows x 8 (kinds of one row); seeded rows."""
    gen = np.random.default_rng(seed)
    return {name: (torch.from_numpy(gen.normal(0.0, 1e3, (n_parts, L))),
                   kinds)
            for name, L, kinds in (
                ("tel_part", 25, k3.TEL_KINDS),
                ("flt_part", 15, k3.FLT_KINDS),
                ("coh_part", 18, k3.COH_KINDS),
                ("scenario", 128, k3.SCN_KINDS))}


@pytest.mark.parametrize("names", [
    ("tel_part",), ("tel_part", "flt_part", "coh_part"), ("scenario",),
    ("tel_part", "flt_part", "coh_part", "scenario")],
    ids=["telemetry", "observers", "scenario", "four-sets"])
def test_collapse_group_plain_path_equals_collapse_plain(names):
    """On the CPU the grouped collapse is ``collapse_plain`` on each set,
    its kinds (one period of them) repeated over the set's leaves; it
    counts no launch."""
    sets = _row_sets(7)
    kernels.reset_counts()
    got = k3.collapse_group([sets[k] for k in names])
    assert k3.COLLAPSE.launches == 0 and len(got) == len(names)
    for name, g in zip(names, got):
        part, kinds = sets[name]
        full = tuple(kinds) * (part.shape[1] // len(kinds))
        assert torch.equal(g, k3.collapse_plain(part, full)), name


def test_collapse_group_refuses_what_the_kernel_cannot_take():
    """At most COLLAPSE_MAX_SETS sets; kinds one period of at most 32
    leaves that tiles the set's leaves, two bits a leaf."""
    sets = list(_row_sets(3).values())
    with pytest.raises(ValueError, match="row sets"):
        k3.collapse_group(sets + sets[:1])
    with pytest.raises(ValueError, match="row sets"):
        k3.collapse_group([])
    assert k3._kinds_bits(k3.TEL_KINDS, 25) == sum(
        k << (2 * j) for j, k in enumerate(k3.TEL_KINDS))
    assert k3._kinds_bits(k3.COH_KINDS, 30) == 0b100100000000
    for kinds, L in (((0, 1), 25), (k3.SCN_KINDS * 5, 40), ((3,), 4), ((), 4)):
        with pytest.raises(ValueError, match="period"):
            k3._kinds_bits(kinds, L)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_checkpoint_snapshot_on_card(card, tmp_path):
    """A checkpoint's host copy of card tensors (one pinned buffer, copies
    enqueued on the current stream) holds the tree as it was at the
    snapshot, not an in-place update enqueued after it; through the async
    writer the file holds the same record, bit for bit against the copy
    of the CPU tensors."""
    from tmhpvsim_torch.config import SimConfig
    from tmhpvsim_torch.engine import checkpoint as ckpt
    from tmhpvsim_torch.engine.simulation import Simulation

    sim = Simulation(SimConfig(n_chains=1000, duration_s=1080,
                               block_s=1080, output="reduce"), device=card)
    tree = {"state": sim.init_state(), "acc": sim.init_reduce_acc()}
    want = ckpt._flatten({k: {n: (v.cpu() if isinstance(v, torch.Tensor)
                                  else {m: w.cpu() for m, w in v.items()})
                              for n, v in t.items()}
                          for k, t in tree.items()})
    snap = ckpt._Snapshot(tree)
    tree["state"]["cc0"].add_(1.0)
    got = snap.flat()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k].view(np.uint8), want[k].view(np.uint8)), k
    tree = {"state": sim.init_state(), "acc": sim.init_reduce_acc()}
    path = str(tmp_path / "ck.npz")
    w = ckpt.AsyncCheckpointWriter(path, config=sim.config)
    w.submit(tree, 1)
    tree["acc"]["pv_sum"].add_(5.0)
    w.close(timeout=60)
    flat, meta = ckpt._read_npz(path)
    assert meta["next_block"] == 1
    for k in want:
        assert np.array_equal(flat[k].view(np.uint8),
                              want[k].view(np.uint8)), k


@pytest.mark.cuda
def test_nan_minmax_matches_plain_on_card(card):
    """The NaN-keeping helpers on the card against torch.minimum, maximum
    and clamp: NaN where torch has one (PTX gives the canonical NaN,
    torch the operand's payload), every other value bit for bit, -0.0
    against +0.0 in both orders included."""
    vals = (float("nan"), -float("inf"), -2.0, -1.0, -0.0, 0.0, 0.5, 1.0,
            3.0, float("inf"))
    a = torch.tensor([x for x in vals for _ in vals], device=card)
    b = torch.tensor([y for _ in vals for y in vals], device=card)
    got = k3.nan_minmax(a, b, 0.0, 1.0)
    want = k3.nan_minmax_plain(a, b, 0.0, 1.0)
    assert torch.equal(got.isnan(), want.isnan())
    ok = ~want.isnan()
    assert torch.equal(got[ok].view(torch.int32), want[ok].view(torch.int32))


@pytest.mark.cuda
def test_k15_matches_plain_on_card(card):
    """K15 (the metersim producer's block) against its plain version bit
    for bit under every key implementation, aligned, far and 60-second
    blocks, one launch each."""
    from tmhpvsim_torch.kernels import meter as k15

    for impl in rng.IMPLS:
        key = rng.root_key(7, impl, card)
        for sec0, T in ((0, 600), (600, 600), (85800, 600), (0, 60),
                        (130, 600)):
            kernels.reset_counts()
            got = k15.meter_block(key, sec0, T, 9000.0, impl)
            assert k15.K15.launches == 1
            want = k15.meter_block(key.cpu(), sec0, T, 9000.0, impl)
            assert torch.equal(got.cpu(), want), (impl, sec0, T)


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


#: K2's edge runs on the card: (what, config, blocks); every config at
#: 65536 - 37 chains (a partial last CTA) unless it says otherwise
K2_EDGES = (
    ("noon", dict(start="2019-09-05 00:00:00", block_s=1080), (40, 41)),
    ("carry advance", dict(start="2019-09-05 00:00:00", block_s=1080),
     (6,)),
    ("midnight", dict(start="2019-09-05 23:45:00", block_s=1080), (0, 1)),
    # two days in one block: the hour window near MAX_HOURS
    ("long", dict(start="2019-09-05 00:00:00", block_s=172800,
                  n_chains=1024 - 37), (0,)))


@pytest.mark.cuda
@pytest.mark.parametrize("regimes", [False, True], ids=["shared", "regime"])
@pytest.mark.parametrize("impl", rng.IMPLS)
def test_k2_edges_match_plain_on_card(card, impl, regimes):
    """K2 (with K7's regimes, K13 and K14 in K2) against windows_plain bit
    for bit: init_state's two launches, the noon blocks, a block after
    which the carry advances, the two blocks from 23:45 (across midnight:
    clear-day and windspeed values of two days) and a two-day block (53
    hours), at 65536 - 37 chains (1024 - 37 for the long block)."""
    import warnings

    def held(what, args, regime):
        tk, ck = k2.sampler_windows(*args, regime=regime, impl=impl)
        tp, cp = k2.windows_plain(*args, regime=regime, impl=impl)
        assert torch.equal(ck, cp), what
        for k in tp:
            assert torch.equal(tk[k], tp[k]), (what, k)
        return ck

    hours = 0
    for what, kw, blocks in K2_EDGES:
        kw = dict(kw)
        n = kw.pop("n_chains", 65536 - 37)
        fleet = FleetParams.synthetic(n, seed=0) if regimes else None
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            sim = Simulation(SimConfig(n_chains=n, seed=0, duration_s=max(
                86400, kw["block_s"]), prng_impl=impl, fleet=fleet, **kw),
                device=card)
        state = sim.init_state()
        regime = state["fleet"]["regime"] if regimes else None
        cc = state["cc_carry"]
        for bi in blocks:
            ins = sim.host_inputs(bi)
            hours = max(hours, ins.bounds.n_hours)
            cc = held(f"{what} block {bi}", (
                state["k_arr"], state["k_min"], cc, state["cc0"], ins.bounds,
                ins.mh_idx, ins.mh_frac), regime)
        if what == "noon":
            ones = torch.ones(n, device=card)
            none = (torch.zeros(0, dtype=torch.int32, device=card),
                    torch.zeros(0, device=card))
            held("init cc01/ws0", (state["k_arr"], state["k_min"], ones, ones,
                                   k2.Bounds(0, 2, 0, 0, 0, 0, 0, 1),
                                   *none), None)
            held("init cloudy pair", (state["k_arr"], state["k_min"], ones,
                                      state["cc0"],
                                      k2.Bounds(0, 0, 2, 0, 0, 0, 0, 0),
                                      *none), None)
    assert hours > 48


@pytest.mark.cuda
def test_wide_fold_acc_matches_plain_on_card(card):
    """The wide fold's acc launch (no observer) against wide_fold_plain bit
    for bit: T = 1037 seconds (not a multiple of the load ring's depth),
    the duration ending mid-block, 65536 - 37 chains, a NaN meter value
    (NaN where the plain version has one: PTX gives the canonical NaN)."""
    from tmhpvsim_torch.kernels import wide

    T, n = 1037, 65536 - 37
    gen = np.random.default_rng(17)
    meter = torch.from_numpy(gen.normal(500.0, 800.0, (T, n)).astype(
        np.float32))
    pv = torch.from_numpy(gen.uniform(0.0, 3000.0, (T, n)).astype(
        np.float32))
    meter[3, 5] = float("nan")
    t = torch.arange(7000, 7000 + T, dtype=torch.int32)
    acc = {k: torch.from_numpy(gen.normal(0.0, 100.0, n).astype(np.float32))
           for k in k3.ACC_F}
    acc["n_seconds"] = torch.from_numpy(gen.integers(0, 100, n).astype(
        np.int32))
    dur = 7000 + 1000
    want, _ = wide.wide_fold_plain(meter, pv, t, dur, dict(acc))
    got, _ = wide.wide_fold(meter.to(card), pv.to(card), t.to(card), dur,
                            {k: v.to(card) for k, v in acc.items()})
    for k, w in want.items():
        g = got[k].cpu()
        assert torch.equal(g.isnan(), w.isnan()), k
        assert torch.equal(g[~w.isnan()], w[~w.isnan()]), k
    assert bool(want["residual_min"].isnan().any())


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
    # series_sum bit for bit against its plain version, on these partials
    # and on wide ones (512 CTAs of seeded values), and on a rerun
    _, part = k3.series_partials_cuda(*head, carry(), mw, tilt, alb,
                                      site=site)
    gen = np.random.default_rng(2)
    wide = torch.from_numpy(gen.normal(5e5, 1e5, (2, 512, 1080)).astype(
        np.float32)).to(card)
    for pt in (part, wide):
        got = k3.series_sum(pt)
        assert torch.equal(got, k3.series_sum_plain(pt))
        assert torch.equal(got, k3.series_sum(pt))
    if site is not None:
        torch.testing.assert_close(
            k3.device_geometry_fields(ins.rows_f, site),
            k3.geometry_fields_plain(ins.rows_f, site), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("fields", [
    {}, {"start": "2019-09-05 18:50:30"}, {"kernel_impl": "table"},
    {"prng_impl": "unsafe_rbg"}, {"compute_dtype": "bf16"},
    {"compute_dtype": "bf16", "prng_impl": "unsafe_rbg"}],
    ids=["edge", "off-minute", "table", "unsafe-rbg", "bf16", "bf16-urbg"])
def test_lean_step_edges_match_plain_on_card(card, fields):
    """The lean step's acc, trace and series (its per-CTA partials)
    against their plain versions bit for bit on an edge block: the last
    hour of daylight, sunset in its last minutes (seconds with and
    without clear-sky GHI), 512 - 37 chains (a partial last CTA), the
    duration ending mid-tile, and wind speeds x16 (cycles of a few
    seconds: redraws in consecutive seconds and in a tile's first and
    last second); also from a start off a whole minute (the minute index
    changes inside every tile) and under the table set, unsafe_rbg keys
    and bf16."""
    cfg = SimConfig(**{"start": "2019-09-05 18:50:00", "duration_s": 86400,
                       "n_chains": 512 - 37, "seed": 0, "block_s": 3600,
                       **fields})
    sim = Simulation(cfg, device=card)
    state, ins = _block(sim)
    tables, _ = sim._windows(state, ins)
    tables = dict(tables, ws=tables["ws"] * 16.0)
    kw = dict(kernels=sim.plan.kernel_impl,
              compute_dtype=sim.plan.compute_dtype, impl=sim.plan.prng_impl)
    red = k3.redraws_plain(tables, ins.rows_i, ins.rows_f, state["k_scan"],
                           state["carry"], impl=kw["impl"])
    assert bool(red[0::60].any() and red[59::60].any()
                and (red[1:] & red[:-1]).any())
    ghi = ins.rows_f[k3.ROWS_F.index("ghi_clear")]
    assert 0 < int((ghi == 0).sum()) < ghi.numel()
    m = ins.rows_i[3]
    assert bool((m[0::60] != m[59::60]).all()) == ("start" in fields)
    tilt, alb, _ = sim.geometry_args(state)
    head = (tables, ins.rows_i, ins.rows_f, state["k_scan"],
            state["k_meter"])
    mw = cfg.meter_max_w

    def carry():
        return {k: v.clone() for k, v in state["carry"].items()}

    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    ck, ak = k3.block_step_acc(*head, carry(), sim.init_reduce_acc(),
                               3600 - 30, mw, tilt, alb, **kw)
    cp, ap = k3.block_step_plain(*head, carry(), sim.init_reduce_acc(),
                                 3600 - 30, mw, tilt, alb, **kw)
    for a, b in ((ak, ap), (ck, cp)):
        for k in b:
            assert torch.equal(bits(a[k]), bits(b[k])), k
    ck, mk, pk = k3.block_step_trace(*head, carry(), mw, tilt, alb, **kw)
    cp, mp, pp = k3.trace_plain(*head, carry(), mw, tilt, alb, **kw)
    assert torch.equal(bits(mk), bits(mp)) and torch.equal(bits(pk), bits(pp))
    for k in cp:
        assert torch.equal(bits(ck[k]), bits(cp[k])), k
    ck, part = k3.series_partials_cuda(*head, carry(), mw, tilt, alb, **kw)
    cp, want = k3.series_partials_plain(*head, carry(), mw, tilt, alb, **kw)
    assert torch.equal(bits(part), bits(want))
    for k in cp:
        assert torch.equal(bits(ck[k]), bits(cp[k])), k


def _index_order(part, kinds):
    """The host's fold of the rows in index order, sums in float64."""
    rows = part.cpu().tolist()
    out = list(rows[0])
    for row in rows[1:]:
        out = [x + y if k == 0 else (min(x, y) if k == 1 else max(x, y))
               for x, y, k in zip(out, row, kinds)]
    return torch.tensor(out, dtype=torch.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("n_parts", [512, 1, 2049],
                         ids=["main-path", "one-row", "many-stages"])
def test_collapse_group_matches_index_order_on_card(card, n_parts):
    """The grouped collapse: four row sets (telemetry, analytics, 3
    cohorts, 16 scenario rows over 4 CTAs) in one launch, each bit for bit
    against the host's index-order float64 fold; at the main path's 512
    rows (65536 chains), one row, and 2049 rows (stages past the ring's
    four, a partial last stage)."""
    sets = _row_sets(n_parts, seed=n_parts)
    names = list(sets)
    kernels.reset_counts()
    got = k3.collapse_group([(p.to(card), k) for p, k in sets.values()])
    assert k3.COLLAPSE.launches == 1
    for name, g in zip(names, got):
        part, kinds = sets[name]
        full = tuple(kinds) * (part.shape[1] // len(kinds))
        assert torch.equal(g.cpu(), _index_order(part, full)), name


@pytest.mark.cuda
@pytest.mark.parametrize("fields", [
    {"telemetry": "light"}, {"telemetry": "full"},
    {"telemetry": "light", "compute_dtype": "bf16"},
    {"telemetry": "light", "start": "2019-09-05 18:50:30"},
    {"telemetry": "full", "start": "2019-09-05 18:50:30"},
    {"telemetry": "light", "compute_dtype": "bf16",
     "start": "2019-09-05 18:50:30"},
    {"telemetry": "light", "compute_dtype": "bf16",
     "start": "2019-09-05 00:00:00"}],
    ids=["light", "full", "bf16-light", "off-minute-light",
         "off-minute-full", "off-minute-bf16-light", "midnight-bf16-light"])
def test_lean_tel_edges_match_plain_on_card(card, fields):
    """The lean step with the telemetry observer (the shared-site acc
    launch, path R-H's under bf16) against its plain version on the edge
    block of ``test_lean_step_edges_match_plain_on_card`` (and on the
    00:00 block, no second with clear-sky GHI): statistics, carry and
    every per-chain telemetry leaf bit for bit, the collapsed counts,
    extrema, csi histogram and occupancy bit for bit, the sums within
    1e-6 of the plain version's float64 sums."""
    cfg = SimConfig(**{"start": "2019-09-05 18:50:00", "duration_s": 86400,
                       "n_chains": 512 - 37, "seed": 0, "block_s": 3600,
                       **fields})
    sim = Simulation(cfg, device=card)
    state, ins = _block(sim)
    tables, _ = sim._windows(state, ins)
    tables = dict(tables, ws=tables["ws"] * 16.0)
    tilt, alb, _ = sim.geometry_args(state)
    head = (tables, ins.rows_i, ins.rows_f, state["k_scan"],
            state["k_meter"])
    obs = dataclasses.replace(sim.observers(state), per_chain=True)
    assert obs.telemetry == fields["telemetry"] and obs.analytics == "off"
    kw = dict(obs=obs, compute_dtype=sim.plan.compute_dtype)

    def carry():
        return {k: v.clone() for k, v in state["carry"].items()}

    ck, ak, ok = k3.block_step_obs(*head, carry(), sim.init_reduce_acc(),
                                   3600 - 30, cfg.meter_max_w, tilt, alb,
                                   **kw)
    cp, ap, op = k3.block_step_obs_plain(*head, carry(),
                                         sim.init_reduce_acc(), 3600 - 30,
                                         cfg.meter_max_w, tilt, alb, **kw)
    for a, b in ((ak, ap), (ck, cp)):
        for k in b:
            assert torch.equal(a[k], b[k]), k
    chain_k, chain_p = ok["telemetry_chain"], op["telemetry_chain"]
    shared = [k for k in chain_p if k in chain_k]
    assert len(shared) >= 24
    for k in shared:
        assert torch.equal(chain_k[k], chain_p[k]), k
    for k, v in op["telemetry"].items():
        if k.startswith(("sum_", "sumsq_")):
            want = op["telemetry_chain"][k].double().sum()
            assert float((ok["telemetry"][k].double() - want).abs()) <= \
                1e-6 * float(want.abs()), k
        else:
            assert torch.equal(ok["telemetry"][k], v), k


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


#: ten ascending exceedance thresholds [W], past k3.MAX_THR (8): the
#: observer fold counts them with atomics, not in registers
OBS_MANY_THR = tuple(float(x) for x in range(-4000, 6000, 1000))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["f32", "levers", "bf16", "thresholds",
                                  "thresholds_global"])
def test_obs_producer_and_fold_match_plain_on_card(card, case):
    """K8 + K9's two launches on their own: the acc producer's
    statistics, carry, meter, csi and covered flags bit for bit against
    its plain version (pv to the engine tolerance), and the observer fold
    on the producer's own arrays against its plain version: per-chain
    leaves, counts, histograms and extrema bit for bit, sums within 1e-6
    of float64.  ``levers``: the table set with stride 60; ``bf16``: K12;
    ``thresholds`` and ``thresholds_global``: ten exceedance thresholds
    (counted with atomics), with the shared histograms and with 30000
    bins in global memory."""
    levers = {"levers": LEVERS,
              "bf16": {"compute_dtype": "bf16"}}.get(case, {})
    sim, state, head, tail, site, fleet, obs = _fleet_block(512, card,
                                                            **levers)
    obs = dataclasses.replace(obs, per_chain=True)
    if case.startswith("thresholds"):
        prm = dataclasses.replace(obs.params, thresholds=OBS_MANY_THR)
        if case == "thresholds_global":
            prm = dataclasses.replace(prm, bins=30000)
        obs = dataclasses.replace(obs, params=prm)
        assert len(prm.thresholds) > k3.MAX_THR
        hist_bytes = 4 * (prm.bins + len(prm.thresholds) + 3)
        assert (hist_bytes <= k3.SMEM_MAX) == (case == "thresholds")
    kw = dict(site=site, fleet=fleet, kernels=sim.plan.kernel_impl,
              compute_dtype=sim.plan.compute_dtype)

    def carry():
        return {k: v.clone() for k, v in state["carry"].items()}

    ck, ak, pk = k3.obs_producer(*head, carry(), sim.init_reduce_acc(),
                                 *tail, obs=obs, **kw)
    cp, ap, pp = k3.obs_producer_plain(*head, carry(), sim.init_reduce_acc(),
                                       *tail, **kw)
    for k in ck:
        assert torch.equal(ck[k], cp[k]), k
    for k in ak:
        torch.testing.assert_close(ak[k], ap[k], rtol=2e-5, atol=1e-2)
    assert torch.equal(pk["meter"], pp["meter"])
    assert torch.equal(pk["csi"], pp["csi"])
    assert torch.equal(pk["covered"], pp["covered"].to(torch.uint8))
    torch.testing.assert_close(pk["pv"], pp["pv"], rtol=2e-5, atol=1e-2)
    t = head[1][0]
    ok = k3.obs_fold(pk, t, tail[0], obs)
    op = k3.obs_fold_plain(dict(pk, covered=pk["covered"].bool()), t,
                           tail[0], obs)
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
    assert int(ok["fleet"]["exceed"].sum()) == int(ok["fleet"]["count"])
    if case.startswith("thresholds"):
        assert int((ok["fleet"]["exceed"] > 0).sum()) >= 3


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
@pytest.mark.parametrize("case", ["shared", "fleet", "wide", "global",
                                  "thresholds", "thresholds_global",
                                  "bf16", "rbg"])
def test_k10_matches_plain_on_card(card, case):
    """K10 (its producer, then its fold) against scenario_plain at 512
    chains x 16 rows: statistics (n_seconds, extrema) and every FleetAcc
    count, histogram, extremum and per-chain leaf bit for bit, sums to the
    engine tolerance; the fold alone bit for bit against its plain
    version on the producer's meter and pv, with and without the
    producer's flags that let a masked tail skip its loads; row i of the
    batch-of-16 launch equals a batch-of-1 launch of row i, and
    the neutral row equals the acc launch.  ``wide``: 30000 bins, whose
    sketch still fits in the fold's shared memory; ``global``: 60000
    bins, counted with global atomics; ``thresholds`` and
    ``thresholds_global``: ten exceedance thresholds (the default is
    seven), with the shared and the 60000-bin sketch; ``bf16`` and
    ``rbg``: K12 in K10 and the rbg instantiation."""
    from tmhpvsim_torch.serve import schema

    extra = {"bf16": dict(compute_dtype="bf16"),
             "rbg": dict(prng_impl="rbg")}.get(case, {})
    kw = {"bf16": dict(compute_dtype="bf16"),
          "rbg": dict(impl="rbg")}.get(case, {})
    if case == "fleet":
        sim, state, head, tail, site, fleet, _ = _fleet_block(512, card)
        tilt = alb = None
    else:
        sim = Simulation(SimConfig(**dict(CFG, n_chains=512, **extra)),
                         device=card)
        state, ins = _block(sim)
        tables, _ = sim._windows(state, ins)
        head = (tables, ins.rows_i, ins.rows_f, state["k_scan"],
                state["k_meter"])
        tail = (CFG["duration_s"], 9000.0, 48.12, 0.25)
        site = fleet = None
    cohort = sim.scenario_cohort()
    rows = _k10_rows(CFG["duration_s"], cohort is not None)
    params = sim.scenario_fleet_params()
    T = head[1].shape[1]
    if case in ("wide", "global", "thresholds_global"):
        params = dataclasses.replace(
            params, bins=30000 if case == "wide" else 60000)
        assert k3.scenario_fold_layout(T, params)[0] == (case == "wide")
    if case.startswith("thresholds"):
        params = dataclasses.replace(params, thresholds=tuple(
            float(x) for x in range(-4000, 6000, 1000)))
        assert len(params.thresholds) > k3.MAX_THR

    def carry():
        return {k: v.clone() for k, v in state["carry"].items()}

    def launch(fn, scs):
        scen = schema.encode_batch(scs, len(scs), device=card)
        return fn(*head, carry(), sim.init_scenario_acc(len(scs)), *tail,
                  site=site, fleet=fleet, scen=scen, params=params,
                  cohort=cohort, per_chain=True, **kw)

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
    # the fold on its own, on the producer's meter and pv
    _, meter, pv = k3.scenario_producer(*head, carry(), *tail[1:],
                                        site=site, fleet=fleet, **kw)
    scen = schema.encode_batch(rows, len(rows), device=card)
    fp = k3.scenario_fold_plain(meter, pv, head[1][0],
                                sim.init_scenario_acc(len(rows)), tail[0],
                                scen, params, cohort, per_chain=True)
    # with and without the producer's flags (a masked tail's loads skipped)
    tame = k3._scenario_producer_cuda(*head, carry(), *tail[1:], site=site,
                                      fleet=fleet, **kw)[3]
    for flags in (None, tame):
        fk = k3.scenario_fold(meter, pv, head[1][0],
                              sim.init_scenario_acc(len(rows)), tail[0],
                              scen=scen, params=params, cohort=cohort,
                              per_chain=True, tame=flags)
        for k in fp[0]:
            assert torch.equal(fk[0][k], fp[0][k]), k
        for k, v in fp[1].items():
            if k == "chain":
                for c in v:
                    assert torch.equal(fk[1]["chain"][c], v[c]), c
            else:
                assert torch.equal(fk[1][k], v), k
    for i, row in enumerate(rows):
        _, a1, d1 = launch(k3.block_step_scenario, [row])
        for k in a1:
            assert torch.equal(a1[k][0], ak[k][i]), (i, k)
        for k in dp:
            if k != "chain":
                assert torch.equal(d1[k][0], dk[k][i]), (i, k)
    _, acc = k3.block_step_acc(*head, carry(), sim.init_reduce_acc(), *tail,
                               site=site, fleet=fleet, **kw)
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
    keys = rng.split(rng.rbg_key(3, card), 512, "rbg")
    assert torch.equal(k1.philox_fill("bits", keys, 8, per_key=True),
                       rng.random_bits(keys, (8,), per_key=True,
                                       impl="rbg"))
    assert torch.equal(k1.uniform(keys, impl="rbg"),
                       rng.uniform(keys, (), impl="rbg"))
    cfg = SimConfig(start="2019-09-05 11:00:00", duration_s=2160,
                    n_chains=512, block_s=1080, prng_impl="rbg")
    with pytest.warns(RuntimeWarning, match="rbg"):
        sim = Simulation(cfg, device=card)
    state = sim.init_state()
    ins = sim.host_inputs(0)
    args = (state["k_arr"], state["k_min"], state["cc_carry"], state["cc0"],
            ins.bounds, ins.mh_idx, ins.mh_frac)
    tk, ck = k2.sampler_windows(*args, impl="rbg")
    tp, cp = k2.windows_plain(*args, impl="rbg")
    assert all(torch.equal(tk[k], tp[k]) for k in tk) and torch.equal(ck, cp)
    head = (tk, ins.rows_i, ins.rows_f, state["k_scan"], state["k_meter"])
    tail = (cfg.duration_s, cfg.meter_max_w, cfg.site.surface_tilt,
            cfg.site.albedo)
    for layout in ("scan", "scan2", "trace"):
        _, ak = k3.block_step_acc(
            *head, {k: v.clone() for k, v in state["carry"].items()},
            sim.init_reduce_acc(), *tail, layout=layout, impl="rbg")
        _, ap = k3.block_step_plain(
            *head, {k: v.clone() for k, v in state["carry"].items()},
            sim.init_reduce_acc(), *tail, layout=layout, impl="rbg")
        assert all(torch.equal(ak[k], ap[k]) for k in ak), layout


@pytest.mark.cuda
def test_k14_matches_plain_on_card(card):
    """K14: unsafe_rbg's Philox key derivations on the card (init_state's
    unbatched and batched splits, a batched fold_in), and the unsafe_rbg
    windows and block step in each draw layout, bit for bit against their
    plain versions."""
    from tmhpvsim_torch import rng
    from tmhpvsim_torch.kernels import threefry as k1

    U = "unsafe_rbg"
    root = rng.split(rng.root_key(3, U, card), 2, U)[0]
    keys = k1.split(root, 512, U)
    assert torch.equal(keys, rng.split(root, 512, U))
    assert torch.equal(k1.split(keys, 5, U), rng.split(keys, 5, U))
    d = torch.arange(512, device=card) + 40
    assert torch.equal(k1.fold_in(keys, d, U), rng.fold_in(keys, d, U))
    cfg = SimConfig(start="2019-09-05 11:00:00", duration_s=2160,
                    n_chains=512, block_s=1080, prng_impl=U)
    with pytest.warns(RuntimeWarning, match=U):
        sim = Simulation(cfg, device=card)
    state = sim.init_state()
    ins = sim.host_inputs(0)
    args = (state["k_arr"], state["k_min"], state["cc_carry"], state["cc0"],
            ins.bounds, ins.mh_idx, ins.mh_frac)
    tk, ck = k2.sampler_windows(*args, impl=U)
    tp, cp = k2.windows_plain(*args, impl=U)
    assert all(torch.equal(tk[k], tp[k]) for k in tk) and torch.equal(ck, cp)
    head = (tk, ins.rows_i, ins.rows_f, state["k_scan"], state["k_meter"])
    tail = (cfg.duration_s, cfg.meter_max_w, cfg.site.surface_tilt,
            cfg.site.albedo)
    for layout in ("scan", "scan2", "trace"):
        _, ak = k3.block_step_acc(
            *head, {k: v.clone() for k, v in state["carry"].items()},
            sim.init_reduce_acc(), *tail, layout=layout, impl=U)
        _, ap = k3.block_step_plain(
            *head, {k: v.clone() for k, v in state["carry"].items()},
            sim.init_reduce_acc(), *tail, layout=layout, impl=U)
        assert all(torch.equal(ak[k], ap[k]) for k in ak), layout


@pytest.mark.cuda
def test_nan_minmax_all_reduce_under_nccl(card, tmp_path):
    """The sharded runs' MIN / MAX all_reduce on the card: NCCL in a group
    of one through the package's own ``initialize``; NaN, infinities and
    -0.0 against +0.0 keep every bit (the leaves ride as order keys)."""
    from tmhpvsim_torch.parallel import distributed

    assert distributed.initialize(f"file://{tmp_path}/nccl", 1, 0,
                                  device=card)
    try:
        assert torch.distributed.get_backend() == "nccl"
        vals = (float("nan"), -float("inf"), -2.5, -0.0, 0.0, 0.75,
                float("inf"))
        a = torch.tensor(vals, device=card)
        out, _ = distributed.allreduce_deltas({"min_x": a, "max_x": a}, None)
        for k in ("min_x", "max_x"):
            assert torch.equal(out[k].isnan(), a.isnan())
            ok = ~a.isnan()
            assert torch.equal(out[k][ok].view(torch.int32),
                               a[ok].view(torch.int32))
    finally:
        distributed.shutdown()


@pytest.mark.cuda
def test_real_probe_beats_or_matches_static(card, tmp_path, monkeypatch):
    """The JAX package's acceptance test of its autotuner, on the card:
    ``tune='auto'`` at 256 chains x 1080 s over a narrowed grid probes
    every candidate with real blocks (the kernels, never a plain
    version), picks a plan whose measured rate is at least the static
    candidate's, and the second resolution probes nothing."""
    from tmhpvsim_torch.engine import autotune

    monkeypatch.setenv("TMHPVSIM_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.setattr(autotune, "CANDIDATE_UNROLLS", (1, 8))
    monkeypatch.setattr(autotune, "CANDIDATE_SLAB_CHAINS", (None,))
    monkeypatch.setattr(autotune, "CANDIDATE_RNG_BATCHES", ("scan",))
    monkeypatch.setattr(autotune, "CANDIDATE_GEOM_STRIDES", (1,))
    cfg = SimConfig(start="2019-09-05 00:00:00", duration_s=1080 * 3,
                    n_chains=256, seed=0, block_s=1080, tune="auto")
    before = autotune.PROBE_COUNT
    kernels.reset_counts()
    plan = autotune.resolve_plan(cfg, device=card)
    assert autotune.PROBE_COUNT - before >= \
        len(autotune.candidate_plans(cfg)) > 0
    assert plan.source == "probe"
    assert sum(c.launches for c in kernels.COUNTERS) > 0
    cands = autotune.cached_candidates(cfg, device=card)
    assert not [c for c in cands if "error" in c], cands
    static = autotune.static_plan(cfg)
    rated = {(c["block_impl"], c["scan_unroll"],
              c["blocks_per_dispatch"]): c["rate"]
             for c in cands if "rate" in c and "sentinel" not in c}
    best = max(c["rate"] for c in cands if "rate" in c)
    assert best >= rated[(static.block_impl, static.scan_unroll,
                          static.blocks_per_dispatch)]
    assert best == next(c["rate"] for c in cands if "rate" in c and all(
        c[f] == getattr(plan, f) for f in autotune._TUNED))
    before = autotune.PROBE_COUNT
    again = autotune.resolve_plan(cfg, device=card)
    assert autotune.PROBE_COUNT == before and again.source == "cache"
