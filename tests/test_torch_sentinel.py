"""The bf16 path's safety chain in the port against the JAX package, on the
CPU: the float64 golden model, the drift sentinel and its bands, strict
telemetry, the telemetry escalation, the refusals of what is still to
port, and the CLI with its run report.

* Golden model: ``GoldenClearskyIndex`` / ``GoldenPVModel`` streams and
  ``_golden_reference`` bands bit-identical to the JAX package's for a
  seed.
* ``DriftSentinel``: given the same block summaries, the JAX sentinel's
  verdicts and ``report()``; a NaN counter trips it; a doctored ensemble
  bias raises ``DriftError`` under strict, as tests/test_precision.py
  does in JAX.
* Config and CLI: bf16 with telemetry 'off' resolves to 'light'; the
  scenario engine builds under bf16, and a strict rbg config raises as
  the JAX package's does; ``pvsim --output reduce --compute-dtype bf16
  --telemetry-strict --run-report`` writes a report whose plan and
  precision sections say bf16 and whose telemetry section is the
  sentinel's.
"""

import datetime as dt
import json

import numpy as np
import pytest

from tmhpvsim_torch import config as tcfg
from tmhpvsim_torch.cli import main as tcli
from tmhpvsim_torch.engine import golden as tgolden
from tmhpvsim_torch.engine.simulation import Simulation as TSim
from tmhpvsim_torch.models import markov_hourly as tmh
from tmhpvsim_torch.models import renewal as trenewal
from tmhpvsim_torch.obs import metrics as tmetrics
from tmhpvsim_torch.obs import report as treport
from tmhpvsim_torch.obs import sentinel as tsen
from tmhpvsim_torch.obs import telemetry as ttel
from tmhpvsim_tpu import config as jcfg
from tmhpvsim_tpu.engine import golden as jgolden
from tmhpvsim_tpu.models import markov_hourly as jmh
from tmhpvsim_tpu.models import renewal as jrenewal
from tmhpvsim_tpu.obs import metrics as jmetrics
from tmhpvsim_tpu.obs import sentinel as jsen
from tmhpvsim_tpu.obs import telemetry as jtel

#: a short bf16 run: 2 reference blocks of 600 s from 10:00 (the golden
#: reference costs a few golden seconds per block second)
CFG = dict(start="2019-09-05 10:00:00", duration_s=1200, n_chains=4,
           seed=7, block_s=600)
T0 = dt.datetime(2019, 9, 5, 10, 0, 0)


def test_golden_streams_bit_identical():
    """The golden csi and pv streams, and the pieces they are made of (the
    float64 Markov chain, the reference renewal), number for number."""
    a = jgolden.GoldenPVModel(T0, rng=np.random.default_rng(3), cache_s=900)
    b = tgolden.GoldenPVModel(T0, rng=np.random.default_rng(3), cache_s=900)
    ts = [T0 + dt.timedelta(seconds=i) for i in range(1800)]
    want = [a.next(t) for t in ts]
    assert [b.next(t) for t in ts] == want
    assert max(want) > 50.0
    assert np.array_equal(
        jmh.chain_numpy(np.random.default_rng(5), 200, 0.3),
        tmh.chain_numpy(np.random.default_rng(5), 200, 0.3))
    ra = jrenewal.ReferenceRenewal(0.4, 3.0, np.random.default_rng(9))
    rb = trenewal.ReferenceRenewal(0.4, 3.0, np.random.default_rng(9))
    assert [next(ra) for _ in range(3000)] == [next(rb) for _ in range(3000)]


@pytest.mark.parametrize("extra", [{}, {"site_grid": "grid"}],
                         ids=["shared", "grid"])
def test_golden_reference_bands_bit_identical(extra):
    """``_golden_reference``: csi and pv bands of a shared site, csi only
    for a site grid."""
    kw = dict(CFG)
    if extra:
        jkw = dict(kw, site_grid=jcfg.SiteGrid.regular((46, 50), (9, 13), 2,
                                                       2))
        tkw = dict(kw, site_grid=tcfg.SiteGrid.regular((46, 50), (9, 13), 2,
                                                       2))
    else:
        jkw = tkw = kw
    want = jsen._golden_reference(jcfg.SimConfig(**jkw), 2)
    got = tsen._golden_reference(tcfg.SimConfig(**tkw), 2)
    assert got == want
    assert ("pv" in want[0]) == (not extra)


def _summaries(bias=0.0, nan_at=None):
    """Block summaries as obs/telemetry.summarize gives them: csi, pv,
    meter and residual means near the golden bands, pv moved by
    ``bias``; a NaN in block ``nan_at``."""
    out = []
    for b, (csi, pv) in enumerate(((0.93, 120.0), (0.95, 150.0))):
        meter = 4500.0
        fields = {}
        for f, m in (("csi", csi), ("pv", pv + bias), ("meter", meter),
                     ("residual", meter - pv - bias)):
            fields[f] = {"nan": int(nan_at == b and f == "pv"), "inf": 0,
                         "observed": True, "min": 0.0, "max": 2 * m,
                         "mean": m, "std": 1.0}
        out.append({"count": 2400.0, "fields": fields})
    return out


@pytest.mark.parametrize("case", ["ok", "drift", "nan"])
def test_sentinel_verdicts_and_report_match_jax(case):
    """The same summaries give the JAX sentinel's verdict per block and
    its report; non-strict warns, strict raises DriftError."""
    kw = {"drift": dict(bias=400.0), "nan": dict(nan_at=1)}.get(case, {})
    js = jsen.DriftSentinel(jcfg.SimConfig(**CFG), level="light")
    ts = tsen.DriftSentinel(tcfg.SimConfig(**CFG), level="light")
    for bi, summary in enumerate(_summaries(**kw)):
        assert ts.observe_block(bi, summary) == js.observe_block(bi, summary)
    assert ts.report() == js.report()
    assert ts.verdict == case
    strict = tsen.DriftSentinel(tcfg.SimConfig(**CFG), strict=True)
    if case == "ok":
        for bi, summary in enumerate(_summaries()):
            strict.observe_block(bi, summary)
    else:
        with pytest.raises(tsen.DriftError):
            for bi, summary in enumerate(_summaries(**kw)):
                strict.observe_block(bi, summary)


def test_publish_matches_jax():
    """telemetry.publish: the same counters and gauges in the registry."""
    summary = _summaries(nan_at=0)[0]
    summary["csi_hist"] = [1.0, 0.0, 3.0]
    summary["cloud_occupancy"] = {"clear": 5.0, "covered": 0.0}
    jr, tr = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    jtel.publish(jr, summary)
    ttel.publish(tr, summary)
    assert tr.snapshot() == jr.snapshot()


def test_bf16_escalates_telemetry():
    sim = TSim(tcfg.SimConfig(**CFG, compute_dtype="bf16"), device="cpu")
    assert sim.plan.compute_dtype == "bf16" and sim.plan.telemetry == "light"
    full = tcfg.resolve_plan(tcfg.SimConfig(compute_dtype="bf16",
                                            telemetry="full"))
    assert full.telemetry == "full"
    assert tcfg.resolve_plan(tcfg.SimConfig()).telemetry == "off"
    assert tcfg.resolve_plan(tcfg.SimConfig()).compute_dtype == "f32"
    with pytest.raises(ValueError, match="compute_dtype"):
        tcfg.resolve_plan(tcfg.SimConfig(compute_dtype="fp8"))


def test_doctored_bias_trips_strict_sentinel(monkeypatch):
    """A pv bias past the golden band stops a strict bf16 run with
    DriftError at the first block (the JAX test biases csi inside its
    scan; the port's plain body is the place to bias)."""
    from tmhpvsim_torch.kernels import block_step as k3

    orig = k3._body_plain

    def biased(*a, **k):
        carry, meter, ac, csi, covered = orig(*a, **k)
        return carry, meter, ac + 400.0, csi, covered

    monkeypatch.setattr(k3, "_body_plain", biased)
    sim = TSim(tcfg.SimConfig(**CFG, compute_dtype="bf16",
                              telemetry_strict=True), device="cpu")
    with pytest.raises(tsen.DriftError, match="pv"):
        sim.run_reduced()
    assert sim.sentinel.verdict == "drift"


def test_refusals_name_what_is_still_to_port():
    """What the port once refused now runs: a bf16 scenario engine builds
    (K12 in K10) and an rbg config is accepted; a strict rbg run raises
    as the JAX package's does (engine/simulation.py:296-301);
    'unsafe_rbg' stays refused by name."""
    from tmhpvsim_torch.serve.server import ScenarioEngine
    from tmhpvsim_tpu import config as jcfg
    from tmhpvsim_tpu.engine import Simulation as JSim

    eng = ScenarioEngine(tcfg.SimConfig(**CFG, compute_dtype="bf16"), (1,),
                         device="cpu")
    assert eng.sim.plan.compute_dtype == "bf16"
    strict = dict(prng_impl="rbg", telemetry_strict=True)
    with pytest.raises(ValueError, match="rbg") as want:
        JSim(jcfg.SimConfig(**strict))
    with pytest.raises(ValueError, match="rbg") as got:
        TSim(tcfg.SimConfig(**strict), device="cpu")
    assert "prng_impl='rbg'" in str(want.value) \
        and "prng_impl='rbg'" in str(got.value)
    with pytest.raises(NotImplementedError, match="unsafe_rbg"):
        tcfg.SimConfig(prng_impl="unsafe_rbg")


def test_cli_bf16_strict_run_report(tmp_path):
    """The CLI end to end: the report's plan and precision sections say
    bf16 (the old report said f32 whatever the plan), telemetry is the
    sentinel's strict report, and the JAX validator accepts it."""
    out, rep = tmp_path / "r.csv", tmp_path / "r.json"
    rc = tcli(["pvsim", str(out), "--output", "reduce", "--compute-dtype",
               "bf16", "--telemetry-strict", "--chains", "2", "--duration",
               "1200", "--block-s", "600", "--seed", "7", "--start",
               CFG["start"], "--no-realtime", "--device", "cpu",
               "--run-report", str(rep)])
    assert rc == 0
    doc = json.loads(rep.read_text())
    treport.validate_report(doc)
    from tmhpvsim_tpu.obs.report import validate_report as jvalidate

    jvalidate(doc)
    assert doc["plan"]["compute_dtype"] == "bf16"
    assert doc["precision"]["compute_dtype"] == "bf16"
    assert doc["precision"]["telemetry"] == "light"
    tel = doc["telemetry"]
    assert tel["strict"] and tel["verdict"] == "ok" and \
        tel["blocks_checked"] == 2 and tel["level"] == "light"
    assert len(out.read_text().splitlines()) == 2 + 2
