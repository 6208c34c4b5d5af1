"""The port's run report against the JAX package's readers, on the CPU.

``pvsim --run-report`` writes the JAX package's RunReport schema
(tmhpvsim_torch/obs/report.py): the JAX ``validate_report`` accepts it,
``tools/fleet_report.py`` and ``tools/precision_report.py`` pick it out by
its ``kind`` and check its ``fleet`` and ``precision`` sections, and the
port's own validator (the card's machine has no jax) agrees with the JAX
one on what it refuses.
"""

import json
import os
import subprocess
import sys

import pytest

from tmhpvsim_torch import config as tcfg
from tmhpvsim_torch.engine.simulation import Simulation as TSim
from tmhpvsim_torch.fleet import FleetParams as TFleet
from tmhpvsim_torch.obs import report as trep
from tmhpvsim_tpu.obs import report as jrep
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START = "2019-09-05 10:00:00"


@pytest.fixture(scope="module")
def cli_report(tmp_path_factory):
    """A fleet run through the CLI with analytics, a precision lever and
    the three plan knobs: ``(report, path)``."""
    from tmhpvsim_torch.cli import main

    d = tmp_path_factory.mktemp("report")
    out, rep = str(d / "r.csv"), str(d / "r.json")
    assert main(["pvsim", out, "--output", "reduce", "--no-realtime",
                 "--fleet-synth", "6", "--fleet-seed", "2", "--analytics",
                 "full", "--duration", "1440", "--block-s", "720",
                 "--seed", "7", "--start", START, "--device", "cpu",
                 "--kernel-impl", "table", "--block-impl", "wide",
                 "--blocks-per-dispatch", "2", "--rng-batch", "block",
                 "--run-report", rep]) == 0
    with open(rep) as f:
        return json.load(f), rep


def test_jax_validator_accepts_the_port_report(cli_report):
    doc, _ = cli_report
    assert jrep.validate_report(doc) is doc
    assert trep.validate_report(doc) is doc
    assert (doc["kind"], doc["schema_version"], doc["app"]) == (
        jrep.REPORT_KIND, jrep.REPORT_SCHEMA_VERSION, "pvsim")
    assert doc["device"]["platform"] == "cpu"
    assert doc["config"]["fleet"]["n_sites"] == 6
    assert doc["config"]["site_grid"] == {"n_sites": 6}


def test_plan_section_in_the_jax_keys(cli_report):
    doc, _ = cli_report
    plan = doc["plan"]
    assert set(plan) == {"block_impl", "scan_unroll", "stats_fusion",
                         "slab_chains", "blocks_per_dispatch",
                         "compute_dtype", "kernel_impl", "rng_batch",
                         "geom_stride", "source"}
    assert plan == {"block_impl": "wide", "scan_unroll": 8,
                    "stats_fusion": "fused", "slab_chains": 6,
                    "blocks_per_dispatch": 2, "compute_dtype": "f32",
                    "kernel_impl": "table", "rng_batch": "block",
                    "geom_stride": 1, "source": "static"}


def test_sections_are_the_runs(cli_report):
    doc, _ = cli_report
    sim = TSim(tcfg.SimConfig(
        fleet=TFleet.synthetic(6, seed=2), analytics="full", seed=7,
        start=START, duration_s=1440, block_s=720, output="reduce",
        kernel_impl="table", block_impl="wide", blocks_per_dispatch=2,
        rng_batch="block"), device="cpu")
    sim.run_reduced()
    assert doc["fleet"] == json.loads(json.dumps(sim.fleet_summary()))
    assert doc["precision"] == sim.precision_doc()
    assert doc["precision"]["rng_batch"] == "block"
    assert doc["fleet"]["regimes"] is None  # the wide fold: unobserved


@pytest.mark.parametrize("tool,section", [
    ("tools/fleet_report.py", "fleet risk summary"),
    ("tools/precision_report.py", "precision axes"),
])
def test_report_tools_check_the_sections(cli_report, tool, section):
    _, path = cli_report
    r = subprocess.run([sys.executable, os.path.join(ROOT, tool), path],
                       capture_output=True, text=True, timeout=120,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert section in r.stdout


def test_report_tools_refuse_a_broken_section(cli_report, tmp_path):
    """The tools really check the port's sections: a cohort row with a
    string count fails fleet_report, an unknown kernel_impl
    precision_report."""
    doc, _ = cli_report
    bad = json.loads(json.dumps(doc))
    bad["fleet"]["cohorts"][0]["count"] = "many"
    bad["precision"]["kernel_impl"] = 7
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(bad))
    for tool in ("tools/fleet_report.py", "tools/precision_report.py"):
        r = subprocess.run([sys.executable, os.path.join(ROOT, tool),
                            str(path)], capture_output=True, text=True,
                           timeout=120, cwd=ROOT)
        assert r.returncode != 0, tool
        assert "INVALID" in r.stderr, tool


@pytest.mark.parametrize("mutate,match", [
    (lambda d: d.update(kind="other"), "kind"),
    (lambda d: d.update(schema_version=99), "schema_version"),
    (lambda d: d.update(extra={}), "unknown keys"),
    (lambda d: d.pop("device"), "device"),
    (lambda d: d["device"].update(n_devices="1"), "n_devices"),
    (lambda d: d["fleet"]["cohorts"][0].update(count=1.5), "cohorts"),
])
def test_port_validator_refuses_as_jax_does(cli_report, mutate, match):
    doc, _ = cli_report
    bad = json.loads(json.dumps(doc))
    mutate(bad)
    with pytest.raises(ValueError, match=match):
        jrep.validate_report(bad)
    with pytest.raises(ValueError, match=match):
        trep.validate_report(bad)


def test_port_validator_refuses_sections_it_cannot_check(cli_report):
    doc = json.loads(json.dumps(cli_report[0]))
    doc["cost"] = {"basis": "model"}
    with pytest.raises(ValueError, match="cost"):
        trep.validate_report(doc)


def test_default_run_report_has_no_precision(tmp_path):
    """A shared-site run at the defaults: no fleet and no precision
    section, the plan at the static defaults."""
    from tmhpvsim_torch.apps.pvsim import pvsim

    rep = str(tmp_path / "r.json")
    pvsim(str(tmp_path / "r.csv"), 720, 2, 3, START, output="reduce",
          device="cpu", run_report=rep)
    with open(rep) as f:
        doc = json.load(f)
    jrep.validate_report(doc)
    assert doc["fleet"] is None and doc["precision"] is None
    assert doc["plan"]["block_impl"] == "scan"
    assert doc["plan"]["blocks_per_dispatch"] == 1
