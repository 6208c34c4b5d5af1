"""The port's CLI (``python -m tmhpvsim_torch pvsim``) against the JAX
CLI on the CPU at tests/test_torch_engine.py's shape and tolerance (the
reduce rows, the per-second trace and ensemble CSVs), its refusals, the
default device, and the fleet CLI's run report; in a file of its own so
that a run of the suite that splits its workers by file takes these runs
apart from that file's JAX references.
"""

import csv
import json

import numpy as np
import pytest
import torch

from test_torch_engine import SMALL
from tmhpvsim_torch import config as tcfg
from tmhpvsim_torch.engine.simulation import REDUCE_STATS
from tmhpvsim_torch.engine.simulation import Simulation as TSim
from tmhpvsim_torch.fleet import FleetParams as TFleet
from test_torch_threads import one_torch_thread  # noqa: F401


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_cli_matches_jax_cli(tmp_path):
    from click.testing import CliRunner

    from tmhpvsim_torch.cli import main
    from tmhpvsim_tpu.cli import pvsim

    common = ["--output", "reduce", "--no-realtime", "--chains", "3",
              "--duration", "7200", "--block-s", "3600", "--seed", "7",
              "--start", SMALL["start"]]
    jpath, tpath = str(tmp_path / "jax.csv"), str(tmp_path / "torch.csv")
    res = CliRunner().invoke(pvsim, [jpath, "--backend", "jax",
                                     "--block-impl", "scan",
                                     "--compile-cache", "off"] + common)
    assert res.exit_code == 0, res.output
    assert main(["pvsim", tpath, "--device", "cpu"] + common) == 0
    jrows, trows = _read_csv(jpath), _read_csv(tpath)
    assert jrows[0] == trows[0] == ["chain"] + list(REDUCE_STATS)
    assert [r[0] for r in jrows] == [r[0] for r in trows]
    for jr, tr in zip(jrows[1:], trows[1:]):
        want = np.asarray(jr[1:], np.float64)
        got = np.asarray(tr[1:], np.float64)
        assert got[-1] == want[-1]  # n_seconds
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-2)


@pytest.mark.parametrize("mode", ["trace", "ensemble"])
def test_cli_output_matches_jax_cli(tmp_path, mode):
    """The per-second CSVs of both CLIs from the same seed: identical
    header and time column, the numbers within the engine tolerance."""
    from click.testing import CliRunner

    from tmhpvsim_torch.cli import main
    from tmhpvsim_tpu.cli import pvsim

    common = ["--output", mode, "--no-realtime", "--chains", "3",
              "--duration", "7200", "--block-s", "3600", "--seed", "7",
              "--start", SMALL["start"]]
    jpath, tpath = str(tmp_path / "jax.csv"), str(tmp_path / "torch.csv")
    res = CliRunner().invoke(pvsim, [jpath, "--backend", "jax",
                                     "--block-impl", "scan",
                                     "--compile-cache", "off"] + common)
    assert res.exit_code == 0, res.output
    assert main(["pvsim", tpath, "--device", "cpu"] + common) == 0
    jrows, trows = _read_csv(jpath), _read_csv(tpath)
    assert len(trows) == len(jrows) == 1 + SMALL["duration_s"]
    assert trows[0] == jrows[0] == ["time", "meter", "pv", "residual load"]
    assert [r[0] for r in trows] == [r[0] for r in jrows]
    want = np.asarray([r[1:] for r in jrows[1:]], np.float64)
    got = np.asarray([r[1:] for r in trows[1:]], np.float64)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-2)


@pytest.mark.parametrize("argv, match", [
    (["--output", "reduce"], "--no-realtime"),
    (["--output", "ensemble", "--no-realtime", "--chain", "1"], "--chain"),
    (["--no-realtime", "--chain", "5"], "out of range"),
    (["--no-realtime", "--site-grid", "46:50"], "--site-grid"),
])
def test_cli_refuses_bad_requests(tmp_path, argv, match):
    from tmhpvsim_torch.cli import main

    with pytest.raises(SystemExit, match=match):
        main(["pvsim", str(tmp_path / "x.csv"), "--duration", "60",
              "--device", "cpu"] + argv)


def test_without_device_needs_cuda(tmp_path):
    """The port runs on the card unless asked for the CPU: without CUDA,
    the default raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        TSim(tcfg.SimConfig(**SMALL))
    from tmhpvsim_torch.cli import main

    with pytest.raises(RuntimeError, match="CUDA"):
        main(["pvsim", str(tmp_path / "x.csv"), "--output", "reduce",
              "--no-realtime", "--duration", "60", "--seed", "1"])


def test_cli_fleet_run_report(tmp_path):
    """--fleet-synth with --analytics in reduce mode: one CSV row per site
    and a run report (the JAX package's RunReport schema) whose fleet
    section is the run's fleet_summary() (and no precision section: the
    levers at their defaults)."""
    from tmhpvsim_torch.cli import main

    out, rep = str(tmp_path / "r.csv"), str(tmp_path / "r.json")
    argv = ["--output", "reduce", "--no-realtime", "--fleet-synth", "6",
            "--fleet-seed", "2", "--analytics", "risk", "--duration", "1800",
            "--seed", "7", "--start", SMALL["start"]]
    assert main(["pvsim", out, "--device", "cpu", "--run-report", rep]
                + argv) == 0
    rows = _read_csv(out)
    assert len(rows) == 1 + 6 + 1 and rows[-1][0] == "ensemble"
    with open(rep) as f:
        report = json.load(f)
    sim = TSim(tcfg.SimConfig(
        fleet=TFleet.synthetic(6, seed=2), analytics="risk", seed=7,
        start=SMALL["start"], duration_s=1800, block_s=1800,
        output="reduce"), device="cpu")
    sim.run_reduced()
    from tmhpvsim_tpu.obs.report import validate_report

    validate_report(report)
    assert report["kind"] == "tmhpvsim_tpu.run_report" and \
        report["app"] == "pvsim"
    assert report["fleet"] == json.loads(json.dumps(sim.fleet_summary()))
    assert report["precision"] is None
    assert report["fleet"]["level"] == "risk"


@pytest.mark.parametrize("argv, match", [
    (["--fleet-synth", "3", "--fleet-csv", "f.csv"], "not allowed"),
    (["--fleet-synth", "3", "--site-grid", "46:50:2,9:13:2"], "not allowed"),
    (["--fleet-synth", "0"], "--fleet-synth"),
    (["--fleet-csv", "missing.csv"], "missing.csv"),
])
def test_cli_fleet_refuses(tmp_path, capsys, argv, match):
    from tmhpvsim_torch.cli import main

    with pytest.raises(SystemExit) as e:
        main(["pvsim", str(tmp_path / "x.csv"), "--output", "reduce",
              "--no-realtime", "--duration", "60", "--device", "cpu"]
             + argv)
    assert match in str(e.value) + capsys.readouterr().err
