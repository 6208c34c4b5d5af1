"""``python -m tmhpvsim_torch pvsim --checkpoint`` on the CPU: a crashed run
rerun with the same command writes the bytes of an uninterrupted run
(reduce, and trace and ensemble rows exactly once), a resume against a
missing CSV is refused, ``--preempt-grace`` turns a real SIGTERM to this
process (on the main thread) into a clean stop, ``--checkpoint-keep``
rotates, ``--checkpoint-async on`` writes the same output, and the knobs'
guards and the run report's checkpoint section (read by the JAX
package's ``tools/ckpt_report.py``) hold.  Port meets port: byte for
byte.
"""

import json
import os
import signal
import subprocess
import sys
import threading

import pytest

from tmhpvsim_torch.cli import main
from tmhpvsim_torch.engine import checkpoint as ckpt
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--device", "cpu", "--no-realtime", "--duration", "360",
        "--start", "2019-09-05 10:00:00", "--block-s", "120", "--chains",
        "4"]


def _pvsim(out, *extra, seed=("--seed", "9")):
    return main(["pvsim", str(out), *BASE, *seed, *extra])


@pytest.fixture(scope="module")
def whole(tmp_path_factory):
    """The uninterrupted runs' CSVs: trace, ensemble and reduce."""
    d = tmp_path_factory.mktemp("whole")
    out = {}
    for mode in ("trace", "ensemble", "reduce"):
        out[mode] = d / f"{mode}.csv"
        assert _pvsim(out[mode], "--output", mode) == 0
    return {k: v.read_bytes() for k, v in out.items()}


def _dying_save(monkeypatch, on_call=2):
    """ckpt.save raises on its ``on_call``-th call: the run crashes after
    the blocks before it were checkpointed."""
    real = ckpt.save
    calls = {"n": 0}

    def dying(*a, **kw):
        calls["n"] += 1
        if calls["n"] == on_call:
            raise RuntimeError("simulated crash")
        return real(*a, **kw)

    monkeypatch.setattr(ckpt, "save", dying)


def test_cli_reduce_crash_then_resume(whole, tmp_path, monkeypatch):
    part, ck = tmp_path / "part.csv", tmp_path / "ck.npz"
    with monkeypatch.context() as m:
        _dying_save(m)
        with pytest.raises(RuntimeError, match="simulated crash"):
            _pvsim(part, "--output", "reduce", "--checkpoint", str(ck))
    assert not part.exists()  # the reduce CSV is written at the end
    assert ckpt.peek_meta(str(ck))["next_block"] == 1
    assert _pvsim(part, "--output", "reduce", "--checkpoint", str(ck)) == 0
    assert part.read_bytes() == whole["reduce"]


@pytest.mark.parametrize("mode", ["trace", "ensemble"])
def test_cli_rows_crash_then_resume_exactly_once(whole, tmp_path,
                                                 monkeypatch, mode):
    """The crash comes after block 2's rows and before its checkpoint: the
    rerun cuts the rows past block 1's checkpoint and appends the rest,
    once each."""
    part, ck = tmp_path / "part.csv", tmp_path / "ck.npz"
    with monkeypatch.context() as m:
        _dying_save(m)
        with pytest.raises(RuntimeError, match="simulated crash"):
            _pvsim(part, "--output", mode, "--checkpoint", str(ck))
    assert len(part.read_text().splitlines()) == 1 + 240
    # a resume without --seed takes the checkpoint's
    assert _pvsim(part, "--output", mode, "--checkpoint", str(ck),
                  seed=()) == 0
    assert part.read_bytes() == whole[mode]
    assert len(part.read_text().splitlines()) == 1 + 360


def test_cli_resume_against_missing_csv_refused(tmp_path, monkeypatch):
    part, ck = tmp_path / "part.csv", tmp_path / "ck.npz"
    with monkeypatch.context() as m:
        _dying_save(m)
        with pytest.raises(RuntimeError, match="simulated crash"):
            _pvsim(part, "--checkpoint", str(ck))
    part.unlink()
    with pytest.raises(RuntimeError, match="restore the CSV"):
        _pvsim(part, "--checkpoint", str(ck))


def test_cli_preempt_grace_on_a_real_sigterm(whole, tmp_path, monkeypatch,
                                             capsys):
    """A SIGTERM to this process while block 1 is saved: the run finishes
    that block, stops with rc 0 and the resume line, and SIGTERM's
    handler is restored; the rerun finishes the file, and its report
    counts the resume."""
    assert threading.current_thread() is threading.main_thread()
    part, ck = tmp_path / "pre.csv", tmp_path / "pck.npz"
    rep = tmp_path / "rep.json"
    before = signal.getsignal(signal.SIGTERM)
    real = ckpt.save

    def save_then_term(*a, **kw):
        real(*a, **kw)
        # the watcher's handler, never the default (which would end the
        # test process)
        assert signal.getsignal(signal.SIGTERM) not in (signal.SIG_DFL,
                                                        before)
        os.kill(os.getpid(), signal.SIGTERM)

    with monkeypatch.context() as m:
        m.setattr(ckpt, "save", save_then_term)
        assert _pvsim(part, "--checkpoint", str(ck), "--preempt-grace",
                      "30") == 0
    assert signal.getsignal(signal.SIGTERM) == before
    assert "preempted — state through block 1/3 checkpointed" in \
        capsys.readouterr().out
    assert len(part.read_text().splitlines()) == 1 + 120
    assert _pvsim(part, "--checkpoint", str(ck), "--preempt-grace", "30",
                  "--run-report", str(rep)) == 0
    assert part.read_bytes() == whole["trace"]
    doc = json.loads(rep.read_text())
    assert doc["resilience"]["resumes"] == 1
    assert doc["resilience"]["resumed_block"] == 1
    assert doc["checkpoint"]["restores"] == 1
    assert doc["checkpoint"]["saves"] == 2


def test_cli_checkpoint_keep_rotation(tmp_path):
    out, ck = tmp_path / "out.csv", tmp_path / "ck.npz"
    assert _pvsim(out, "--checkpoint", str(ck), "--checkpoint-keep",
                  "2") == 0
    man = ckpt.read_manifest(str(ck))
    assert man["keep"] == 2 and man["latest"] == 3
    assert [e["gen"] for e in man["generations"]] == [2, 3]
    assert not (tmp_path / "ck.npz.g1").exists()


def test_cli_checkpoint_async_output_identical(whole, tmp_path):
    """--checkpoint-async on writes the uninterrupted bytes, its final
    snapshot is on disk at exit, and the run report's checkpoint section
    (counted by the writer) passes the JAX package's
    ``tools/ckpt_report.py``."""
    out, ck = tmp_path / "async.csv", tmp_path / "ck.npz"
    rep = tmp_path / "rep.json"
    assert _pvsim(out, "--checkpoint", str(ck), "--checkpoint-async", "on",
                  "--run-report", str(rep)) == 0
    assert out.read_bytes() == whole["trace"]
    assert ckpt.peek_meta(str(ck))["next_block"] == 3
    sec = json.loads(rep.read_text())["checkpoint"]
    assert sec["saves"] == sec["async_saves"] == 3
    r = subprocess.run([sys.executable,
                        os.path.join(ROOT, "tools", "ckpt_report.py"),
                        str(ck), str(rep)], capture_output=True, text=True,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "checkpoint section valid" in r.stdout


def test_cli_checkpoint_knob_guards(tmp_path, capsys):
    out = str(tmp_path / "o.csv")
    for flags, msg in ((["--checkpoint-keep", "0"],
                        "--checkpoint-keep must be >= 1"),
                       (["--preempt-grace", "-1"],
                        "--preempt-grace must be >= 0")):
        with pytest.raises(SystemExit):
            main(["pvsim", out, *BASE, *flags])
        assert msg in capsys.readouterr().err
    for flags, name in ((["--checkpoint", "ck.npz"], "--checkpoint"),
                        (["--checkpoint-keep", "2"], "--checkpoint-keep"),
                        (["--checkpoint-async", "on"], "--checkpoint-async"),
                        (["--preempt-grace", "5"], "--preempt-grace")):
        with pytest.raises(SystemExit):
            main(["pvsim", out, "--backend", "asyncio", *flags])
        assert f"{name} requires --backend=device" in \
            capsys.readouterr().err
