"""The block step's redraw-heavy edge block, on the CPU: the inputs the
card's lean-step checks use (chip_smoke.py ``edge_block`` and
``phase_lean_edges``, tests/test_torch_kernels.py
``test_lean_step_edges_match_plain_on_card``) are inputs the JAX
reference accepts and agrees on.

Wind speeds x16 make renewal cycles a few seconds long (redraws in
consecutive seconds and in a tile's first and last second); the block
is the last hour of daylight and ends 30 s before its last tile does.  One
block of 256 chains, from 18:50:00 and from 18:50:30 (off a whole
minute: the minute index changes inside every tile), goes through the JAX scan (``_block_step_scan_acc``, float32 in
x32) and through the port's ``block_step_plain``, from the same windows
with their wind-speed table scaled alike (a power of two, exact in both):
``n_seconds`` exact, the rest at the engine tolerance (rtol 2e-5, atol
1e-2, tests/test_engine.py).

The same blocks with the telemetry observer are
tests/test_torch_redraw_tel.py's (a file of their own, so that a run of
the suite split by file takes them on another worker).
"""

import jax
import numpy as np
import pytest

from tmhpvsim_torch.config import SimConfig
from tmhpvsim_torch.engine.simulation import REDUCE_STATS, Simulation
from tmhpvsim_torch.kernels import block_step as k3
from tmhpvsim_tpu import config as jcfg
from tmhpvsim_tpu.engine import Simulation as JSim
from tmhpvsim_tpu.models import clearsky_index as jci
from test_torch_threads import one_torch_thread  # noqa: F401

#: one 3600 s block from 18:50 (sunset in its last minutes), 30 s of it
#: past the duration
CFG = dict(duration_s=3570, n_chains=256, seed=3, block_s=3600)
WS = 16.0


@pytest.mark.parametrize("start", ["2019-09-05 18:50:00",
                                   "2019-09-05 18:50:30"],
                         ids=["on-minute", "off-minute"])
def test_redraw_heavy_block_matches_jax_scan(monkeypatch, start):
    real_tables = jci.value_major_tables

    def jax_tables(arrays, minute_vals):
        out = real_tables(arrays, minute_vals)
        return dict(out, ws=out["ws"] * WS)

    monkeypatch.setattr(jci, "value_major_tables", jax_tables)
    with jax.enable_x64(False):
        js = JSim(jcfg.SimConfig(block_impl="scan", dtype="float32",
                                 scan_unroll=1, start=start, **CFG))
        # the reduce step is _block_step_scan_acc
        assert js._impl == "scan"
        want = {k: np.asarray(v) for k, v in js.run_reduced().items()}

    ts = Simulation(SimConfig(start=start, **CFG), device="cpu")
    real_windows = ts._windows
    counts = {}

    def windows(state, inputs):
        tables, cc = real_windows(state, inputs)
        tables = dict(tables, ws=tables["ws"] * WS)
        red = k3.redraws_plain(tables, inputs.rows_i, inputs.rows_f,
                               state["k_scan"], state["carry"])
        m = inputs.rows_i[3]
        counts.update(first=int(red[0::60].sum()),
                      last=int(red[59::60].sum()),
                      consecutive=int((red[1:] & red[:-1]).sum()),
                      fixed=bool((m[0::60] == m[59::60]).all()))
        return tables, cc

    plains = []
    real_plain = k3.block_step_plain

    def spy_plain(*a, **kw):
        plains.append(1)
        return real_plain(*a, **kw)

    ts._windows = windows
    monkeypatch.setattr(k3, "block_step_plain", spy_plain)
    got = ts.run_reduced()
    assert plains == [1]
    assert counts.pop("fixed") == start.endswith(":00"), counts
    assert all(counts.values()), counts
    np.testing.assert_array_equal(np.asarray(got["n_seconds"]),
                                  want["n_seconds"])
    assert int(want["n_seconds"][0]) == 3570
    assert float(want["pv_max"].max()) > 1.0
    for k in REDUCE_STATS:
        np.testing.assert_allclose(np.asarray(got[k]), want[k], rtol=2e-5,
                                   atol=1e-2, err_msg=k)
