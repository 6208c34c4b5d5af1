"""The redraw-heavy edge blocks of tests/test_torch_redraw.py with the
telemetry observer, on the CPU: the same blocks from 18:50:00 and
18:50:30, and one block from 00:00 (no second with clear-sky GHI), at
level light and full (the lean step's telemetry instantiations on the
card): the JAX ``_block_step_scan_acc_tel`` against the port's
``block_step_obs_plain``, from the same windows with their wind-speed
table scaled alike; the statistics at the engine tolerance (``n_seconds``
exact, the rest rtol 2e-5, atol 1e-2, tests/test_engine.py), the
telemetry delta's counts (NaN and non-finite counts, ``count``, the csi
histogram and the occupancy) exact, its extrema, sums and sums of
squares at the engine tolerance.
"""

import jax
import numpy as np
import pytest

from test_torch_redraw import CFG, WS
from tmhpvsim_torch.config import SimConfig
from tmhpvsim_torch.engine.simulation import REDUCE_STATS, Simulation
from tmhpvsim_torch.kernels import block_step as k3
from tmhpvsim_tpu import config as jcfg
from tmhpvsim_tpu.engine import Simulation as JSim
from tmhpvsim_tpu.models import clearsky_index as jci


#: the blocks' starts and their ids
STARTS = dict(argnames="start",
              argvalues=["2019-09-05 18:50:00", "2019-09-05 18:50:30",
                         "2019-09-05 00:00:00"],
              ids=["on-minute", "off-minute", "midnight"])


@pytest.mark.parametrize("telemetry", ["light"])
@pytest.mark.parametrize(**STARTS)
def test_telemetry_block_matches_jax_scan(monkeypatch, start, telemetry):
    check_telemetry_block(monkeypatch, start, telemetry)


def check_telemetry_block(monkeypatch, start, telemetry):
    """The JAX scan's block with telemetry at level ``telemetry`` from
    ``start`` against the port's plain producer and fold (level full:
    tests/test_torch_redraw_tel_full.py, a file of its own so that a run
    of the suite that splits its workers by file takes the two levels'
    JAX runs apart)."""
    real_tables = jci.value_major_tables

    def jax_tables(arrays, minute_vals):
        out = real_tables(arrays, minute_vals)
        return dict(out, ws=out["ws"] * WS)

    monkeypatch.setattr(jci, "value_major_tables", jax_tables)
    steps = []
    real_step = JSim._block_step_scan_acc_tel

    def spy_step(self, *a):
        steps.append(1)
        return real_step(self, *a)

    monkeypatch.setattr(JSim, "_block_step_scan_acc_tel", spy_step)
    with jax.enable_x64(False):
        js = JSim(jcfg.SimConfig(block_impl="scan", dtype="float32",
                                 scan_unroll=1, start=start,
                                 telemetry=telemetry, **CFG))
        want = {k: np.asarray(v) for k, v in js.run_reduced().items()}
        want_tel = {k: np.asarray(v) for k, v in js._tel_last.items()}
    assert steps

    ts = Simulation(SimConfig(start=start, telemetry=telemetry, **CFG),
                    device="cpu")
    real_windows = ts._windows

    def windows(state, inputs):
        tables, cc = real_windows(state, inputs)
        return dict(tables, ws=tables["ws"] * WS), cc

    plains = []
    real_plain = k3.block_step_obs_plain

    def spy_plain(*a, **kw):
        plains.append(1)
        return real_plain(*a, **kw)

    ts._windows = windows
    monkeypatch.setattr(k3, "block_step_obs_plain", spy_plain)
    got = ts.run_reduced()
    got_tel = {k: v.numpy() for k, v in ts._tel_last.items()}
    assert plains == [1]
    np.testing.assert_array_equal(np.asarray(got["n_seconds"]),
                                  want["n_seconds"])
    assert int(want["n_seconds"][0]) == 3570
    ghi = ts.host_inputs(0).rows_f[k3.ROWS_F.index("ghi_clear")]
    if start.endswith("00:00:00"):
        assert float(ghi.abs().max()) == 0.0
    else:
        assert float(want["pv_max"].max()) > 1.0
    for k in REDUCE_STATS:
        np.testing.assert_allclose(np.asarray(got[k]), want[k], rtol=2e-5,
                                   atol=1e-2, err_msg=k)
    assert set(got_tel) == set(want_tel)
    assert ("csi_hist" in want_tel) == (telemetry == "full")
    for k, w in want_tel.items():
        g = got_tel[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k.startswith(("min_", "max_", "sum_", "sumsq_")):
            np.testing.assert_allclose(g, w, rtol=2e-5, atol=1e-2,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)

