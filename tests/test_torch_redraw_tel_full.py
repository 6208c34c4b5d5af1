"""tests/test_torch_redraw_tel.py's edge blocks with the telemetry
observer at level full (the csi histogram and the cloud occupancy
besides light's counters and moments), against the JAX scan on the CPU,
with that file's tolerances and helper; a file of its own so that a run
of the suite that splits its workers by file takes the two levels' JAX
runs apart.
"""

import pytest

from test_torch_redraw_tel import STARTS, check_telemetry_block
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("telemetry", ["full"])
@pytest.mark.parametrize(**STARTS)
def test_telemetry_block_matches_jax_scan(monkeypatch, start, telemetry):
    check_telemetry_block(monkeypatch, start, telemetry)
