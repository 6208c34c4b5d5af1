"""The precision levers on the 12-site synthetic fleet, its per-second
outputs (ensemble and trace): tests/test_torch_stride_fleet.py's check,
its reduce run in that file, these here, so that a run of the suite that
splits its workers by file takes them apart (each output's JAX run is
made once per process, by tests/test_torch_stride.py's cache).
"""

import pytest

from test_torch_stride import check_levers, jax_runs  # noqa: F401
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("output", ("ensemble", "trace"))
@pytest.mark.parametrize("geo", ("fleet",))
def test_levers_match_jax(jax_runs, geo, output):  # noqa: F811
    check_levers(jax_runs, geo, output)
