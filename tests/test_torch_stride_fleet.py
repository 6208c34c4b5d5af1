"""The precision levers end to end on the 12-site synthetic fleet: the
port against the JAX package on the CPU, as tests/test_torch_stride.py
holds the shared site and the site grid (its tolerances, its helpers and
its cached JAX runs, each made once per process).  The fleet's runs are
the heaviest of those cases, so they live in a file of their own: a run
of the suite that splits its workers by file takes them apart from the
rest.
"""

import pytest

from test_torch_stride import OUTPUTS, check_levers, jax_runs  # noqa: F401


@pytest.mark.parametrize("output", OUTPUTS)
@pytest.mark.parametrize("geo", ("fleet",))
def test_levers_match_jax(jax_runs, geo, output):  # noqa: F811
    check_levers(jax_runs, geo, output)
