"""One torch intra-op thread for the port's CPU tests: the module-scoped
autouse fixture that every tests/test_torch_*.py file imports.

The suite runs in several worker processes at once (pytest-xdist), and
torch's default of one intra-op thread per core in each of them puts
several times as many busy threads as cores on the machine; the port's
plain versions then wait on each other's threads (the port's files took
565 s with 6 workers against 138 s with one thread each, on one 8-core
host).  The previous count is restored after each file, so nothing else
that shares the worker sees the change.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_tests_run_on_one_torch_thread():
    assert torch.get_num_threads() == 1
