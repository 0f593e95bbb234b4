"""One intra-op thread for the port's CPU tests.

The suite runs in several pytest-xdist worker processes at once.  Left to
its default, each torch process runs its ops on one OpenMP thread per core,
and the workers' threads then stall at each other's barriers: six workers
running the same three port tests took 477 s where one thread each took
9.8 s (an 8-core machine).  The port's test tensors are small, so one
thread costs little when a file runs alone.

Each tests/test_torch_*.py imports the fixture, which makes it autouse for
that module; this module's own test checks that it holds.
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
