"""One torch thread per test process for the port's CPU tests.

The tests run under pytest-xdist: several worker processes share the
CPU's cores.  torch's own intra-op thread pool (one thread per core in
each worker) then oversubscribes them, and its waiting threads spin, so
the port's test files ran several times slower than with one thread each.
Each port test module imports :func:`one_torch_thread`, an autouse module
fixture that sets one thread and restores the previous count afterwards.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
