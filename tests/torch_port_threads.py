"""One intra-op thread for PyTorch while a port test module runs.

The suite runs under pytest-xdist, six worker processes on a machine of
about as many cores.  PyTorch's CPU kernels default to one thread per core
in every worker, and its OpenMP threads spin while they wait, so six
workers' pools oversubscribe the cores many times over and every test in
flight slows down.  A port test module imports ``one_torch_thread``: while
the module runs, PyTorch takes one thread, and the previous count is put
back after it, so the modules that run next in the same worker see no
change.  The tests compute the same functions; only the split of PyTorch's
CPU work over threads differs.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
