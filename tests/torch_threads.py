"""A fixture for the port's CPU tests: one torch intra-op thread.

The suite runs several pytest workers on the machine's cores. Each worker's
torch starts one OpenMP thread per core, and with several workers running
torch at once those threads oversubscribe the cores: a test of a few seconds
alone then takes minutes. Import the fixture into a test module to use it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
