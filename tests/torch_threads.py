"""A fixture for the port's CPU tests: one intra-op thread for PyTorch.

The port's eager steps are tens of thousands of tiny ops. With several
test workers on one machine, PyTorch's intra-op thread pools (one thread a
core in every worker) only fight over the cores at each op's barrier: the
same tests take several times longer. A test module switches it on with

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
