"""Helpers of the port's CPU tests: a fixture that gives PyTorch one
intra-op thread, and a counter of dispatched tensor ops.

The port's eager steps are tens of thousands of tiny ops. With several
test workers on one machine, PyTorch's intra-op thread pools (one thread a
core in every worker) only fight over the cores at each op's barrier: the
same tests take several times longer. A test module switches it on with

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


_VIEW_OPS = ("view", "slice", "select", "expand", "unsqueeze", "squeeze",
             "transpose", "permute", "t.default", "reshape", "alias",
             "as_strided", "unbind", "unfold", "detach", "split", "narrow",
             "lift_fresh")


class CountOps(TorchDispatchMode):
    """Counts the tensor ops dispatched inside the `with` block, views
    left out: an upper bound on the kernels the same code launches on a
    GPU, and a guard against a loop that crept in."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not any(v in str(func) for v in _VIEW_OPS):
            self.n += 1
        return func(*args, **(kwargs or {}))
