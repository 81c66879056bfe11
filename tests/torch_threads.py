"""Helpers of the port's CPU tests: a fixture that gives PyTorch one
intra-op thread, a counter of dispatched tensor ops, and seeded weights
for the JAX package's neural models.

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


def seeded_jax_model(make, seed: int, scale):
    """A model of the JAX package (mousiki_tpu.models: fargan.random_model,
    deep_plc.random_pitchdnn, dred.random_enc / random_dec) with the shapes
    `make` gives, its matrices N(0, 1) * scale(shape) drawn from numpy's
    default_rng(seed) and its vectors zero. jax.random's own draws take
    seconds per model on the CPU (a compile per shape); the port's tests
    carry these arrays across to the port instead."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    shapes = jax.eval_shape(make, jax.random.PRNGKey(0))
    leaves, tree = jax.tree_util.tree_flatten(shapes)
    rng = np.random.default_rng(seed)
    vals = [jnp.asarray((rng.standard_normal(leaf.shape) * scale(leaf.shape))
                        .astype(np.float32)) if len(leaf.shape) == 2
            else jnp.zeros(leaf.shape, jnp.float32) for leaf in leaves]
    return jax.tree_util.tree_unflatten(tree, vals)
