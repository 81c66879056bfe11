"""mousiki_tpu_torch.ops.encode_front: the Toeplitz forms of the three
recurrences against the JAX package's scans, no per-sample loop in a
step, and the shape checks (split from tests/test_torch_encode_front.py
so that the tier-1 suite's files stay short).
"""

import numpy as np
import pytest
import torch

from test_torch_encode_front import (S, _batch, front, jax, jnp,  # noqa: F401
                                     ref)
from torch_threads import CountOps, one_torch_thread  # noqa: F401


def test_toeplitz_recurrences_match_jax_scans():
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((3, 2, 540)) ** 2 * 1e6).astype(np.float32)
    for coef, reverse in ((0.9375, False), (0.875, True)):
        want = np.asarray(ref._linrec(jnp.asarray(x), coef, reverse=reverse))
        T = torch.from_numpy(front.linrec_matrix(540, coef, reverse)
                             .astype(np.float32))
        got = (torch.from_numpy(x) @ T.T).numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # the combined smoother of the constants
    consts = front.make_front_consts(960, "cpu")
    fwd = 0.0625 * ref._linrec(jnp.asarray(x), 0.9375)
    want = np.asarray(0.125 * ref._linrec(fwd, 0.875, reverse=True))
    got = (torch.from_numpy(x) @ consts["smoothT"]).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    # the high-pass: the reference's two-state scan
    xin = (rng.standard_normal((1080, 3, 2)) * 8000).astype(np.float32)

    def hp_scan(carry, xi):
        mem0, mem1 = carry
        return (mem0 - xi + 0.5 * mem1, xi - mem0), mem0 + xi

    _, want = jax.lax.scan(hp_scan, (jnp.zeros((3, 2)), jnp.zeros((3, 2))),
                           jnp.asarray(xin))
    want = np.moveaxis(np.asarray(want), 0, -1)
    got = (torch.from_numpy(np.moveaxis(xin, 0, -1).copy())
           @ consts["hpT"]).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # the impulse response has died within 64 taps
    h = front.hp_matrix(1080)[:, 0]
    assert np.abs(h[64:]).max() < 1e-9


def test_front_step_has_no_per_sample_loop():
    """The front is a fixed number of batched ops a step, far fewer than
    the 1080 samples its recurrences run over, whatever S is."""
    consts = front.make_front_consts(960, "cpu")
    counts = []
    for n in (1, 3):
        st = front.init_front_state(n, 2, 960, "cpu")
        pcm = torch.from_numpy(_batch(2, "music", 1)[0][:1].repeat(n, 0))
        z = torch.zeros((n,), dtype=torch.int32)
        with CountOps() as ops:
            front.front_step(consts, st, pcm, z + 320, z)
        counts.append(ops.n)
    print(f"non-view ops a front step: {counts[1]}")
    # the count does not grow with S (a copy more or less at S = 1)
    assert abs(counts[0] - counts[1]) <= 4 and max(counts) < 1080, counts


def test_front_step_checks_shapes():
    consts = front.make_front_consts(960, "cpu")
    st = front.init_front_state(S, 2, 960, "cpu")
    z = torch.zeros((S,), dtype=torch.int32)
    with pytest.raises(ValueError):
        front.front_step(consts, st, torch.zeros(S, 480, 2), z, z)
    with pytest.raises(ValueError):
        front.front_step(consts, st, torch.zeros(S, 960, 1), z, z)
    # an all-zero frame is silence, with no prefilter and finite outputs
    out, _ = front.front_step(consts, st, torch.zeros(S, 960, 2),
                              z + 320, z)
    assert bool(out["silence"].all()) and not bool(out["pf_on"].any())
    assert all(bool(torch.isfinite(v).all()) for v in out.values()
               if v.is_floating_point())
