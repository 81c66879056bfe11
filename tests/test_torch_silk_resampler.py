"""The port's SILK 8/12/16 kHz -> 48 kHz up-resampler
(mousiki_tpu_torch.ops.silk_resampler) against the JAX package's
(mousiki_tpu.ops.silk_resampler_jax) on the same inputs at S = 3.

Inputs are seeded noise at int16 scale (|x| up to ~3e4), two consecutive
frames so that the carried state (IIR, FIR tail, delay) is used. Bars: the
probed operator equal bit for bit; output and every state field within
1e-5 * max|output| of the JAX step (both sum the same 334 products a
sample in fp32, in different orders).
"""

import numpy as np
import pytest
import torch

from mousiki_tpu.ops import silk_resampler_jax
from mousiki_tpu_torch.ops import silk_resampler
from torch_threads import one_torch_thread  # noqa: F401

S = 3


@pytest.mark.parametrize("khz", [8, 12, 16])
def test_up48_step_matches_jax(khz):
    L = 20 * khz
    want_plan = silk_resampler_jax.make_up48_plan(L, khz)
    plan = silk_resampler.make_up48_plan(L, khz, "cpu")
    assert (plan.n_out, plan.in_khz, plan.delay) == (960, khz,
                                                     want_plan.delay)
    np.testing.assert_array_equal(plan.wmat.numpy(),
                                  np.asarray(want_plan.wmat))
    rng = np.random.default_rng(khz)
    want_state = silk_resampler_jax.init_up48_state(S)
    state = silk_resampler.init_up48_state(S, "cpu")
    for f in range(2):
        x = (rng.standard_normal((S, L)) * 8000).clip(-32768, 32767)
        x = x.astype(np.float32)
        want, want_state = silk_resampler_jax.up48_step(x, want_state,
                                                        want_plan)
        got, state = silk_resampler.up48_step(torch.from_numpy(x), state,
                                              plan)
        want = np.asarray(want)
        assert got.shape == (S, 960) and got.dtype == torch.float32
        tol = 1e-5 * np.abs(want).max()
        assert np.abs(got.numpy() - want).max() <= tol, (f, tol)
        for field, a, b in zip(state._fields, state, want_state):
            assert np.abs(a.numpy() - np.asarray(b)).max() <= tol, (f, field)


def test_up48_step_does_not_write_its_input_state():
    plan = silk_resampler.make_up48_plan(320, 16, "cpu")
    state = silk_resampler.init_up48_state(S, "cpu")
    x = torch.ones((S, 320))
    _, new = silk_resampler.up48_step(x, state, plan)
    assert float(state.delay.abs().max()) == 0.0
    assert float(new.delay[:, :7].min()) == 1.0
    assert float(new.delay[:, 7:].abs().max()) == 0.0
