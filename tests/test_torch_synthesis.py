"""Port synthesis (mousiki_tpu_torch.ops.synthesis) vs the JAX reference
(mousiki_tpu.ops.synthesis_jax) on the same seeded inputs, with the state
carried between frames through mousiki_tpu_torch.convert.

Bars: PCM <= 2e-5 absolute (PCM is in [-1, 1]; f32 round-off of the
+-32768-scale internals is ~1e-7 there), decode_mem <= 1e-5 * max|mem|.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mousiki_tpu.ops import synthesis_jax
from mousiki_tpu.ops.pallas_kernels import deemphasis_pallas
from mousiki_tpu_torch import convert
from mousiki_tpu_torch.ops import synthesis
from mousiki_tpu_torch.ops.deemphasis import (deemphasis_pcm_reference,
                                              deemphasis_reference)
from torch_threads import one_torch_thread  # noqa: F401

PCM_TOL = 2e-5
MEM_TOL = 1e-5


def _desc(rng, S, C, n, f):
    x = rng.standard_normal((S, C, n)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True) / 4.0
    ble = rng.uniform(0.0, 9.0, (S, C, 22)).astype(np.float32)
    ble[..., 21] = -28.0
    return dict(
        x=x, band_log_e=ble,
        # stream 0 long blocks, stream 1 transient, stream 2 alternating
        transient=np.array([False, True, f % 2 == 1]),
        silence=np.array([False, False, f == 2]),
        pf_pitch=rng.integers(15, 700, S).astype(np.int32),
        pf_gain=np.array([0.0, 0.4, 0.25], np.float32) * (f > 0),
        pf_tapset=rng.integers(0, 3, S).astype(np.int32),
    )


@pytest.mark.parametrize("n", [960, 120])
def test_synthesis_step_matches_jax(n):
    S, C = 3, 2
    rng = np.random.default_rng(11 + n)
    jc = synthesis_jax.make_consts(n=n)
    tc = synthesis.make_consts(n, "cpu")
    jstate = synthesis_jax.init_state(S, C)
    tstate = synthesis.init_state(S, C, "cpu")
    for f in range(3):
        d = _desc(rng, S, C, n, f)
        jd = synthesis_jax.FrameDesc(**{k: jnp.asarray(v)
                                        for k, v in d.items()})
        td = synthesis.FrameDesc(**{k: torch.as_tensor(v)
                                    for k, v in d.items()})
        jpcm, jstate = synthesis_jax.synthesis_step(jc, jstate, jd,
                                                    channels=C, n=n)
        tpcm, tstate = synthesis.synthesis_step(tc, tstate, td, n=n)
        want = np.asarray(jpcm)
        assert tpcm.shape == want.shape == (S, n, C)
        assert np.abs(tpcm.numpy() - want).max() < PCM_TOL, f
        got_state = convert.stream_state_to_numpy(tstate)
        want_mem = np.asarray(jstate.decode_mem)
        assert np.abs(got_state.decode_mem - want_mem).max() \
            <= MEM_TOL * np.abs(want_mem).max(), f
        for field in ("pf_period", "pf_tapset", "pf_period_old",
                      "pf_tapset_old"):
            np.testing.assert_array_equal(getattr(got_state, field),
                                          np.asarray(getattr(jstate, field)))
        # carry the reference's state into the port for the next frame, so
        # every frame is compared from the same starting point
        tstate = convert.stream_state_from_numpy(
            synthesis_jax.StreamState(*(np.asarray(v) for v in jstate)),
            "cpu")


def test_deemphasis_reference_matches_jax_and_pallas():
    rng = np.random.default_rng(1)
    S, C, N = 2, 2, 240
    x = (rng.standard_normal((S, C, N)) * 1000).astype(np.float32)
    mem = (rng.standard_normal((S, C)) * 100).astype(np.float32)
    got, got_mem = deemphasis_reference(torch.as_tensor(x),
                                        torch.as_tensor(mem))
    want, want_mem = synthesis_jax.deemphasis(jnp.asarray(x), jnp.asarray(mem))
    pal, pal_mem = deemphasis_pallas(jnp.asarray(x.reshape(S * C, N)),
                                     jnp.asarray(mem.reshape(S * C)),
                                     interpret=True)
    scale = np.abs(np.asarray(want)).max()
    for ref, ref_mem in ((np.asarray(want), np.asarray(want_mem)),
                         (np.asarray(pal).reshape(S, C, N),
                          np.asarray(pal_mem).reshape(S, C))):
        assert np.abs(got.numpy() - ref).max() < 1e-4 * scale
        assert np.abs(got_mem.numpy() - ref_mem).max() < 1e-4 * scale


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("N", [120, 960])
def test_deemphasis_pcm_reference_matches_jax_tail(C, N):
    """The plain version of the fused kernel against what synthesis_jax
    computes from `synth` on: deemphasis, x 1/32768, (S, C, N) ->
    (S, N, C). Bar 1e-4 * max|pcm| (new_mem: 1e-4 * max|y|)."""
    rng = np.random.default_rng(100 + C * N)
    S = 3
    x = (rng.standard_normal((S, C, N)) * 1000).astype(np.float32)
    mem = (rng.standard_normal((S, C)) * 100).astype(np.float32)
    pcm, new_mem = deemphasis_pcm_reference(torch.as_tensor(x),
                                            torch.as_tensor(mem))
    y, m = synthesis_jax.deemphasis(jnp.asarray(x), jnp.asarray(mem))
    want = np.asarray(y * (1.0 / 32768.0)).transpose(0, 2, 1)
    assert pcm.shape == want.shape == (S, N, C) and pcm.is_contiguous()
    assert np.abs(pcm.numpy() - want).max() < 1e-4 * np.abs(want).max()
    assert np.abs(new_mem.numpy() - np.asarray(m)).max() \
        < 1e-4 * np.abs(np.asarray(y)).max()
