"""Port packet-loss concealment (mousiki_tpu_torch.ops.plc) vs the JAX
reference (mousiki_tpu.ops.plc_jax) from a real mid-stream decode
history (the golden stereo streams, 5 frames into the decode).

Bars: the pitch equal; the re-entry spectrum within 1e-3 * max|freq|
(an LPC synthesis over 1080 samples, in which f32 round-off grows). The
LPC is held to an independent float64 fit (`_lpc_fit_f64`, a numpy
Levinson that follows plc_jax._lpc_fit step for step). On a
well-conditioned history (a seeded AR(2) process) the port is within
1e-4 of both the float64 fit and the reference. The 24-order fit of the
real decode history is ill-conditioned: there the reference's own
float32 LPC is 7.9e-3 from the float64 fit, and the port is held to be
no further from it than the reference is.
"""

import contextlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_streams import frame_batch, load_stereo_celt
from mousiki_tpu.celt.modes import opus_custom_mode
from mousiki_tpu.ops import plc_jax, synthesis_jax
from mousiki_tpu_torch import convert
from mousiki_tpu_torch.ops import plc
from mousiki_tpu_torch.pipeline import (SERVING_PROFILE, CeltStreamPipeline,
                                        set_plan_profile)
from torch_threads import one_torch_thread  # noqa: F401

S, C, N = 3, 2, 960
LPC_TOL = 1e-4


@contextlib.contextmanager
def _profile(profile):
    set_plan_profile(*profile)
    try:
        yield
    finally:
        set_plan_profile()


@pytest.fixture(scope="module")
def history():
    streams = load_stereo_celt()
    with _profile(SERVING_PROFILE):
        pipe = CeltStreamPipeline(S, channels=C, use_plan=True,
                                  device="cpu")
        for f in range(5):
            pipe.step(frame_batch(streams, S, f))
    return pipe.state


def _lpc_fit_f64(consts, hist):
    """plc_jax._lpc_fit in float64 numpy: windowed autocorrelation with
    the noise floor and lag window, Levinson with the +-0.98 clamp, then
    the 0.99 bandwidth expansion."""
    order = plc.ORDER
    xw = np.asarray(hist, np.float64) * np.asarray(consts["han"], np.float64)
    n = xw.shape[-1]
    ac = np.stack([np.sum(xw[..., :n - i] * xw[..., i:], -1)
                   for i in range(order + 1)], -1)
    ac[..., 0] = ac[..., 0] * 1.0001 + 1e-9 * n
    ac[..., 1:] *= np.asarray(consts["lagw"], np.float64)
    a = np.zeros(ac.shape[:-1] + (order,))
    err = ac[..., 0].copy()
    for i in range(order):
        # acc = ac[i+1] - sum_{j<i} a[j] * ac[i-j]
        acc = ac[..., i + 1] - np.sum(a[..., :i] * ac[..., i:0:-1], -1)
        k = np.clip(acc / np.maximum(err, 1e-12), -0.98, 0.98)
        a[..., :i] = a[..., :i] - k[..., None] * a[..., i - 1::-1][..., :i]
        a[..., i] = k
        err = err * (1 - k * k)
    return a * 0.99 ** np.arange(1, order + 1)


def _ar2_history(seed):
    """A seeded AR(2) process (poles at radius 0.77): a well-conditioned
    autocorrelation, at the decoder's int16-scale amplitude."""
    e = np.random.default_rng(seed).standard_normal((S, C, plc.HIST + 200))
    x = np.zeros_like(e)
    for i in range(2, e.shape[-1]):
        x[..., i] = 1.3 * x[..., i - 1] - 0.6 * x[..., i - 2] + e[..., i]
    return (x[..., 200:] * 300).astype(np.float32)


def _fits(hist):
    """(float64 fit, port, reference) LPC of an (S, C, HIST) history."""
    window = opus_custom_mode(48000, 960).window
    jc = plc_jax.make_plc_consts(N, window)
    got = plc._lpc_fit(plc.make_plc_consts(N, window, "cpu"),
                       torch.from_numpy(hist)).numpy()
    want = np.asarray(jax.jit(plc_jax._lpc_fit)(jc, jnp.asarray(hist)))
    return _lpc_fit_f64(jc, hist), got, want


def test_lpc_fit_no_less_accurate_than_jax(history):
    """The real decode history: an ill-conditioned fit."""
    exact, got, want = _fits(
        history.decode_mem[:, :, plc.DBS - plc.HIST:plc.DBS].numpy())
    assert np.abs(exact).max() > 0.5         # a fit with real resonances
    assert np.abs(got - exact).max() <= np.abs(want - exact).max()


def test_lpc_fit_matches_jax_when_well_conditioned():
    exact, got, want = _fits(_ar2_history(21))
    assert np.abs(exact).max() > 0.5
    assert np.abs(want - exact).max() <= LPC_TOL
    assert np.abs(got - exact).max() <= LPC_TOL
    assert np.abs(got - want).max() <= LPC_TOL


def test_celt_plc_freq_matches_jax(history):
    state = history
    state_np = convert.stream_state_to_numpy(state)
    hist = state_np.decode_mem[:, :, plc.DBS - plc.HIST:plc.DBS]
    jstate = synthesis_jax.StreamState(*(jnp.asarray(v) for v in state_np))
    window = opus_custom_mode(48000, 960).window
    jc = plc_jax.make_plc_consts(N, window)
    tc = plc.make_plc_consts(N, window, "cpu")
    exact = _lpc_fit_f64(jc, hist)
    lost = np.array([True, False, True])
    jplc = plc_jax.init_plc_state(S, C)
    jplc_freq = jax.jit(partial(plc_jax.celt_plc_freq, channels=C, frame=N))
    tplc = plc.init_plc_state(S, C, "cpu")
    # first lost frame (pitch search + LPC fit), then a second one that
    # reuses the stored pitch and LPC with the 0.8 fade
    for rnd in range(2):
        jfreq, jplc = jplc_freq(jc, jstate, jplc, jnp.asarray(lost))
        tfreq, tplc = plc.celt_plc_freq(tc, state, tplc,
                                        torch.as_tensor(lost), channels=C,
                                        frame=N)
        got = convert.plc_state_to_numpy(tplc)
        np.testing.assert_array_equal(got.plc_pitch,
                                      np.asarray(jplc.plc_pitch))
        np.testing.assert_array_equal(got.loss_count,
                                      np.asarray(jplc.loss_count))
        # lost streams: no further from the float64 fit than the reference
        # (round 1 reuses the LPC carried over from the reference)
        want_lpc = np.asarray(jplc.lpc)
        assert np.abs(got.lpc - exact)[lost].max() \
            <= np.abs(want_lpc - exact)[lost].max(), rnd
        np.testing.assert_array_equal(got.lpc[~lost], want_lpc[~lost])
        want = np.asarray(jfreq)
        assert np.abs(want[lost]).max() > 1.0
        assert np.abs(tfreq.numpy() - want).max() \
            <= 1e-3 * np.abs(want).max(), rnd
        # carry the reference's PLC state, as a pipeline handover would
        tplc = convert.plc_state_from_numpy(
            plc_jax.PlcState(*(np.asarray(v) for v in jplc)), "cpu")
