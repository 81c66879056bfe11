"""mousiki_tpu_torch.models.fargan and models.deep_plc against the JAX
package: FARGAN at full width (cond 256, GRU 128) over several frames with
the state threaded, the integer pitch periods of PitchDNN, and one
stream's DeepPlcState, all on the JAX models' weights carried across."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mousiki_tpu.models import deep_plc as jax_plc
from mousiki_tpu.models import fargan as jax_fargan
from mousiki_tpu_torch import convert
from mousiki_tpu_torch.models import deep_plc, fargan
from torch_threads import CountOps, one_torch_thread  # noqa: F401
from torch_threads import seeded_jax_model

PCM_TOL = 1e-4     # tests/test_deep_recovery.py:92 (FARGAN peaks near 0.8)
STATE_TOL = 1e-4   # times the field's scale


@pytest.fixture(scope="module")
def models():
    jf = seeded_jax_model(jax_fargan.random_model, 2, lambda s: 0.08)
    # five times the reference's scale, so that the periods spread
    jp = seeded_jax_model(jax_plc.random_pitchdnn, 3,
                          lambda s: 1.0 / np.sqrt(s[1]))
    return (jf, jp, convert.fargan_from_numpy(jf, "cpu"),
            convert.pitchdnn_from_numpy(jp, "cpu"))


def _state_close(got, want):
    for name, g, w in zip(fargan.FarganState._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        if not w.size:          # fwc0_mem: no history
            continue
        scale = max(1.0, float(np.abs(w).max()))
        assert np.abs(g - w).max() <= STATE_TOL * scale, name


def test_synthesize_frame_matches_jax(models):
    """S = 3 streams, 4 frames with the state threaded; the periods cover
    the wrapped pitch gather (period < 42), the embedding's clip at both
    ends and an ordinary lag."""
    jf, tf = models[0], models[2]
    S, F = 3, 4
    rng = np.random.default_rng(0)
    periods = np.array([[32, 100, 255], [40, 20, 300], [41, 180, 64],
                        [90, 33, 256]], np.int32)
    sj = jax_fargan.init_state(jf, S)
    st = fargan.init_state(tf, S)
    _state_close(st, sj)
    for f in range(F):
        feats = (rng.standard_normal((S, 20)) * 0.5).astype(np.float32)
        yj, sj = jax_fargan.synthesize_frame(jf, sj, jnp.asarray(feats),
                                             jnp.asarray(periods[f]))
        yt, st = fargan.synthesize_frame(tf, st, torch.from_numpy(feats),
                                         torch.from_numpy(periods[f]))
        yj = np.asarray(yj)
        assert yt.shape == (S, fargan.FARGAN_FRAME_SIZE)
        assert np.abs(yt.numpy() - yj).max() <= PCM_TOL, f
        assert np.abs(yj).max() > 1e-3       # the frame is not silent
        _state_close(st, sj)


def test_synthesize_frame_has_no_sample_loop(models):
    """The de-emphasis is one product, not a 40-step loop: a frame costs a
    few hundred tensor ops (a loop would add 160)."""
    tf = models[2]
    st = fargan.init_state(tf, 2)
    with CountOps() as ops:
        fargan.synthesize_frame(tf, st, torch.zeros(2, 20),
                                torch.tensor([80, 120], dtype=torch.int32))
    assert ops.n <= 400, ops.n


def _jax_periods(jp, feats):
    """(S, F) float periods of the JAX PitchDNN, one stream at a time."""
    S, F = feats.shape[:2]
    out = np.zeros((S, F), np.float32)
    for s in range(S):
        state = np.zeros(64, np.float32)
        for f in range(F):
            p, state = jax_plc.compute_pitchdnn(jp, state, feats[s, f])
            out[s, f] = float(p)
    return out


def test_compute_pitchdnn_matches_jax(models):
    """The integer periods (what FARGAN is driven by) equal on every frame
    of every stream; the floats within 1e-3."""
    jp, tp = models[1], models[3]
    rng = np.random.default_rng(4)
    S, F = 5, 8
    feats = (rng.standard_normal((S, F, 20)) * 1.5).astype(np.float32)
    want = _jax_periods(jp, feats)
    state = torch.zeros((S, 64))
    got = np.zeros((S, F), np.float32)
    for f in range(F):
        p, state = deep_plc.compute_pitchdnn(tp, state,
                                             torch.from_numpy(feats[:, f]))
        got[:, f] = p.numpy()
    np.testing.assert_array_equal(got.astype(np.int32), want.astype(np.int32))
    assert np.abs(got - want).max() <= 1e-3
    assert len(set(want.astype(np.int32).ravel())) > S  # periods vary


def test_deep_plc_state_matches_jax(models):
    """One stream: features tracked over a tone, two concealments from
    the last features, then one from an injected DRED vector."""
    jf, jp, tf, tp = models
    t = np.arange(3200) / 16000.0
    sig = 0.5 * np.sin(2 * np.pi * 200 * t)
    want = jax_plc.DeepPlcState(fargan_model=jf, pitch_model=jp)
    got = deep_plc.DeepPlcState(fargan_model=tf, pitch_model=tp,
                                device="cpu")
    for plc in (want, got):
        plc.update(sig)
    np.testing.assert_array_equal(got.last_features, want.last_features)
    for n in (320, 160):
        a, b = got.conceal(n), want.conceal(n)
        assert a.shape == (n,) and np.abs(a - b).max() <= PCM_TOL
    fec = [np.linspace(-1, 1, 20), np.full(20, 0.3)]
    for plc in (want, got):
        plc.inject_fec_features(fec)
    a, b = got.conceal(160), want.conceal(160)
    assert np.abs(a - b).max() <= PCM_TOL
    assert got.loss_count == want.loss_count == 3
    empty = deep_plc.DeepPlcState(pitch_model=tp, device="cpu")
    assert np.array_equal(empty.conceal(160), np.zeros(160))
