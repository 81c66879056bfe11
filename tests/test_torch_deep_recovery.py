"""mousiki_tpu_torch.parallel.deep_recovery.BatchedDeepRecovery against the
JAX package's class, with the JAX models' weights carried across: the
batched RDOVAE decode on DRED payloads of the JAX OpusEncoder, the batched
concealment (integer periods equal on every frame), a hand-over of the
FARGAN and PitchDNN state mid-stream, and the slice as a whole (JAX
packets, the port's parse, process and conceal, against the JAX recovery
on the same packets)."""

import numpy as np
import pytest
import torch

from mousiki_tpu import dred as jax_dred_api
from mousiki_tpu.models import deep_plc as jax_plc
from mousiki_tpu.models import dred as jax_dred
from mousiki_tpu.models import fargan as jax_fargan
from mousiki_tpu.opus_encoder import OpusEncoder
from mousiki_tpu.parallel.deep_recovery import \
    BatchedDeepRecovery as JaxRecovery
from mousiki_tpu_torch import convert
from mousiki_tpu_torch import dred as dred_api
from mousiki_tpu_torch.parallel.deep_recovery import BatchedDeepRecovery
from torch_threads import one_torch_thread  # noqa: F401
from torch_threads import seeded_jax_model

TOL = 1e-4          # tests/test_deep_recovery.py:65,92
S, N_FRAMES = 3, 5


@pytest.fixture(scope="module")
def models():
    """JAX models (seeded) and the port's copies of them."""
    def rd(shape):
        return 0.3 / np.sqrt(shape[1])

    jax_models = dict(
        fargan_model=seeded_jax_model(jax_fargan.random_model, 2,
                                      lambda s: 0.08),
        dec_model=seeded_jax_model(jax_dred.random_dec, 1, rd),
        pitch_model=seeded_jax_model(jax_plc.random_pitchdnn, 3,
                                     lambda s: 1.0 / np.sqrt(s[1])))
    port = dict(
        fargan_model=convert.fargan_from_numpy(jax_models["fargan_model"],
                                               "cpu"),
        dec_model=convert.rdovae_dec_from_numpy(jax_models["dec_model"],
                                                "cpu"),
        pitch_model=convert.pitchdnn_from_numpy(jax_models["pitch_model"],
                                                "cpu"))
    enc = seeded_jax_model(jax_dred.random_enc, 0, rd)
    return jax_models, port, enc


def _speechish(n, fs=48000, seed=7):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    f0 = 120 + 30 * np.sin(2 * np.pi * 2.3 * t)
    sig = 0.3 * np.sin(2 * np.pi * np.cumsum(f0) / fs)
    sig *= 0.6 + 0.4 * np.sin(2 * np.pi * 4.0 * t) ** 2
    sig += 0.01 * rng.standard_normal(n)
    return sig.astype(np.float32)[:, None]


@pytest.fixture(scope="module")
def packets(models):
    """10 CELT frames of 3 mono streams from the JAX package's OpusEncoder
    with DRED (40 x 10 ms; tests/test_deep_recovery.py _dred_packets)."""
    out = []
    for s in range(S):
        enc = OpusEncoder(48000, 1)
        enc.set_bitrate(24000)
        enc.set_dred_duration(40, model=models[2])
        sig = _speechish(960 * 10, seed=10 + s)
        out.append([enc.encode(sig[f * 960:(f + 1) * 960], 960)
                    for f in range(10)])
    return out


def _last_dred(parse, pkts):
    for p in reversed(pkts):
        d = parse(p)
        if d is not None:
            return d
    raise AssertionError("no DRED extension found")


def test_process_matches_jax(models, packets):
    """Four lanes: the newest DRED of streams 0 and 2, an early one of
    stream 1 (fewer latents: its lane goes inactive first) and no DRED."""
    jm, pm, _ = models
    picks = [packets[0], packets[1][:4], packets[2]]
    got_d = [_last_dred(dred_api.opus_dred_parse, p) for p in picks] + [None]
    want_d = [_last_dred(jax_dred_api.opus_dred_parse, p)
              for p in picks] + [None]
    assert got_d[1].nb_latents < got_d[0].nb_latents
    want, want_n = JaxRecovery(4, **jm).process(want_d)
    got, got_n = BatchedDeepRecovery(4, **pm, device="cpu").process(got_d)
    np.testing.assert_array_equal(got_n, want_n)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= TOL
    # each lane against the per-stream decoder of the port
    for s in range(3):
        one = np.stack(dred_api.opus_dred_process(
            got_d[s], model=pm["dec_model"]))
        assert np.abs(got[s, got.shape[1] - got_n[s]:] - one).max() <= TOL
    assert not got[3].any()


def _jax_periods(pitch, feats, state=None):
    """(S, F) float periods of the JAX PitchDNN, stream by stream, and the
    final states."""
    n, F = feats.shape[:2]
    out = np.zeros((n, F), np.float32)
    states = []
    for s in range(n):
        st = np.zeros(64, np.float32) if state is None else state[s]
        for f in range(F):
            p, st = jax_plc.compute_pitchdnn(pitch, st, feats[s, f])
            out[s, f] = float(p)
        states.append(np.asarray(st))
    return out, np.stack(states)


def test_conceal_matches_jax(models):
    """S = 3, 5 frames in one call, then 5 more with one lane inactive;
    integer periods equal on every frame, PCM within 1e-4."""
    jm, pm, _ = models
    rng = np.random.default_rng(0)
    want_rec = JaxRecovery(S, **jm)
    got_rec = BatchedDeepRecovery(S, **pm, device="cpu")
    pstate = None
    for call, active in enumerate((None, np.array([1, 0, 1], bool))):
        feats = (rng.standard_normal((S, N_FRAMES, 20)) * 0.3).astype(
            np.float32)
        want = np.asarray(want_rec.conceal(feats, active))
        got = got_rec.conceal(feats, active)
        assert got.shape == (S, N_FRAMES * 160) and got.dtype == torch.float32
        periods, pstate = _jax_periods(jm["pitch_model"], feats, pstate)
        np.testing.assert_array_equal(
            got_rec.last_periods.numpy().astype(np.int32),
            periods.astype(np.int32), err_msg=f"call {call}")
        assert np.abs(got.numpy() - want).max() <= TOL, call
    assert not got[1].any()
    assert float(np.abs(want).max()) > 1e-2


def test_state_hand_over_matches_jax(models):
    """Three conceal calls in JAX, the FARGAN and PitchDNN states carried
    across, two calls in the port: within 1e-4 of five JAX calls."""
    jm, pm, _ = models
    rng = np.random.default_rng(1)
    feats = (rng.standard_normal((5, S, N_FRAMES, 20)) * 0.3).astype(
        np.float32)
    want_rec = JaxRecovery(S, **jm)
    want = []
    for k in range(5):
        if k == 3:
            carried = (want_rec.fargan_state, want_rec.pitch_state)
        want.append(np.asarray(want_rec.conceal(feats[k])))
    got_rec = BatchedDeepRecovery(S, **pm, device="cpu")
    got_rec.fargan_state = convert.fargan_state_from_numpy(carried[0], "cpu")
    got_rec.pitch_state = torch.from_numpy(np.array(carried[1]))
    for k in (3, 4):
        got = got_rec.conceal(feats[k])
        assert np.abs(got.numpy() - want[k]).max() <= TOL, k
    back = convert.fargan_state_to_numpy(got_rec.fargan_state)
    for g, w in zip(back, want_rec.fargan_state):
        w = np.asarray(w)
        assert g.shape == w.shape
        if w.size:                  # fwc0_mem has no history
            assert np.abs(g - w).max() <= TOL * max(1.0, np.abs(w).max())


def test_recovery_slice_matches_jax(models, packets):
    """The slice end to end: packets of the JAX encoder, parsed by the
    port, decoded to features and concealed by the port, against the JAX
    recovery on the same packets (the last 5 recovered frames of each
    stream concealed)."""
    jm, pm, _ = models
    got_rec = BatchedDeepRecovery(S, **pm, device="cpu")
    want_rec = JaxRecovery(S, **jm)
    feats, n10 = got_rec.process([_last_dred(dred_api.opus_dred_parse, p)
                                  for p in packets])
    want_feats, want_n10 = want_rec.process(
        [_last_dred(jax_dred_api.opus_dred_parse, p) for p in packets])
    np.testing.assert_array_equal(n10, want_n10)
    assert np.abs(feats - want_feats).max() <= TOL
    assert n10.min() >= N_FRAMES
    got = got_rec.conceal(feats[:, -N_FRAMES:])
    want = np.asarray(want_rec.conceal(want_feats[:, -N_FRAMES:]))
    assert np.isfinite(got.numpy()).all()
    assert np.abs(got.numpy() - want).max() <= TOL


@pytest.mark.cuda
def test_recovery_stays_on_the_card():
    """BatchedDeepRecovery(device="cuda"): models, states and the PCM on
    the card; process reads the features back once (numpy)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this path runs on the GPU")
    rec = BatchedDeepRecovery(4, device="cuda")
    for model in (rec.fargan_model, rec.dec_model, rec.pitch_model):
        assert all(p.is_cuda for p in model.parameters())
    assert all(t.is_cuda for t in rec.fargan_state)
    pcm = rec.conceal(np.zeros((4, 2, 20), np.float32))
    assert pcm.is_cuda and rec.pitch_state.is_cuda
    assert rec.last_periods.is_cuda
    payload = dred_api.dred_encode(
        [np.ones(24, np.float32)] * 4, np.ones(24, np.float32),
        rec.stats, offset=0)
    d = dred_api.OpusDred(dred_api.dred_parse(payload, rec.stats), payload)
    feats, n10 = rec.process([d, None, d, None])
    assert isinstance(feats, np.ndarray) and n10[0] == 4 * d.nb_latents
