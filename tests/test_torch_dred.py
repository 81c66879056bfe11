"""mousiki_tpu_torch.models.dred, mousiki_tpu_torch.dred and the copied
OpusEncoder against the JAX package: the RDOVAE encoder and decoder on the
JAX weights carried across, the latent transport (stats, payloads, parse)
bit for bit, opus_dred_parse / opus_dred_process on packets of the JAX
encoder, and the four branches of the copied encoder that import modules
outside the SILK closure (16 kHz input, a 100 ms frame, APP_AUDIO, DRED),
each packet byte-equal to the JAX package's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mousiki_tpu import dred as jax_dred_api
from mousiki_tpu import opus_encoder as jax_opus_encoder
from mousiki_tpu.models import dred as jax_dred
from mousiki_tpu_torch import convert
from mousiki_tpu_torch import dred as dred_api
from mousiki_tpu_torch.hostcodec import opus_encoder
from mousiki_tpu_torch.models import dred
from torch_threads import one_torch_thread  # noqa: F401
from torch_threads import seeded_jax_model

TOL = 1e-5       # tests/test_weight_blob.py:193,200


def _rdovae_scale(shape):
    return 0.3 / np.sqrt(shape[1])


@pytest.fixture(scope="module")
def enc_models():
    jm = seeded_jax_model(jax_dred.random_enc, 0, _rdovae_scale)
    return jm, convert.rdovae_enc_from_numpy(jm, "cpu")


@pytest.fixture(scope="module")
def dec_models():
    jm = seeded_jax_model(jax_dred.random_dec, 1, _rdovae_scale)
    return jm, convert.rdovae_dec_from_numpy(jm, "cpu")


def test_rdovae_encode_and_decode_match_jax(enc_models, dec_models):
    """S = 2 streams in one batch against the JAX single-stream functions,
    5 dframes with the state threaded (the dilated convolutions' history
    reaches back two steps)."""
    (je, te), (jd, td) = enc_models, dec_models
    S, F = 2, 5
    rng = np.random.default_rng(5)
    est_j = [jax_dred.enc_init_state(je) for _ in range(S)]
    est_t = dred.enc_init_state(te, S)
    st24 = (rng.standard_normal((S, 24)) * 0.5).astype(np.float32)
    dst_j = [jax_dred.dec_init_state(jd, jnp.asarray(st24[s]))
             for s in range(S)]
    dst_t = dred.dec_init_state(td, torch.from_numpy(st24))
    for f in range(F):
        feats = (rng.standard_normal((S, 40)) * 0.5).astype(np.float32)
        lat_t, ini_t, est_t = dred.encode_dframe(te, est_t,
                                                 torch.from_numpy(feats))
        lat24 = (rng.standard_normal((S, 24))).astype(np.float32)
        out_t, dst_t = dred.decode_qframe(td, dst_t, torch.from_numpy(lat24))
        for s in range(S):
            lat_j, ini_j, est_j[s] = jax_dred.encode_dframe(
                je, est_j[s], jnp.asarray(feats[s]))
            out_j, dst_j[s] = jax_dred.decode_qframe(jd, dst_j[s],
                                                     jnp.asarray(lat24[s]))
            for got, want in ((lat_t[s], lat_j), (ini_t[s], ini_j),
                              (out_t[s], out_j)):
                assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL
    for got, want in zip(dst_t.gru_states, dst_j[1].gru_states):
        assert np.abs(got[1].numpy() - np.asarray(want)).max() <= TOL
    assert [len(c.past) for c in dst_t.conv_states] == [1, 2, 2, 2, 2]


def test_transport_equals_reference():
    """Payloads byte-equal at several levels, offsets and budgets; parsed
    packets equal (the stats are equal: tests/test_torch_tables.py)."""
    stats = dred.synthetic_stats(0)
    rng = np.random.default_rng(2)
    for q0, dq, offset, max_bytes in ((6, 4, 0, 160), (3, 7, 100, 160),
                                      (12, 2, 31, 60), (0, 0, 16, 160)):
        lat = [(rng.standard_normal(24) * 2).astype(np.float32)
               for _ in range(26)]
        st = rng.standard_normal(24).astype(np.float32)
        got = dred.dred_encode(lat, st, stats, q0, dq, offset, max_bytes)
        want = jax_dred.dred_encode(lat, st, stats, q0, dq, offset,
                                    max_bytes)
        assert got == want
        pg, pw = dred.dred_parse(got, stats), jax_dred.dred_parse(want, stats)
        assert (pg.q0, pg.dq, pg.offset) == (pw.q0, pw.dq, pw.offset) \
            == (q0, dq, offset)
        np.testing.assert_array_equal(pg.state_q, pw.state_q)
        assert len(pg.latents_q) == len(pw.latents_q) > 0
        for a, b in zip(pg.latents_q, pw.latents_q):
            np.testing.assert_array_equal(a, b)


def _speechish(n, fs=48000, seed=7):
    """The signal of tests/test_deep_recovery.py."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    f0 = 120 + 30 * np.sin(2 * np.pi * 2.3 * t)
    sig = 0.3 * np.sin(2 * np.pi * np.cumsum(f0) / fs)
    sig *= 0.6 + 0.4 * np.sin(2 * np.pi * 4.0 * t) ** 2
    sig += 0.01 * rng.standard_normal(n)
    return sig.astype(np.float32)[:, None]


def _both_encoders(fs=48000, channels=1, application=None, bitrate=None):
    args = (fs, channels) + (() if application is None else (application,))
    pair = (opus_encoder.OpusEncoder(*args),
            jax_opus_encoder.OpusEncoder(*args))
    if bitrate is not None:
        for enc in pair:
            enc.set_bitrate(bitrate)
    return pair


def _encode_both(pair, sig, frame, n_frames):
    out = []
    for f in range(n_frames):
        pcm = sig[f * frame:(f + 1) * frame]
        got, want = (enc.encode(pcm, frame) for enc in pair)
        assert got == want, f"frame {f}: {len(got)} / {len(want)} bytes"
        out.append(got)
    return out


@pytest.fixture(scope="module")
def dred_packets(enc_models):
    """8 mono 20 ms frames at 24 kbit/s with DRED (40 x 10 ms), from the
    copied encoder with the JAX encoder's RDOVAE weights carried across,
    each packet byte-equal to the JAX package's."""
    je, te = enc_models
    port, ref = _both_encoders(bitrate=24000)
    port.set_dred_duration(40, model=te)
    ref.set_dred_duration(40, model=je)
    assert port._dred.device == torch.device("cpu")
    return _encode_both((port, ref), _speechish(960 * 8), 960, 8)


def test_encoder_dred_branch(dred_packets):
    n = sum(dred_api.opus_dred_parse(p) is not None for p in dred_packets)
    assert n >= 6, f"DRED in {n} of 8 packets"


def test_encoder_16khz_branch():
    """A 16 kHz API rate rides the input resampler up to the 48 kHz core."""
    pair = _both_encoders(fs=16000, bitrate=32000)
    _encode_both(pair, _speechish(320 * 6, fs=16000), 320, 6)


def test_encoder_100ms_branch():
    """80-120 ms frames are 20 ms frames merged by the repacketizer."""
    pair = _both_encoders(bitrate=32000)
    pkts = _encode_both(pair, _speechish(4800 * 2), 4800, 2)
    assert all(p[0] & 0x3 == 3 for p in pkts)      # code-3 packets


def test_encoder_app_audio_branch():
    """APP_AUDIO with 20 ms frames runs the tonality analysis, which
    chooses the mode."""
    pair = _both_encoders(application=opus_encoder.APP_AUDIO, bitrate=32000)
    _encode_both(pair, _speechish(960 * 6), 960, 6)
    assert pair[0].analysis_info is not None
    assert pair[0].analysis_info.valid == pair[1].analysis_info.valid


def test_opus_dred_parse_and_process_match_jax(dred_packets, dec_models):
    """Quantized fields equal; features within 1e-4."""
    jd, td = dec_models
    n = 0
    for pkt in dred_packets:
        got, want = (dred_api.opus_dred_parse(pkt),
                     jax_dred_api.opus_dred_parse(pkt))
        assert (got is None) == (want is None)
        if got is None:
            continue
        n += 1
        assert (got.q0, got.dq, got.dred_offset) \
            == (want.q0, want.dq, want.dred_offset)
        np.testing.assert_array_equal(got.state_q, want.state_q)
        assert got.nb_latents == want.nb_latents
        for a, b in zip(got.latents_q, want.latents_q):
            np.testing.assert_array_equal(a, b)
        fg = np.stack(dred_api.opus_dred_process(got, model=td))
        fw = np.stack(jax_dred_api.opus_dred_process(want, model=jd))
        assert fg.shape == fw.shape == (4 * got.nb_latents, 20)
        assert np.abs(fg - fw).max() <= 1e-4
    assert n >= 6
    assert dred_api.opus_dred_parse(dred_packets[0][:1] + b"\x00") is None
