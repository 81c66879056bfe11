"""The port's single-stream OpusDecoder (the copy under
mousiki_tpu_torch/hostcodec/) against the JAX package's: the committed
golden streams (final ranges equal to the fixture's, PCM within 1e-6 of
the JAX decoder's), the smallest cases of test_opus_decoder.py on fresh
libopus packets (SILK frame sizes, API rates, PLC and FEC, mode
transitions; ranges equal to libopus's, PCM equal to the JAX decoder's),
deep-PLC concealment and the DRED decode of test_dred_e2e.py on JAX
weights carried across (integer pitch periods equal frame by frame, then
PCM within 1e-4), and the deep-PLC shim's device rule.

The SILK, PLC / FEC and transition cases are in
tests/test_torch_opus_decoder_silk.py, the neural ones in
tests/test_torch_opus_decoder_neural.py. (Split so that each of the
port's test files holds at most 8 cases: the tier-1 suite then starts
its longest file early.)
"""

import numpy as np
import pytest

from golden_streams import load_all
from mousiki_tpu import opus_decoder as jax_opus_decoder
from mousiki_tpu.models import deep_plc as jax_plc
from mousiki_tpu.models import dred as jax_dred
from mousiki_tpu.models import fargan as jax_fargan
from mousiki_tpu.testing import oracle
from mousiki_tpu_torch import convert
from mousiki_tpu_torch.hostcodec import opus_decoder
from mousiki_tpu_torch.hostcodec.opus_encoder import APP_VOIP, OpusEncoder
from mousiki_tpu_torch.models import deep_plc
from torch_threads import one_torch_thread  # noqa: F401
from torch_threads import seeded_jax_model

GOLDEN_TOL = 1e-6     # tests/test_fixture_vectors.py:63
NEURAL_TOL = 1e-4     # tests/test_deep_recovery.py:92

needs_oracle = pytest.mark.skipif(not oracle.available(),
                                  reason="libopus oracle missing")


def _pair(fs=48000, channels=1):
    return (opus_decoder.OpusDecoder(fs, channels),
            jax_opus_decoder.OpusDecoder(fs, channels))


@pytest.mark.parametrize("index", range(8))
def test_golden_stream(index):
    """Each fixture stream: every final range equal to the fixture's, PCM
    within 1e-6 of the JAX decoder's and of the golden PCM."""
    stream = load_all()[index]
    channels = stream.pcm.shape[1]
    port, ref = _pair(channels=channels)
    for f, pkt in enumerate(stream.packets):
        got, want = port.decode(pkt, 960), ref.decode(pkt, 960)
        assert port.final_range == ref.final_range == stream.ranges[f], f
        assert got.shape == (960, channels)
        assert np.abs(got - want).max() <= GOLDEN_TOL, f
        golden = stream.pcm[f * 960:(f + 1) * 960]
        assert np.abs(got.astype(np.float32) - golden).max() <= GOLDEN_TOL


def _libopus_packets(frame, nf=8, n_signal=None, fec=False, seed=5):
    """Wide-band SILK at 24 kbit/s from libopus, as test_opus_decoder.py
    encodes it (its signal: frame * (nf + 1) samples unless given)."""
    enc = oracle.RefEncoder(48000, 1, oracle.APP_VOIP)
    enc.ctl_set(oracle.SET_BITRATE, 24000)
    enc.ctl_set(oracle.SET_FORCE_MODE, oracle.MODE_SILK_ONLY)
    enc.ctl_set(oracle.SET_BANDWIDTH, oracle.BANDWIDTH_WIDEBAND)
    if fec:
        enc.ctl_set(oracle.SET_INBAND_FEC, 1)
        enc.ctl_set(oracle.SET_PACKET_LOSS_PERC, 20)
    pcm16 = oracle.float_to_i16(oracle.make_test_signal(
        n_signal or frame * (nf + 1), 1, seed=seed))
    return [enc.encode(pcm16[f * frame:(f + 1) * frame].reshape(-1))
            for f in range(nf)]


def _decode_all(calls, fs=48000):
    """calls: (packet or None, frame, decode_fec). Port, JAX and libopus
    decode the same calls: ranges equal to libopus's, PCM equal to the
    JAX decoder's (the same numpy code) and within 5e-5 of libopus's."""
    port, ref = _pair(fs)
    lib = oracle.RefDecoder(fs, 1)
    for i, (pkt, n, fec) in enumerate(calls):
        got = port.decode(pkt, n, decode_fec=fec)
        np.testing.assert_array_equal(got, ref.decode(pkt, n, decode_fec=fec))
        want = lib.decode_float(pkt, n, fec=int(fec))
        assert np.abs(got - want).max() < 5e-5, i
        if pkt is not None and not fec:
            assert port.final_range == ref.final_range \
                == lib.final_range(), i


# ------------------------------------------------------------ neural


@pytest.fixture(scope="module")
def plc_models():
    """FARGAN and PitchDNN of the JAX package with seeded weights, and the
    same weights carried across to the port (as tests/test_torch_fargan.py
    draws them)."""
    jf = seeded_jax_model(jax_fargan.random_model, 2, lambda s: 0.08)
    jp = seeded_jax_model(jax_plc.random_pitchdnn, 3,
                          lambda s: 1.0 / np.sqrt(s[1]))
    return (jf, jp, convert.fargan_from_numpy(jf, "cpu"),
            convert.pitchdnn_from_numpy(jp, "cpu"))


@pytest.fixture
def periods(monkeypatch):
    """The float pitch periods each side's PitchDNN gives, in call order."""
    seen = {"port": [], "jax": []}

    def recorder(module, key):
        inner = module.compute_pitchdnn

        def wrapped(model, state, features):
            period, state = inner(model, state, features)
            seen[key].append(np.asarray(period, np.float64).reshape(-1)[0]
                             if key == "jax" else float(period[0]))
            return period, state
        monkeypatch.setattr(module, "compute_pitchdnn", wrapped)

    recorder(deep_plc, "port")
    recorder(jax_plc, "jax")
    return seen


def _check_periods(seen):
    """Integer periods equal frame by frame, then the floats within 1e-3."""
    port, ref = np.array(seen["port"]), np.array(seen["jax"])
    assert len(port) == len(ref) > 0
    np.testing.assert_array_equal(port.astype(np.int32), ref.astype(np.int32))
    assert np.abs(port - ref).max() <= 1e-3


def _deep_pair(plc_models):
    jf, jp, tf, tp = plc_models
    port, ref = _pair()
    port.set_deep_plc(tf, tp)
    ref.set_deep_plc(jf, jp)
    assert port.deep_plc.device.type == "cpu"
    return port, ref


def _rdovae_scale(shape):
    return 0.3 / np.sqrt(shape[1])


@pytest.fixture(scope="module")
def dred_stream():
    """11 mono 20 ms packets at 24 kbit/s with DRED (40 x 10 ms) from the
    copied encoder, whose RDOVAE encoder has the JAX encoder's seeded
    weights (its packets are byte-equal to the JAX package's:
    tests/test_torch_dred.py); and the RDOVAE decoder of both sides."""
    je = seeded_jax_model(jax_dred.random_enc, 0, _rdovae_scale)
    jd = seeded_jax_model(jax_dred.random_dec, 1, _rdovae_scale)
    enc = OpusEncoder(48000, 1, APP_VOIP)
    enc.set_bitrate(24000)
    enc.set_dred_duration(40, model=convert.rdovae_enc_from_numpy(je, "cpu"))
    rng = np.random.default_rng(7)
    t = np.arange(960 * 11) / 48000
    f0 = 120 + 30 * np.sin(2 * np.pi * 2.3 * t)
    sig = 0.3 * np.sin(2 * np.pi * np.cumsum(f0) / 48000)
    sig += 0.1 * np.sin(2 * np.pi * 3 * np.cumsum(f0) / 48000)
    sig *= 0.6 + 0.4 * np.sin(2 * np.pi * 4.0 * t) ** 2
    sig = (sig + 0.01 * rng.standard_normal(len(t))).astype(np.float32)
    pkts = [enc.encode(sig[f * 960:(f + 1) * 960, None], 960)
            for f in range(11)]
    return pkts, jd, convert.rdovae_dec_from_numpy(jd, "cpu")
