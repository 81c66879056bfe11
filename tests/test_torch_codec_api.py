"""The port's copies of the single-stream API around OpusDecoder against
the JAX package's: the typed codec.Encoder / Decoder (packets byte-equal,
PCM equal), every ctl request of test_ctl_aux.py (the same results, the
same refusals), the int16 / int24 wrappers, LightweightDecoder, the
TicToc registry, and the port's lazy top-level names. Each scenario runs
once on each package's modules and the two transcripts are compared."""

import types

import numpy as np
import pytest

import mousiki_tpu
import mousiki_tpu_torch
from mousiki_tpu import codec as jax_codec
from mousiki_tpu import ctl as jax_ctl
from mousiki_tpu import lightweight as jax_lightweight
from mousiki_tpu import opus_decoder as jax_opus_decoder
from mousiki_tpu import opus_encoder as jax_opus_encoder
from mousiki_tpu.bitstream import packet as jax_packet
from mousiki_tpu.utils import debug as jax_debug
from mousiki_tpu_torch.hostcodec import codec, ctl, lightweight
from mousiki_tpu_torch.hostcodec import opus_decoder, opus_encoder
from mousiki_tpu_torch.hostcodec.bitstream import packet
from mousiki_tpu_torch.hostcodec.utils import debug
from torch_threads import one_torch_thread  # noqa: F401

PORT = types.SimpleNamespace(
    codec=codec, ctl=ctl, lightweight=lightweight, debug=debug,
    OpusDecoder=opus_decoder.OpusDecoder, OpusEncoder=opus_encoder.OpusEncoder,
    APP_VOIP=opus_encoder.APP_VOIP, Mode=packet.Mode)
JAX = types.SimpleNamespace(
    codec=jax_codec, ctl=jax_ctl, lightweight=jax_lightweight,
    debug=jax_debug, OpusDecoder=jax_opus_decoder.OpusDecoder,
    OpusEncoder=jax_opus_encoder.OpusEncoder,
    APP_VOIP=jax_opus_encoder.APP_VOIP, Mode=jax_packet.Mode)


def _outcome(fn, *args):
    """fn(*args), or the name of the exception it raises."""
    try:
        return fn(*args)
    except Exception as exc:     # the refusal itself is compared
        return f"raises {type(exc).__name__}"


def _assert_same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype, i
            np.testing.assert_array_equal(g, w, err_msg=str(i))
        else:
            assert type(g).__name__ == type(w).__name__ and g == w, (i, g, w)


def _tone(n, hz, amp=0.5):
    t = np.arange(n) / 48000.0
    return np.clip(amp * np.sin(2 * np.pi * hz * t), -0.9, 0.9)[:, None]


def _codec_round_trip(ns):
    """test_api_multistream.py's typed round trip, on a seeded signal."""
    C = ns.codec
    enc = C.Encoder(48000, C.Channels.STEREO,
                    C.Application.RESTRICTED_LOWDELAY).set_bitrate(96000)
    dec = C.Decoder(48000, C.Channels.STEREO)
    rng = np.random.default_rng(5)
    sig = 0.3 * np.sin(np.arange(960 * 4)[:, None] * [0.03, 0.05]) \
        + 0.02 * rng.standard_normal((960 * 4, 2))
    out = []
    for f in range(4):
        pkt = enc.encode_float(sig[f * 960:(f + 1) * 960],
                               C.FrameDuration.MS_20)
        out += [pkt, enc.final_range, dec.decode_float(pkt, 960),
                dec.final_range, dec.last_packet_duration]
    dec.set_gain(256)
    out += [dec.decode(pkt, 960), dec.decode(None, 960)]
    dec.reset()
    i16 = (sig[:960] * 20000).astype(np.int16)
    out += [enc.encode(i16, 960), dec.decode_float(out[0], 960)]
    return out


def _decoder_ctls(ns):
    """test_ctl_aux.py test_decoder_ctls."""
    C = ns.ctl
    dec = ns.OpusDecoder(48000, 2)
    out = [C.opus_decoder_ctl(dec, C.OPUS_GET_SAMPLE_RATE)]
    C.opus_decoder_ctl(dec, C.OPUS_SET_GAIN, 256)
    out += [C.opus_decoder_ctl(dec, C.OPUS_GET_GAIN), dec.decode_gain,
            _outcome(C.opus_decoder_ctl, dec, C.OPUS_SET_GAIN, 99999)]
    C.opus_decoder_ctl(dec, C.OPUS_SET_COMPLEXITY, 5)
    out += [C.opus_decoder_ctl(dec, C.OPUS_GET_COMPLEXITY),
            C.opus_decoder_ctl(dec, C.OPUS_GET_FINAL_RANGE)]
    C.opus_decoder_ctl(dec, C.OPUS_SET_PHASE_INVERSION_DISABLED, True)
    out.append(C.opus_decoder_ctl(dec, C.OPUS_GET_PHASE_INVERSION_DISABLED))
    C.opus_decoder_ctl(dec, C.OPUS_RESET_STATE)
    out += [C.opus_decoder_ctl(dec, C.OPUS_GET_LAST_PACKET_DURATION),
            _outcome(C.opus_decoder_ctl, dec, 9999)]
    return out


def _decoder_pitch_and_duration(ns):
    """test_ctl_aux.py test_decoder_pitch_and_duration (4 frames, not 10)."""
    C = ns.ctl
    sig = _tone(960 * 4, 130)
    enc = ns.OpusEncoder(48000, 1, ns.APP_VOIP)
    enc.set_bitrate(24000)
    dec = ns.OpusDecoder(48000, 1)
    out = []
    for f in range(sig.shape[0] // 960):
        pkt = enc.encode(sig[f * 960:(f + 1) * 960], 960)
        out += [pkt, dec.decode(pkt, 960)]
    out += [C.opus_decoder_ctl(dec, C.OPUS_GET_LAST_PACKET_DURATION),
            C.opus_decoder_ctl(dec, C.OPUS_GET_PITCH),
            C.opus_decoder_ctl(dec, C.OPUS_GET_BANDWIDTH),
            C.opus_decoder_ctl(dec, C.OPUS_GET_FINAL_RANGE)]
    return out


def _encoder_ctls(ns):
    """test_ctl_aux.py test_encoder_ctls."""
    C = ns.ctl
    enc = ns.OpusEncoder(48000, 1, ns.APP_VOIP)
    out = []
    for set_req, get_req, value in (
            (C.OPUS_SET_BITRATE, C.OPUS_GET_BITRATE, 32000),
            (C.OPUS_SET_PACKET_LOSS_PERC, C.OPUS_GET_PACKET_LOSS_PERC, 10),
            (C.OPUS_SET_INBAND_FEC, C.OPUS_GET_INBAND_FEC, True),
            (C.OPUS_SET_DTX, C.OPUS_GET_DTX, True)):
        C.opus_encoder_ctl(enc, set_req, value)
        out.append(C.opus_encoder_ctl(enc, get_req))
    C.opus_encoder_ctl(enc, C.OPUS_SET_FORCE_MODE, 1000)
    out.append(enc.force_mode == ns.Mode.SILK)
    C.opus_encoder_ctl(enc, C.OPUS_SET_FORCE_MODE, C.OPUS_AUTO)
    out += [enc.force_mode, C.opus_encoder_ctl(enc, C.OPUS_GET_LOOKAHEAD),
            C.opus_encoder_ctl(enc, C.OPUS_GET_SAMPLE_RATE),
            C.opus_encoder_ctl(enc, C.OPUS_RESET_STATE)]
    return out


def _sample_format_wrappers(ns):
    """test_ctl_aux.py test_sample_format_wrappers, with a loud frame that
    the int16 decode soft-clips."""
    t = np.arange(960) / 48000.0
    sig16 = (np.sin(2 * np.pi * 440 * t) * 20000).astype(np.int16)[:, None]
    enc = ns.OpusEncoder(48000, 1)
    pkt = enc.encode_int16(sig16, 960)
    loud = enc.encode(1.6 * np.sin(2 * np.pi * 330 * t)[:, None], 960)
    dec, dec24 = ns.OpusDecoder(48000, 1), ns.OpusDecoder(48000, 1)
    return [pkt, dec.decode_int16(pkt, 960), dec24.decode_int24(pkt, 960),
            loud, dec.decode_int16(loud, 960), dec24.decode_int24(loud, 960),
            dec._declip_mem.copy(),
            enc.encode_int24(sig16.astype(np.int32) * 256, 960)]


def _lightweight_decoder(ns):
    """test_ctl_aux.py test_lightweight_decoder (4 frames, not 10)."""
    L = ns.lightweight
    enc = ns.OpusEncoder(48000, 1, ns.APP_VOIP)
    enc.set_bitrate(24000)
    enc.force_mode = ns.Mode.SILK
    sig = _tone(960 * 4, 200, 0.4)
    dec = L.LightweightDecoder()
    out = []
    for f in range(4):
        pkt = enc.encode(sig[f * 960:(f + 1) * 960], 960)
        bw, stereo, pcm = dec.decode_float32(pkt)
        out += [pkt, int(bw), stereo, pcm, dec.decode(pkt)[2]]
    out.append(_outcome(dec.decode, b"\xfc\x00"))
    return out


@pytest.mark.parametrize("scenario", [
    _codec_round_trip, _decoder_ctls, _decoder_pitch_and_duration,
    _encoder_ctls, _sample_format_wrappers, _lightweight_decoder],
    ids=lambda fn: fn.__name__.strip("_"))
def test_same_as_jax(scenario):
    got, want = scenario(PORT), scenario(JAX)
    assert len(want) > 3
    _assert_same(got, want)


def test_ctl_results_are_plausible():
    """The transcripts compared above carry real values: a pitch near
    130 Hz's period (or its octave), a 20 ms duration, 48 kHz, audio that
    came through the lightweight decoder."""
    pitch = _decoder_pitch_and_duration(PORT)
    assert pitch[-4] == 960 and pitch[-3] > 0 and pitch[-2] > 0
    assert _decoder_ctls(PORT)[0] == 48000
    light = _lightweight_decoder(PORT)
    assert light[2] is False and light[3].shape == (960, 1)
    assert np.abs(light[-3]).max() > 0.1
    assert light[-1] == "raises LightweightError"


def test_tictoc():
    """The registry's spans and counts as the reference's; off, it records
    nothing."""
    reports = []
    for D in (debug, jax_debug):
        before = D.ENABLED
        D.ENABLED = True
        try:
            reg = D.TicToc()
            with reg.span("stage_a"):
                sum(range(1000))
            for _ in range(3):
                reg.tic("stage_b")
                reg.toc("stage_b")
            reports.append([line.split()[:2]
                            for line in reg.report().splitlines()])
            D.ENABLED = False
            off = D.TicToc()
            off.tic("x")
            off.toc("x")
            assert off.report().count("\n") == 0
        finally:
            D.ENABLED = before
    assert reports[0] == reports[1]
    assert reports[0][1:] == [["stage_a", "1"], ["stage_b", "3"]]


def test_top_level_names():
    """The reference's sixteen top-level names resolve lazily to the
    hostcodec/ classes, beside the port's pipelines."""
    names = set(mousiki_tpu.__all__)
    assert len(names) == 16 and names <= set(mousiki_tpu_torch.__all__)
    for name in sorted(names):
        got = getattr(mousiki_tpu_torch, name)
        want = getattr(mousiki_tpu, name)
        assert got.__name__ == want.__name__, name
        assert got.__module__ == want.__module__.replace(
            "mousiki_tpu.", "mousiki_tpu_torch.hostcodec."), name
    assert mousiki_tpu_torch.OpusDecoder is opus_decoder.OpusDecoder
    assert mousiki_tpu_torch.Decoder is codec.Decoder
    with pytest.raises(AttributeError):
        getattr(mousiki_tpu_torch, "NoSuchName")
