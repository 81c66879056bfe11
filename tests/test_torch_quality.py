"""mousiki_tpu_torch.quality, the port's encoder quality chain, against the
JAX package's pipelines and the reference tools (tools/celt_quality_report.py,
tools/silk_quality_report.py) on the CPU: CELT over the whole music corpus
at the three rates, SILK on the wide-band lane that reaches the device
quantizer, the copied helpers, the committed fixture and the reports."""

import os
import sys

import numpy as np
import pytest

from mousiki_tpu.testing import oracle
from mousiki_tpu_torch import quality as q
from torch_threads import one_torch_thread  # noqa: F401

_TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
if _TOOLS not in sys.path:
    sys.path.insert(0, _TOOLS)

import celt_quality_report  # noqa: E402
import silk_quality_report  # noqa: E402

needs_libopus = pytest.mark.skipif(not oracle.available(),
                                   reason="libopus oracle unavailable")

# share of a rate's 200 packets byte-equal to the JAX pipeline's (measured
# 0.995 / 1.0 / 0.95 at 64 / 96 / 128 kbit/s: the fronts agree to float
# tolerance, so a near-tie in a decision can flip)
CELT_EQUAL_BAR = 0.9
# err4, err16 and pitch of the port against the JAX pipeline's, both
# decoded by libopus (measured: equal to 4 decimals, at most 2e-5 apart)
SCORE_TOL = 0.005
# libopus-decoded SNR of the 24 kbit/s SILK lane against the JAX
# pipeline's over 8 frames (measured: 0.0 dB, every packet byte-equal)
SILK_SNR_TOL_DB = 0.5
SILK_FRAMES = 8


@pytest.fixture(scope="module")
def celt():
    """Every corpus frame through the port's and the JAX package's CELT
    encoders at each rate: {rate: (port packets, JAX packets)}."""
    from mousiki_tpu.pipeline import CeltEncodePipeline as JaxPipeline
    sig = q.load_corpus()
    return {rate: (q.encode_celt_corpus(rate, device="cpu"),
                   q.celt_packets(JaxPipeline(1, channels=2, bitrate=rate),
                                  sig))
            for rate in q.CELT_RATES}


@pytest.fixture(scope="module")
def celt_scores(celt):
    """libopus-decoded opus_compare scores of both sides' packets:
    {rate: (port scores, JAX scores)}."""
    sig = q.load_corpus()
    ref16 = q.downmix_16k(sig[: len(sig) // q.FRAME * q.FRAME])
    return {rate: tuple(q.score(ref16, list(pair), 2, q.decode_libopus))
            for rate, pair in celt.items()}


@pytest.fixture(scope="module")
def fixture():
    return q.load_fixture()


def test_helper_copies_equal_the_tools():
    corpus = q.load_corpus()
    np.testing.assert_array_equal(corpus, celt_quality_report.load_corpus())
    part = corpus[: 20 * q.FRAME]
    np.testing.assert_array_equal(q.downmix_16k(part),
                                  celt_quality_report.downmix_16k(part))
    speech = q.make_speech()
    np.testing.assert_array_equal(speech, silk_quality_report.make_speech())
    np.testing.assert_array_equal(q.downmix_16k(speech),
                                  silk_quality_report.downmix_16k(speech))
    np.testing.assert_array_equal(q.downmix_16k(speech),
                                  celt_quality_report.downmix_16k(speech))
    assert q.speech_frames().shape == (300 * q.FRAME,)


@pytest.mark.parametrize("rate", q.CELT_RATES)
def test_celt_packets_against_jax(celt, rate):
    port, jax = celt[rate]
    assert len(port) == len(jax) == 200
    assert [len(p) for p in port] == [len(p) for p in jax]
    assert all(p[0] == q.CELT_TOC[0] for p in port)
    share = q.equal_share(port, jax)
    print(f"{rate} bit/s: {share:.3f} of the packets byte-equal to JAX's")
    assert share >= CELT_EQUAL_BAR


@needs_libopus
@pytest.mark.parametrize("rate", q.CELT_RATES)
def test_celt_scores_against_jax(celt_scores, rate):
    port, jax = celt_scores[rate]
    print(f"{rate} bit/s: port {port}, JAX {jax}")
    for key in ("err4", "err16", "pitch"):
        assert abs(port[key] - jax[key]) <= SCORE_TOL, (key, port, jax)
    assert port["kbps"] == jax["kbps"]


@pytest.mark.parametrize("rate", q.CELT_RATES)
def test_celt_packets_equal_the_fixture(celt, fixture, rate):
    """The CPU port's packets are the fixture's: a change to the encoder
    shows as a stale fixture (`tools/gen_torch_quality_fixture.py`)."""
    k = q.CELT_RATES.index(rate)
    assert celt[rate][0] == fixture["celt_packets"][k]


@needs_libopus
def test_fixture_holds_libopus_scores(celt_scores, fixture):
    """The fixture's CELT scores are libopus's decode of its packets, and
    its libopus CBR rows are QUALITY_CELT.md's."""
    assert fixture["libopus"] == oracle.version()
    for k, rate in enumerate(q.CELT_RATES):
        assert fixture["celt_scores"][k] == celt_scores[rate][0]
    assert [round(s["err4"], 3) for s in fixture["celt_libopus_scores"]] \
        == [0.146, 0.154, 0.148]
    silk_pcm = np.stack(q.decode_libopus(fixture["silk_packets"], 1))
    np.testing.assert_array_equal(silk_pcm, fixture["silk_libopus_pcm"])


@needs_libopus
def test_silk_wideband_lane_against_jax(fixture):
    """The 24 kbit/s lane reaches the device quantizer in both pipelines;
    its packets, decoded by libopus, are as close to the input as the JAX
    pipeline's."""
    from mousiki_tpu.pipeline import SilkEncodePipeline as JaxPipeline
    case = q.SILK_WIDEBAND[0]
    port, calls = q.encode_silk_cases([case], device="cpu",
                                      n_frames=SILK_FRAMES)
    jax_pipe = JaxPipeline(1)
    jax_calls = [0]
    dispatch = jax_pipe._ex._dispatch

    def counted(reqs):
        jax_calls[0] += 1
        return dispatch(reqs)

    jax_pipe._ex._dispatch = counted
    sig = q.speech_frames()
    jax = q.silk_packets(jax_pipe, [case[0]], sig, SILK_FRAMES)
    assert calls[0] > 0 and jax_calls[0] > 0, (calls, jax_calls)
    x = sig[: SILK_FRAMES * q.FRAME, None]
    snr = [q.snr_db(x, pcm) for pcm in q.decode_libopus(port + jax, 1)]
    share = q.equal_share(port[0], jax[0])
    print(f"24 kbit/s lane, {SILK_FRAMES} frames: device calls {calls[0]} "
          f"(JAX {jax_calls[0]}), SNR {snr[0]:.3f} dB (JAX {snr[1]:.3f}), "
          f"{share:.3f} of the packets byte-equal to JAX's")
    assert abs(snr[0] - snr[1]) <= SILK_SNR_TOL_DB
    assert port[0] == fixture["silk_packets"][0][:SILK_FRAMES]


@pytest.mark.parametrize("case", [q.SILK_CASES[1], q.SILK_CASES[3]],
                         ids=["8kHz", "12kHz"])
def test_silk_narrow_lanes_are_the_host_encoder(case):
    """8 and 16 kbit/s run at 8 and 12 kHz internal rate: the device
    quantizer never holds the lane, and the hook's host quantizer gives
    the packets of the copied OpusEncoder alone (the reference tool's
    loop) at the warping of the lane's rate. The pipeline hands the
    encoder float64 PCM; the tool's float32 gives other packets from
    frame 84 on at 8 kbit/s, so the comparison is in float64."""
    from mousiki_tpu_torch.hostcodec.bitstream.packet import Mode
    from mousiki_tpu_torch.hostcodec.opus_encoder import APP_VOIP, \
        OpusEncoder
    n = 4
    packets, calls = q.encode_silk_cases([case], device="cpu", n_frames=n)
    assert calls == [0]
    enc = OpusEncoder(48000, 1, APP_VOIP)
    enc.set_bitrate(case[0])
    enc.force_mode = Mode.SILK
    sig = q.speech_frames().astype(np.float64)
    want = [enc.encode(sig[f * q.FRAME:(f + 1) * q.FRAME, None], q.FRAME)
            for f in range(n)]
    assert packets[0] == want


def test_reports_carry_every_row(tmp_path):
    """The two markdown writers: a row for each rate and case, the
    reference file's own row beside it, the device quantizer calls of each
    SILK lane and the agreement tables."""
    s = {"err4": 0.1, "err16": 0.2, "pitch": 0.01, "kbps": 64.4}
    celt_rows = [{"rate": r, "port": s, "libopus": s, "jax": s,
                  "equal_to_jax": 1.0} for r in q.CELT_RATES]
    path = tmp_path / "celt.md"
    q.write_celt_report(str(path), celt_rows, "cpu")
    text = path.read_text()
    assert "| 64 kbps | 0.100 | 0.200 | 0.010 | 64.4 | 0.100 |" in text
    assert "| 0.148 | 0.506 |" in text          # QUALITY_CELT.md's 64 kbps
    assert text.count("+0.00000 | +0.00000 | +0.00000") == 3
    silk_rows = [{"case": c, "port": s, "libopus": s,
                  "device_calls": 30 if c in q.SILK_WIDEBAND else 0}
                 for c in q.SILK_CASES]
    path = tmp_path / "silk.md"
    q.write_silk_report(str(path), silk_rows, "cpu")
    text = path.read_text()
    assert text.count("host quantizer (byte copy; no device code) | 0 |") \
        == 4
    assert text.count("device (`ops/silk_nsq.py`) | 30 |") == 2
    assert "| 0.152 | 0.441 |" in text          # QUALITY_SILK.md's 24 kbps
