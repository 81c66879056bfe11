"""mousiki_tpu_torch.quality, the port's encoder quality chain, against the
JAX package's pipelines and the reference tools (tools/celt_quality_report.py,
tools/silk_quality_report.py) on the CPU: CELT over the whole music corpus
at the three rates, SILK on the wide-band lane that reaches the device
quantizer, the copied helpers, the committed fixture and the reports.

The CELT packets against the fixture, the SILK lanes and the reports are
in tests/test_torch_quality_silk.py. (Split so that each of the port's
test files holds at most 8 cases: the tier-1 suite then starts its
longest file early.)
"""

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
