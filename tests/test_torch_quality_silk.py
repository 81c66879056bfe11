"""mousiki_tpu_torch/quality.py: the CELT packets against the committed
fixture, the SILK lanes against the JAX package and the host encoder,
and the reports' rows (split from tests/test_torch_quality.py so that the
tier-1 suite's files stay short).
"""

import numpy as np
import pytest

from mousiki_tpu_torch import quality as q
from test_torch_quality import (SILK_FRAMES, SILK_SNR_TOL_DB,  # noqa: F401
                                celt, fixture, needs_libopus)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("rate", q.CELT_RATES)
def test_celt_packets_equal_the_fixture(celt, fixture, rate):
    """The CPU port's packets are the fixture's: a change to the encoder
    shows as a stale fixture (`tools/gen_torch_quality_fixture.py`)."""
    k = q.CELT_RATES.index(rate)
    assert celt[rate][0] == fixture["celt_packets"][k]


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
