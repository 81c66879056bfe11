"""The port's single-stream OpusDecoder against the JAX package's on
libopus packets: SILK frame sizes and API rates, PLC and FEC, mode
transitions (split from tests/test_torch_opus_decoder.py so that the
tier-1 suite's files stay short).
"""

import pytest

from mousiki_tpu.testing import oracle
from test_torch_opus_decoder import (_decode_all,  # noqa: F401
                                     _libopus_packets, needs_oracle)
from torch_threads import one_torch_thread  # noqa: F401


@needs_oracle
@pytest.mark.parametrize("frame", [480, 2880])
def test_silk_frame_sizes(frame):
    _decode_all([(p, frame, False) for p in _libopus_packets(frame)])


@needs_oracle
@pytest.mark.parametrize("fs_api", [8000, 24000])
def test_silk_api_rates(fs_api):
    n = 960 * fs_api // 48000
    _decode_all([(p, n, False) for p in _libopus_packets(960)], fs_api)


@needs_oracle
def test_plc_and_fec():
    """test_opus_decoder.py's case: packets 5, 6 and 11 of 20 lost; 5 and
    11 concealed, 6 recovered from packet 7's LBRR."""
    pkts = _libopus_packets(960, 20, n_signal=960 * 22, fec=True, seed=13)
    lost = {5, 6, 11}
    calls = []
    for f, pkt in enumerate(pkts):
        if f not in lost:
            calls.append((pkt, 960, False))
        elif f + 1 not in lost and f + 1 < len(pkts):
            calls.append((pkts[f + 1], 960, True))
        else:
            calls.append((None, 960, False))
    _decode_all(calls)


@needs_oracle
def test_mode_transitions():
    """SILK -> CELT -> hybrid -> SILK mid-stream, two frames a mode."""
    enc = oracle.RefEncoder(48000, 1, oracle.APP_AUDIO)
    pcm16 = oracle.float_to_i16(oracle.make_test_signal(960 * 9, 1, seed=11))
    plan = ([(oracle.MODE_SILK_ONLY, oracle.BANDWIDTH_WIDEBAND, 24000)] * 2
            + [(oracle.MODE_CELT_ONLY, oracle.BANDWIDTH_FULLBAND, 64000)] * 2
            + [(oracle.MODE_HYBRID, oracle.BANDWIDTH_FULLBAND, 40000)] * 2
            + [(oracle.MODE_SILK_ONLY, oracle.BANDWIDTH_NARROWBAND,
                12000)] * 2)
    calls = []
    for f, (mode, bw, br) in enumerate(plan):
        enc.ctl_set(oracle.SET_FORCE_MODE, mode)
        enc.ctl_set(oracle.SET_BANDWIDTH, bw)
        enc.ctl_set(oracle.SET_BITRATE, br)
        calls.append((enc.encode(pcm16[f * 960:(f + 1) * 960].reshape(-1)),
                      960, False))
    _decode_all(calls)
