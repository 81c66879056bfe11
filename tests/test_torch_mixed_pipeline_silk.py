"""OpusStreamPipeline (mousiki_tpu_torch) against the JAX package's: the
device-SILK lane, the push/tick feeder and the three SILK rates in one
batch (the rest of tests/test_torch_mixed_pipeline.py, split from it so
that the tier-1 suite's files stay short).
"""

import numpy as np
import pytest
import torch

from golden_streams import frame_batch
from mousiki_tpu.pipeline import OpusStreamPipeline as JaxPipeline
from mousiki_tpu.testing import oracle
from mousiki_tpu_torch.pipeline import OpusStreamPipeline
from test_torch_mixed_pipeline import (F, JAX_TOL, _encode,  # noqa: F401
                                       mono, needs_oracle)
from torch_threads import one_torch_thread  # noqa: F401


def test_device_silk_lane_matches_jax(mono):
    """silk_synthesis="device": the WB SILK stream's LTP/LPC core runs on
    the device; a CELT loss is still concealed; a SILK loss raises."""
    S = 5
    port = OpusStreamPipeline(S, silk_synthesis="device", device="cpu")
    ref = JaxPipeline(S, silk_synthesis="device")
    host = OpusStreamPipeline(S, device="cpu")
    for f in range(F):
        batch = frame_batch(mono, S, f, packets=True)
        if f == 6:
            batch[0] = None
        got = port.step(batch).numpy()
        want = np.asarray(ref.step(batch, 960))
        assert list(port.last_modes) == list(ref.last_modes)
        assert port.last_modes[1] == 5
        tol = 5e-3 if f in (6, 7) else 1e-4
        assert np.abs(got - want).max() < tol, f
        # the float lane against the bit-exact host synthesis: the
        # reference's own bar (test_pipeline.py, device SILK synthesis)
        assert np.abs(got - host.step(batch).numpy()).max() < 5e-3, f
    for a, b in zip(port.silk_dev_state, ref.silk_dev_state):
        scale = max(1.0, float(np.abs(np.asarray(b)).max()))
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-4 * scale
    batch = frame_batch(mono, S, 0, packets=True)
    batch[1] = None
    with pytest.raises(ValueError, match="lossless"):
        port.step(batch)


def test_feeder_one_frame_packets_equal_step(mono):
    S = 5
    fed = OpusStreamPipeline(S, device="cpu")
    stepped = OpusStreamPipeline(S, device="cpu")
    n = 6
    for f in range(n):
        for s, packet in enumerate(frame_batch(mono, S, f, packets=True)):
            fed.push(s, None if (s, f) == (2, 3) else packet)
    for f in range(n):
        batch = frame_batch(mono, S, f, packets=True)
        if f == 3:
            batch[2] = None
        assert torch.equal(fed.tick(), stepped.step(batch)), f
    # an empty queue underruns as a lost tick
    batch = [None] * S
    assert torch.equal(fed.tick(), stepped.step(batch))
    with pytest.raises(ValueError, match="20 ms CELT"):
        fed.push(0, bytes([16 << 3]) + b"\x00" * 8)


@needs_oracle
def test_feeder_multiframe_matches_jax():
    """40 and 60 ms SILK frames, 10 ms SILK pairs and a two-frame CELT
    packet through push/tick, against the JAX pipeline's feeder."""
    wb, nb = (oracle.SET_BANDWIDTH, 1103), (oracle.SET_BANDWIDTH, 1101)
    streams = [
        _encode(1, oracle.APP_VOIP, 16000, 1920, 4, seed=5, ctl=(wb,)),
        _encode(1, oracle.APP_VOIP, 12000, 2880, 3, seed=5, ctl=(nb,)),
        _encode(1, oracle.APP_RESTRICTED_LOWDELAY, 96000, 1920, 4, seed=5),
        _encode(1, oracle.APP_VOIP, 20000, 480, 15, seed=5, ctl=(wb,)),
    ]
    assert streams[2][0][0] & 3 != 0        # a multi-frame CELT packet
    S, ticks = len(streams), 8
    port = OpusStreamPipeline(S, device="cpu")
    ref = JaxPipeline(S)
    for s, packets in enumerate(streams):
        for packet in packets:
            port.push(s, packet)
            ref.push(s, packet)
    for t in range(ticks):
        got = port.tick().numpy()
        want = np.asarray(ref.tick())
        assert list(port.last_modes) == list(ref.last_modes), t
        assert np.abs(got - want).max() <= JAX_TOL, t


@needs_oracle
def test_all_three_silk_rates_in_one_batch_match_jax(mono):
    """8, 12 and 16 kHz SILK streams beside a CELT stream: each of the
    three masked resamplers owns some row of the batch."""
    streams = [
        _encode(1, oracle.APP_VOIP, 12000, n=6, seed=7,
                ctl=((oracle.SET_BANDWIDTH, 1101),)),
        _encode(1, oracle.APP_VOIP, 14000, n=6, seed=8,
                ctl=((oracle.SET_BANDWIDTH, 1102),)),
        _encode(1, oracle.APP_VOIP, 16000, n=6, seed=9,
                ctl=((oracle.SET_BANDWIDTH, 1103),)),
        mono[0].packets[:6],
    ]
    assert [p[0][0] >> 3 for p in streams[:3]] == [1, 5, 9]   # NB, MB, WB
    S = len(streams)
    port = OpusStreamPipeline(S, device="cpu")
    ref = JaxPipeline(S)
    for f in range(6):
        batch = [streams[s][f] for s in range(S)]
        got = port.step(batch).numpy()
        want = np.asarray(ref.step(batch, 960))
        assert list(port.last_modes) == [1, 1, 1, 0]
        assert np.abs(got - want).max() <= JAX_TOL, f
        assert np.abs(got[:3]).max() > 1e-3, f      # the SILK rows carry audio
