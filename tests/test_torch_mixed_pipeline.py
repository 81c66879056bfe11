"""The port's OpusStreamPipeline (mixed SILK / CELT / hybrid decode) on the
CPU against the JAX package's, on the committed golden packets and, where
libopus is present, on freshly encoded ones.

Bars (all max abs PCM error, full scale 1.0):
  * lossless, against the JAX pipeline: 1e-5 on every frame;
  * lossless, against the golden PCM: 2e-4 (hybrid_fb_48k from frame 2 on:
    its first two frames are outside the pipeline's scope, and the JAX
    pipeline differs from the golden PCM there as well);
  * with loss, against the JAX pipeline: 5e-3 on lost and just-recovered
    frames, 2e-4 elsewhere (the bars of test_pipeline.py's loss tests);
  * the device-SILK lane against the JAX lane: 1e-4;
  * the feeder on one-frame packets equals step() exactly.
"""

import numpy as np
import pytest
import torch

from golden_streams import (MIX_GOLDEN_FROM, frame_batch, golden_pcm,
                            load_mono_mix, load_stereo_celt)
from mousiki_tpu.ops import plc_jax, silk_resampler_jax, synthesis_jax
from mousiki_tpu.pipeline import OpusStreamPipeline as JaxPipeline
from mousiki_tpu.testing import oracle
from mousiki_tpu_torch import convert
from mousiki_tpu_torch.parallel.streaming import StreamMesh
from mousiki_tpu_torch.pipeline import OpusStreamPipeline
from torch_threads import one_torch_thread  # noqa: F401

F = 12
JAX_TOL = 1e-5
GOLDEN_TOL = 2e-4

needs_oracle = pytest.mark.skipif(not oracle.available(),
                                  reason="libopus oracle unavailable")


@pytest.fixture(scope="module")
def mono():
    return load_mono_mix()


def _loss_tol(lost, s, f):
    return 5e-3 if (lost[s, f] or (f and lost[s, f - 1])) else 2e-4


def _encode(channels, app, bitrate, frame=960, n=F, seed=25, ctl=()):
    """n packets of `frame` samples from the libopus encoder."""
    enc = oracle.RefEncoder(48000, channels, app)
    enc.ctl_set(oracle.SET_BITRATE, bitrate)
    for key, value in ctl:
        enc.ctl_set(key, value)
    pcm16 = oracle.float_to_i16(
        oracle.make_test_signal(frame * (n + 1), channels, seed=seed))
    return [enc.encode(pcm16[f * frame:(f + 1) * frame].reshape(-1), frame)
            for f in range(n)]


def test_mono_mix_matches_jax_and_golden(mono):
    S = 5
    port = OpusStreamPipeline(S, channels=1, device="cpu")
    ref = JaxPipeline(S)
    for f in range(F):
        batch = frame_batch(mono, S, f, packets=True)
        got = port.step(batch)
        assert got.shape == (S, 960, 1) and got.dtype == torch.float32
        got = got.numpy()
        want = np.asarray(ref.step(batch, 960))
        assert np.abs(got - want).max() <= JAX_TOL, f
        assert (port.last_modes == ref.last_modes).all()
        err = np.abs(got - golden_pcm(mono, S, f)).max(axis=(1, 2))
        for s in range(S):
            if f >= MIX_GOLDEN_FROM.get(mono[s].name, 0):
                assert err[s] <= GOLDEN_TOL, (f, mono[s].name, err[s])
    assert set(port.last_modes) == {0, 1, 2}


def test_stereo_mix_matches_jax_and_golden(mono):
    """Three stereo CELT streams, a mono SILK stream (duplicated to both
    channels) and a mono hybrid stream in a stereo pipeline."""
    stereo = load_stereo_celt()
    silk, hybrid = mono[1], mono[3]
    S = 5
    port = OpusStreamPipeline(S, channels=2, device="cpu")
    ref = JaxPipeline(S, channels=2)
    for f in range(F):
        batch = frame_batch(stereo, 3, f, packets=True) \
            + [silk.packets[f], hybrid.packets[f]]
        got = port.step(batch).numpy()
        want = np.asarray(ref.step(batch, 960))
        assert got.shape == (S, 960, 2)
        assert np.abs(got - want).max() <= JAX_TOL, f
        gold = np.concatenate([
            golden_pcm(stereo, 3, f),
            np.repeat(golden_pcm([silk, hybrid], 2, f), 2, axis=2)])
        assert np.abs(got - gold).max() <= GOLDEN_TOL, f
    assert list(port.last_modes) == [0, 0, 0, 1, 2]


@pytest.mark.parametrize("fec", [False, True], ids=["plc", "fec"])
def test_loss_matches_jax(mono, fec):
    """~12% loss with a burst; with fec=True every lost stream is offered
    its next packet, and (where libopus is present) one SILK stream
    carries in-band FEC, so its loss is recovered from the LBRR frame."""
    S = 5
    packets = [m.packets for m in mono]
    with_lbrr = fec and oracle.available()
    if with_lbrr:
        packets[1] = _encode(
            1, oracle.APP_VOIP, 28000, n=F + 1, seed=31,
            ctl=((oracle.SET_BANDWIDTH, 1103), (oracle.SET_INBAND_FEC, 1),
                 (oracle.SET_PACKET_LOSS_PERC, 20)))
    rng = np.random.default_rng(23)
    lost = rng.random((S, F)) < 0.12
    lost[:, 0] = False
    lost[:, F - 1] = False
    lost[0, 6:8] = True                     # CELT burst
    lost[1, 6] = lost[1, 9] = True          # SILK singles
    lost[3, 4] = True                       # hybrid single
    port = OpusStreamPipeline(S, device="cpu")
    ref = JaxPipeline(S)
    seen = set()
    for f in range(F):
        batch = [None if lost[s, f] else packets[s][f] for s in range(S)]
        nxt = None
        if fec:
            nxt = [packets[s][f + 1] if lost[s, f] else None
                   for s in range(S)]
        got = port.step(batch, fec_packets=nxt).numpy()
        want = np.asarray(ref.step(batch, 960, fec_packets=nxt))
        assert (port.last_modes == ref.last_modes).all(), f
        seen |= set(int(m) for m in port.last_modes)
        assert np.isfinite(got).all()
        for s in range(S):
            err = np.abs(got[s] - want[s]).max()
            assert err < _loss_tol(lost, s, f), (f, s, err, bool(lost[s, f]))
    assert 3 in seen                        # concealed
    if with_lbrr:
        assert 4 in seen                    # recovered from LBRR


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


def test_all_celt_batch_matches_jax_and_golden(mono):
    """A batch no SILK stream rides: the resamplers run on zero rows and
    add nothing to the CELT output."""
    S = 2
    celt = [mono[0]]
    port = OpusStreamPipeline(S, device="cpu")
    ref = JaxPipeline(S)
    for f in range(4):
        batch = frame_batch(celt, S, f, packets=True)
        got = port.step(batch).numpy()
        want = np.asarray(ref.step(batch, 960))
        assert list(port.last_modes) == [0, 0]
        assert np.abs(got - want).max() <= JAX_TOL, f
        assert np.abs(got - golden_pcm(celt, S, f)).max() <= GOLDEN_TOL, f


@needs_oracle
def test_stereo_silk_and_hybrid_match_jax():
    """Stereo SILK and stereo hybrid packets (joint mid/side decode on the
    native host), with one lost frame each."""
    swb = (oracle.SET_BANDWIDTH, 1104)
    streams = [
        _encode(2, oracle.APP_VOIP, 32000, seed=3,
                ctl=((oracle.SET_BANDWIDTH, 1103),)),
        _encode(2, oracle.APP_VOIP, 48000, seed=51, ctl=(swb, (4006, 1104))),
    ]
    assert (streams[0][0][0] >> 2) & 1 and streams[0][0][0] >> 3 < 12
    S = len(streams)
    lost = np.zeros((S, F), bool)
    lost[0, 6] = lost[1, 8] = True
    port = OpusStreamPipeline(S, channels=2, device="cpu")
    ref = JaxPipeline(S, channels=2)
    for f in range(F):
        batch = [None if lost[s, f] else streams[s][f] for s in range(S)]
        got = port.step(batch).numpy()
        want = np.asarray(ref.step(batch, 960))
        assert list(port.last_modes) == list(ref.last_modes), f
        for s in range(S):
            err = np.abs(got[s] - want[s]).max()
            assert err < _loss_tol(lost, s, f), (f, s, err)


def test_handover_from_jax_mid_stream(mono):
    """Run the JAX pipeline for 5 frames (a rate switch and a loss among
    them), carry its device state into the port through convert.py, then
    continue both; and the port's state goes back to numpy unchanged."""
    S, K = 5, 5
    ref = JaxPipeline(S)
    port = OpusStreamPipeline(S, device="cpu")

    def batch_of(f):
        batch = frame_batch(mono, S, f, packets=True)
        if f == K - 1:
            batch[0] = None                 # a CELT loss in flight
        return batch

    for f in range(K):
        ref.step(batch_of(f), 960)
        # the port's native stage decodes the same packets, so its
        # host-side state follows along
        port._native.decode(batch_of(f), 960)
    port.state = convert.stream_state_from_numpy(
        synthesis_jax.StreamState(*(np.asarray(v) for v in ref.state)),
        "cpu")
    port.plc_state = convert.plc_state_from_numpy(
        plc_jax.PlcState(*(np.asarray(v) for v in ref.plc_state)), "cpu")
    mixed = convert.MixedState(
        rs_states={r: silk_resampler_jax.Up48State(
            *(np.asarray(v) for v in st)) for r, st in ref.rs_states.items()},
        silk_prev=np.asarray(ref.silk_prev),
        prev_fs=np.asarray(ref.prev_fs), silk_dev_state=None)
    convert.load_mixed_state(port, mixed)
    back = convert.mixed_state_to_numpy(port)
    np.testing.assert_array_equal(back.silk_prev, mixed.silk_prev)
    np.testing.assert_array_equal(back.prev_fs, mixed.prev_fs)
    for r in (8, 12, 16):
        for a, b in zip(back.rs_states[r], mixed.rs_states[r]):
            np.testing.assert_array_equal(a, b)
    for f in range(K, F):
        got = port.step(batch_of(f)).numpy()
        want = np.asarray(ref.step(batch_of(f), 960))
        tol = 5e-3 if f == K else 2e-4      # frame K recovers from the loss
        assert np.abs(got - want).max() < tol, f


def test_mixed_pipeline_arguments():
    with pytest.raises(TypeError):
        OpusStreamPipeline(2)                           # device is required
    with pytest.raises(ValueError, match="must divide the mesh size"):
        OpusStreamPipeline(2, mesh=StreamMesh(["cpu"] * 3), device="cpu")
    with pytest.raises(ValueError, match="mono"):
        OpusStreamPipeline(2, channels=2, silk_synthesis="device",
                           device="cpu")
    pipe = OpusStreamPipeline(2, device="cpu")
    with pytest.raises(ValueError, match="20 ms"):
        pipe.step([b"\x00"] * 2, 480)
    with pytest.raises(ValueError, match="push"):
        pipe.tick()
