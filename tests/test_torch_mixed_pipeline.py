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

The device-SILK lane, the feeder and the three SILK rates are in
tests/test_torch_mixed_pipeline_silk.py, the all-CELT batch, stereo SILK
/ hybrid and the hand-over in tests/test_torch_mixed_pipeline_celt.py.
(Split so that each of the port's test files holds at most 8 cases: the
tier-1 suite then starts its longest file early.)
"""

import numpy as np
import pytest
import torch

from golden_streams import (MIX_GOLDEN_FROM, frame_batch, golden_pcm,
                            load_mono_mix, load_stereo_celt)
from mousiki_tpu.pipeline import OpusStreamPipeline as JaxPipeline
from mousiki_tpu.testing import oracle
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
