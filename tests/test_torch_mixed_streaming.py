"""The stream mesh under OpusStreamPipeline on the CPU: 16 streams of
mixed SILK / CELT / hybrid packets over `StreamMesh(["cpu"] * 8)`, held
to the port's single-device pipeline and to the JAX package's mesh
pipeline on its 8 virtual devices in the reference's two mixed mesh cases
(tests/test_pipeline.py:727 with loss, :907 with device SILK), with
fewer frames; fec_packets and the push/tick feeder against the
single-device pipeline; and the mesh's refusals. The packets come from
libopus through the port's copy of the oracle.

Bars: against the single-device pipeline the reference's 1e-5 on every
lane, lost or received (a stream's step does not depend on the batch it
shares); against JAX 1e-5 on received lanes and the reference's 5e-3
concealment bar on concealed and just-recovered lanes. The feeder
and FEC paths are held to the single-device pipeline alike.
"""

import numpy as np
import pytest
import torch

from mousiki_tpu.parallel.streaming import make_mesh as jax_make_mesh
from mousiki_tpu.pipeline import OpusStreamPipeline as JaxPipeline
from mousiki_tpu_torch.hostcodec.testing import oracle
from mousiki_tpu_torch.parallel.streaming import StreamMesh
from mousiki_tpu_torch.pipeline import OpusStreamPipeline
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(not oracle.available(),
                                reason="libopus unavailable")

S = 16
MESH = StreamMesh(["cpu"] * 8)
# mesh against single device on the lanes of a stream that has lost a
# packet: the reference's bar (tests/test_pipeline.py), as on every other
# lane
TOUCHED_TOL = 1e-5
JAX_CONCEALED_TOL = 5e-3    # the reference's concealment bar


def _encode(app, bitrate, n, seed, bw=None, frame=960, ctl=()):
    """n packets of `frame` samples of the oracle's mono test signal."""
    pcm16 = oracle.float_to_i16(
        oracle.make_test_signal(frame * (n + 1), 1, seed=seed))
    enc = oracle.RefEncoder(48000, 1, app)
    enc.ctl_set(oracle.SET_BITRATE, bitrate)
    if bw is not None:
        enc.ctl_set(oracle.SET_BANDWIDTH, bw)
    for key, value in ctl:
        enc.ctl_set(key, value)
    return [enc.encode(pcm16[f * frame:(f + 1) * frame].reshape(-1))
            for f in range(n)]


def _err(a, b, rows):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b.numpy() if isinstance(b, torch.Tensor) else b)
    return float(np.abs(a[rows] - b[rows]).max()) if rows.any() else 0.0


def test_mixed_mesh_with_loss():
    """tests/test_pipeline.py:727: CELT, SILK WB, hybrid SWB and SILK MB
    streams with 15% loss (seed 31); 5 frames where the reference runs
    10."""
    F = 5
    rng = np.random.default_rng(31)
    base = [_encode(oracle.APP_RESTRICTED_LOWDELAY, 96000, F, 33),
            _encode(oracle.APP_VOIP, 16000, F, 33, 1103),
            _encode(oracle.APP_VOIP, 40000, F, 33, 1104),
            _encode(oracle.APP_VOIP, 12000, F, 33, 1102)]
    streams = [base[s % 4] for s in range(S)]
    lost = rng.random((S, F)) < 0.15
    lost[:, 0] = False
    mesh = OpusStreamPipeline(S, mesh=MESH, device="cpu")
    single = OpusStreamPipeline(S, device="cpu")
    ref = JaxPipeline(S, mesh=jax_make_mesh())
    seen = set()
    for f in range(F):
        batch = [None if lost[s, f] else streams[s][f] for s in range(S)]
        got = mesh.step(batch)
        want, jax_want = single.step(batch), ref.step(batch, 960)
        assert got.shape == (S, 960, 1)
        assert list(mesh.last_modes) == list(single.last_modes) \
            == list(ref.last_modes), f
        seen |= set(int(m) for m in mesh.last_modes)
        touched = lost[:, :f + 1].any(axis=1)
        plc = lost[:, f] | (lost[:, f - 1] if f else False)
        assert _err(got, want, ~touched) <= 1e-5, f
        assert _err(got, want, touched) <= TOUCHED_TOL, f
        assert _err(got, jax_want, ~plc) <= 1e-5, f
        assert _err(got, jax_want, plc) <= JAX_CONCEALED_TOL, f
    assert lost.any() and 3 in seen        # losses, concealed


def test_mixed_mesh_device_silk():
    """tests/test_pipeline.py:907: device SILK under the mesh (SILK WB and
    CELT streams); 4 frames where the reference runs 8. A SILK loss in the
    last shard raises with the stream's global index."""
    F = 4
    base = [_encode(oracle.APP_VOIP, 16000, F, 71, 1103),
            _encode(oracle.APP_RESTRICTED_LOWDELAY, 96000, F, 71)]
    streams = [base[s % 2] for s in range(S)]
    mesh = OpusStreamPipeline(S, mesh=MESH, silk_synthesis="device",
                              device="cpu")
    single = OpusStreamPipeline(S, silk_synthesis="device", device="cpu")
    ref = JaxPipeline(S, mesh=jax_make_mesh(), silk_synthesis="device")
    everyone = np.ones(S, bool)
    for f in range(F):
        batch = [streams[s][f] for s in range(S)]
        got = mesh.step(batch)
        assert _err(got, single.step(batch), everyone) <= 1e-5, f
        assert _err(got, ref.step(batch, 960), everyone) <= 1e-5, f
        assert list(mesh.last_modes) == list(single.last_modes)
    assert list(mesh.last_modes[::2]) == [5] * (S // 2)
    batch = [streams[s][0] for s in range(S)]
    batch[14] = None
    with pytest.raises(ValueError, match="stream 14 lost a frame"):
        mesh.step(batch)


def test_mixed_mesh_fec_matches_single_device():
    """fec_packets go to the shard that holds their stream: SILK streams
    with in-band FEC lose frame 2, in every shard, and are recovered from
    the next packet's LBRR (mode 4); CELT losses are concealed."""
    F = 4
    lbrr = _encode(oracle.APP_VOIP, 28000, F, 31, 1103,
                   ctl=((oracle.SET_INBAND_FEC, 1),
                        (oracle.SET_PACKET_LOSS_PERC, 20)))
    celt = _encode(oracle.APP_RESTRICTED_LOWDELAY, 96000, F, 31)
    streams = [lbrr if s % 2 else celt for s in range(S)]
    mesh = OpusStreamPipeline(S, mesh=MESH, device="cpu")
    single = OpusStreamPipeline(S, device="cpu")
    for f in range(F - 1):
        lost = np.zeros(S, bool)
        if f == 2:
            lost[1::2] = True
            lost[4] = True
        batch = [None if lost[s] else streams[s][f] for s in range(S)]
        nxt = [streams[s][f + 1] if lost[s] else None for s in range(S)]
        got = mesh.step(batch, fec_packets=nxt)
        want = single.step(batch, fec_packets=nxt)
        assert list(mesh.last_modes) == list(single.last_modes), f
        assert _err(got, want, ~lost) <= 1e-5, f
        assert _err(got, want, lost) <= TOUCHED_TOL, f
    assert list(mesh.last_modes[1::2]) == [4] * (S // 2)
    assert mesh.last_modes[4] == 3


def test_mixed_mesh_feeder_matches_single_device():
    """push/tick under the mesh: 40 and 60 ms SILK frames, 10 ms SILK pairs
    and two-frame CELT packets, spread over every shard, decoded by the
    native batch of the shard that holds the stream."""
    wb, nb = 1103, 1101
    kinds = [_encode(oracle.APP_VOIP, 16000, 2, 5, wb, frame=1920),
             _encode(oracle.APP_VOIP, 12000, 1, 5, nb, frame=2880),
             _encode(oracle.APP_RESTRICTED_LOWDELAY, 96000, 2, 5,
                     frame=1920),
             _encode(oracle.APP_VOIP, 20000, 6, 5, wb, frame=480)]
    assert kinds[2][0][0] & 3 != 0          # a two-frame CELT packet
    mesh = OpusStreamPipeline(S, mesh=MESH, device="cpu")
    single = OpusStreamPipeline(S, device="cpu")
    for s in range(S):
        for packet in kinds[(s + s // 4) % 4]:
            mesh.push(s, packet)
            single.push(s, packet)
    everyone = np.ones(S, bool)
    for t in range(3):
        got, want = mesh.tick(), single.tick()
        assert list(mesh.last_modes) == list(single.last_modes), t
        assert _err(got, want, everyone) <= 1e-5, t


def test_mixed_mesh_refusals():
    with pytest.raises(ValueError, match="must divide the mesh size"):
        OpusStreamPipeline(S, mesh=StreamMesh(["cpu"] * 3), device="cpu")
    with pytest.raises(ValueError, match="not in the mesh"):
        OpusStreamPipeline(S, mesh=MESH, device="cuda:1")
    with pytest.raises(ValueError, match="mono"):
        OpusStreamPipeline(S, channels=2, mesh=MESH,
                           silk_synthesis="device", device="cpu")
    pipe = OpusStreamPipeline(S, mesh=MESH, device="cpu")
    with pytest.raises(ValueError, match="20 ms"):
        pipe.step([b"\x00"] * S, 480)
    with pytest.raises(ValueError, match="push"):
        pipe.tick()
