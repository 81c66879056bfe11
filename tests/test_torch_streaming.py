"""The stream mesh (parallel/streaming.py) under CeltStreamPipeline on the
CPU: 16 streams over `StreamMesh(["cpu"] * 8)`, two streams a shard, held
to the port's single-device pipeline and to the JAX package's mesh
pipeline on its 8 virtual devices, in the reference's three CELT mesh
cases (tests/test_sharded_plan.py, tests/test_pipeline.py:58); the
per-shard step functions against the single-device ops; and the mesh's
refusals.

Bars: loss-free plan mode 1e-6 to the single-device pipeline and 1e-5 to
the JAX mesh pipeline. Under loss, against the single-device pipeline,
the reference's 1e-5 on every lane, lost or received (a stream's step
does not depend on the batch it shares); against JAX 1e-5 on received
lanes and the reference's 5e-3 concealment bar on concealed and
just-recovered lanes. Non-plan: stream 0 within 2e-4 of the copied
CeltDecoder, every stream within 1e-6 of the single-device pipeline.
"""

import numpy as np
import pytest
import torch

from golden_streams import frame_batch, golden_pcm, load_stereo_celt
from mousiki_tpu.celt import host_native as jax_host_native
from mousiki_tpu.parallel.streaming import make_mesh as jax_make_mesh
from mousiki_tpu.pipeline import CeltStreamPipeline as JaxPipeline
from mousiki_tpu_torch.celt import host_native
from mousiki_tpu_torch.hostcodec.bitstream.packet import parse_packet
from mousiki_tpu_torch.hostcodec.celt.decoder import CeltDecoder
from mousiki_tpu_torch.hostcodec.testing import oracle
from mousiki_tpu_torch.ops import synthesis
from mousiki_tpu_torch.ops.band_exec import (plan_combo_mats,
                                             plan_synthesis_step_plc)
from mousiki_tpu_torch.ops.plc import init_plc_state, make_plc_consts
from mousiki_tpu_torch.celt.modes import MODE
from mousiki_tpu_torch.parallel import streaming
from mousiki_tpu_torch.parallel.streaming import StreamMesh, make_mesh
from mousiki_tpu_torch.pipeline import (SERVING_PROFILE, CeltStreamPipeline,
                                        set_plan_profile)
from torch_threads import one_torch_thread  # noqa: F401

S = 16
MESH = StreamMesh(["cpu"] * 8)
# mesh against single device on the lanes of a stream that has lost a
# packet: the reference's bar (tests/test_sharded_plan.py), as on every
# other lane
TOUCHED_TOL = 1e-5
JAX_CONCEALED_TOL = 5e-3    # the reference's concealment bar


@pytest.fixture(scope="module")
def serving():
    """The serving profile in both host libraries; both restored."""
    set_plan_profile(*SERVING_PROFILE)
    jax_host_native.set_plan_profile(*SERVING_PROFILE)
    try:
        yield load_stereo_celt()
    finally:
        set_plan_profile()
        jax_host_native.set_plan_profile()


def _err(a, b, rows):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.abs(a[rows] - b[rows]).max()) if rows.any() else 0.0


def test_plan_mesh_matches_single_device_and_jax(serving):
    """tests/test_sharded_plan.py:28: 6 loss-free golden frames, here
    through the mesh's decode_stream, which runs step by step (the
    overlap flag has no effect under a mesh)."""
    mesh = CeltStreamPipeline(S, 2, mesh=MESH, use_plan=True, device="cpu")
    single = CeltStreamPipeline(S, 2, use_plan=True, device="cpu")
    ref = JaxPipeline(S, channels=2, use_plan=True, mesh=jax_make_mesh())
    assert len(mesh._shards) == 8 and all(p.S == 2 for p in mesh._shards)
    mesh.overlap_host = True
    everyone = np.ones(S, bool)
    frames = [frame_batch(serving, S, f) for f in range(6)]
    n = 0
    for f, got in enumerate(mesh.decode_stream(iter(frames))):
        batch = frames[f]
        assert got.shape == (S, 960, 2) and got.device.type == "cpu"
        assert _err(got, single.step(batch), everyone) <= 1e-6, f
        assert _err(got, ref.step(batch, 960), everyone) <= 1e-5, f
        assert _err(got, golden_pcm(serving, S, f), everyone) <= 1e-5, f
        n += 1
    assert n == 6
    # the shards on one device share its constants
    assert all(p._cache is mesh._shards[0]._cache for p in mesh._shards)


def test_plan_mesh_with_loss(serving):
    """tests/test_sharded_plan.py:50: 30% loss from frame 2, seed 5; each
    shard conceals on its own lost8 plane."""
    mesh = CeltStreamPipeline(S, 2, mesh=MESH, use_plan=True, device="cpu")
    single = CeltStreamPipeline(S, 2, use_plan=True, device="cpu")
    ref = JaxPipeline(S, channels=2, use_plan=True, mesh=jax_make_mesh())
    rng = np.random.default_rng(5)
    lost = np.zeros((S, 8), bool)
    for f in range(8):
        if f >= 2:
            lost[:, f] = [rng.random() < 0.3 for _ in range(S)]
        batch = frame_batch(serving, S, f, lost[:, f])
        got = mesh.step(batch)
        want, jax_want = single.step(batch), ref.step(batch, 960)
        touched = lost[:, :f + 1].any(axis=1)
        plc = lost[:, f] | (lost[:, f - 1] if f else False)
        assert _err(got, want, ~touched) <= 1e-5, f
        assert _err(got, want, touched) <= TOUCHED_TOL, f
        assert _err(got, jax_want, ~plc) <= 1e-5, f
        assert _err(got, jax_want, plc) <= JAX_CONCEALED_TOL, f
    assert lost.any()
    # a shard without a loss this frame skipped the concealment: its
    # streams' loss counts are back at zero, the lossy ones' are not
    counts = torch.cat([p.plc_state.loss_count for p in mesh._shards])
    assert torch.equal(counts, single.plc_state.loss_count)
    assert torch.equal(counts, torch.from_numpy(
        np.asarray(ref.plc_state.loss_count)).to(counts.dtype))


def _oracle_streams(n_streams, n_frames, bitrate=96000):
    """tests/test_pipeline.py's libopus streams, by the port's copy of the
    oracle (frame payloads, TOC stripped)."""
    if not oracle.available():
        pytest.skip("libopus unavailable")
    streams = []
    for s in range(n_streams):
        enc = oracle.RefEncoder(48000, 2, oracle.APP_RESTRICTED_LOWDELAY)
        enc.ctl_set(oracle.SET_BITRATE, bitrate)
        pcm16 = oracle.float_to_i16(
            oracle.make_test_signal(960 * n_frames, 2, seed=s + 1))
        streams.append([parse_packet(enc.encode(
            pcm16[f * 960:(f + 1) * 960].reshape(-1))).frames[0]
            for f in range(n_frames)])
    return streams


def test_nonplan_mesh_matches_decoder_and_single_device():
    """tests/test_pipeline.py:58: the non-plan path, its descriptor split
    by shard; stream 0 against the copied Python CeltDecoder, every
    stream against the single-device pipeline and the JAX mesh."""
    F = 3
    streams = _oracle_streams(S, F)
    mesh = CeltStreamPipeline(S, 2, use_native=True, mesh=MESH, device="cpu")
    single = CeltStreamPipeline(S, 2, use_native=True, device="cpu")
    ref = JaxPipeline(S, channels=2, use_native=True, mesh=jax_make_mesh())
    dec = CeltDecoder(channels=2, stream_channels=2)
    dec.disable_inv = False
    everyone = np.ones(S, bool)
    for f in range(F):
        batch = [streams[s][f] for s in range(S)]
        got = mesh.step(batch)
        assert np.abs(got[0].numpy() - dec.decode_with_ec(batch[0], 960)) \
            .max() < 2e-4, f
        assert _err(got, single.step(batch), everyone) <= 1e-6, f
        assert _err(got, ref.step(batch, 960), everyone) <= 1e-5, f


def test_mesh_refusals(serving):
    with pytest.raises(ValueError, match="must divide the mesh size"):
        CeltStreamPipeline(S, 2, mesh=StreamMesh(["cpu"] * 3), use_plan=True,
                           device="cpu")
    with pytest.raises(ValueError, match="not in the mesh"):
        CeltStreamPipeline(S, 2, mesh=MESH, use_plan=True, device="cuda:0")
    pipe = CeltStreamPipeline(S, 2, mesh=MESH, use_plan=True, device="cpu")
    frames = [frame_batch(serving, S, f) for f in range(2)]
    with pytest.raises(ValueError, match="not under a mesh"):
        pipe.decode_stream(iter(frames), chunk=2)
    with pytest.raises(ValueError, match="not under a mesh"):
        pipe.decode_frames_scanned(frames)
    # a shard's error names the stream by its global index
    bad = frame_batch(serving, S, 0)
    with pytest.raises(ValueError, match="stream 13: native celt plan"):
        pipe.step(bad[:13] + [b"\x01"] + bad[14:])
    with pytest.raises(ValueError):
        StreamMesh([])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_make_mesh_needs_a_gpu():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_sharded_steps_match_single_device_ops(serving):
    """shard / replicate / gather and the three per-shard steps against
    the single-device ops on the whole batch: each shard's plan arena
    decoded by its own native batch."""
    mesh = StreamMesh(["cpu"] * 4)
    C, N = 2, 960
    consts = streaming.replicate(mesh, lambda d: synthesis.make_consts(N, d))
    assert all(c is consts[0] for c in consts)
    plc_consts = streaming.replicate(
        mesh, lambda d: make_plc_consts(N, MODE.window, d))
    mats = streaming.replicate(mesh, lambda d: plan_combo_mats(C, N, d))
    whole = host_native.NativeCeltHostBatch(S, channels=C)
    shards = [host_native.NativeCeltHostBatch(S // 4, channels=C)
              for _ in range(4)]
    state = synthesis.init_state(S, C, "cpu")
    plc_state = init_plc_state(S, C, "cpu")
    states = streaming.shard(mesh, state)
    plc_states = streaming.shard(mesh, plc_state)
    plain_states = streaming.shard(mesh, state)
    step_plc = streaming.sharded_plan_step_plc(mesh, C, N, n_streams=S)
    step = streaming.sharded_plan_step(mesh, C, N, n_streams=S)
    for f in range(2):
        lost = np.zeros(S, bool)
        lost[5] = f == 1
        batch = frame_batch(serving, S, f, lost)
        arenas, aux, layout = whole.decode_plan_arenas(batch, N)
        backing = torch.from_numpy(arenas["backing"].copy())
        want, state, plc_state = plan_synthesis_step_plc(
            consts[0], plc_consts[0], state, plc_state, backing,
            torch.zeros(S, C, N), mats[0], any_lost=bool(lost.any()),
            channels=C, frame=N, n_streams=S)
        backings, any_lost = [], []
        for k, nat in enumerate(shards):
            a, _, lay = nat.decode_plan_arenas(batch[4 * k:4 * k + 4], N)
            backings.append(torch.from_numpy(a["backing"].copy()))
            any_lost.append(bool(host_native.plane_of(a, lay, "lost8").any()))
        assert any_lost == [False, f == 1, False, False]
        xds = streaming.shard(mesh, torch.zeros(S, C, N))
        pcms, states, plc_states = step_plc(
            consts, plc_consts, states, plc_states, backings, xds, mats,
            any_lost)
        got = streaming.gather(pcms, torch.device("cpu"))
        tol = TOUCHED_TOL if f == 1 else 1e-6
        assert (got - want).abs().max() <= tol, f
        if f == 0:      # the plain plan step: the same without a loss
            plain, plain_states = step(consts, plain_states, backings, xds,
                                       mats)
            plain = streaming.gather(plain, torch.device("cpu"))
            assert (plain - want).abs().max() <= 1e-6, f
    # the non-plan synthesis step over a sharded descriptor
    rng = np.random.default_rng(3)
    desc = synthesis.FrameDesc(
        x=torch.as_tensor(rng.standard_normal((S, C, N)).astype(np.float32)
                          * 0.1),
        band_log_e=torch.zeros(S, C, 22), transient=torch.arange(S) % 3 == 0,
        silence=torch.zeros(S, dtype=torch.bool),
        pf_pitch=torch.full((S,), 100, dtype=torch.int32),
        pf_gain=torch.full((S,), 0.3),
        pf_tapset=torch.ones(S, dtype=torch.int32))
    want, _ = synthesis.synthesis_step(consts[0], state, desc, n=N)
    pcms, _ = streaming.sharded_synthesis_step(mesh, C, N)(
        consts, streaming.shard(mesh, state), streaming.shard(mesh, desc))
    got = streaming.gather(pcms, torch.device("cpu"))
    assert (got - want).abs().max() <= 1e-5
