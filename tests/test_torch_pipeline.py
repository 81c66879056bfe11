"""The port's CeltStreamPipeline end to end on the CPU: against the
committed golden PCM, against the JAX plan pipeline under packet loss,
continuing a JAX pipeline's decode mid-stream, and its other modes (host
overlap, chunks, the scanned decode, the non-plan path) against its own
stepped plan output, the Python host (use_native=False) against the JAX
package's, and the constructor's arguments against the reference's.

Bars: 1e-5 to the golden PCM (the JAX pipeline reaches 5.1e-7 there);
against the JAX pipeline 5e-3 on lost and just-recovered frames and 2e-4
elsewhere, the bars of test_pipeline.py's packet-loss test; overlapped,
chunked and scanned output equal to stepped output exactly; the non-plan
path within 2e-4 of plan mode and 1e-5 of the JAX non-plan pipeline.
"""


import numpy as np
import pytest
import torch

from golden_streams import frame_batch, golden_pcm, load_stereo_celt
from mousiki_tpu.celt import host_native as jax_host_native
from mousiki_tpu.ops import plc_jax, synthesis_jax
from mousiki_tpu.pipeline import CeltStreamPipeline as JaxPipeline
from mousiki_tpu_torch import convert
from mousiki_tpu_torch.pipeline import (SERVING_PROFILE, CeltStreamPipeline,
                                        set_plan_profile)
from torch_threads import one_torch_thread  # noqa: F401

GOLDEN_TOL = 1e-5


@pytest.fixture(scope="module")
def serving():
    """The serving profile in both host libraries (the port's and the JAX
    package's keep separate profiles); both restored afterwards."""
    set_plan_profile(*SERVING_PROFILE)
    jax_host_native.set_plan_profile(*SERVING_PROFILE)
    try:
        yield load_stereo_celt()
    finally:
        set_plan_profile()
        jax_host_native.set_plan_profile()


def _loss_pattern(S, F, seed):
    rng = np.random.default_rng(seed)
    lost = rng.random((S, F)) < 0.12
    lost[:, 0] = False                      # prime with a real frame
    lost[1, 5:7] = True                     # a 2-frame burst
    return lost


def _tol(lost, s, f):
    return 5e-3 if (lost[s, f] or (f and lost[s, f - 1])) else 2e-4


def test_pipeline_matches_golden_pcm(serving):
    S = 3
    pipe = CeltStreamPipeline(S, channels=2, use_plan=True, device="cpu")
    for f in range(12):
        pcm = pipe.step(frame_batch(serving, S, f), 960)
        assert pcm.shape == (S, 960, 2) and pcm.dtype == torch.float32
        err = np.abs(pcm.numpy() - golden_pcm(serving, S, f)).max()
        assert err <= GOLDEN_TOL, (f, err)


def test_decode_stream_matches_step(serving):
    S, F = 3, 4
    stepped = CeltStreamPipeline(S, use_plan=True, device="cpu")
    want = [stepped.step(frame_batch(serving, S, f)) for f in range(F)]
    streamed = CeltStreamPipeline(S, use_plan=True, device="cpu")
    got = list(streamed.decode_stream(frame_batch(serving, S, f)
                                      for f in range(F)))
    assert len(got) == F
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_pipeline_with_loss_matches_jax(serving):
    S, F = 4, 8
    lost = _loss_pattern(S, F, seed=5)
    port = CeltStreamPipeline(S, use_plan=True, device="cpu")
    ref = JaxPipeline(S, channels=2, use_plan=True)
    for f in range(F):
        batch = frame_batch(serving, S, f, lost[:, f])
        got = port.step(batch).numpy()
        want = np.asarray(ref.step(batch, 960))
        for s in range(S):
            err = np.abs(got[s] - want[s]).max()
            assert err < _tol(lost, s, f), (f, s, err, bool(lost[s, f]))
    assert (convert.plc_state_to_numpy(port.plc_state).loss_count
            == np.asarray(ref.plc_state.loss_count)).all()


def test_handover_from_jax_mid_stream(serving):
    """Run the JAX pipeline for 4 frames, carry its device state into the
    port, then continue both."""
    S, F, K = 4, 8, 4
    lost = _loss_pattern(S, F, seed=9)
    lost[2, K - 1] = True                   # a loss in flight at handover
    ref = JaxPipeline(S, channels=2, use_plan=True)
    port = CeltStreamPipeline(S, use_plan=True, device="cpu")
    for f in range(K):
        batch = frame_batch(serving, S, f, lost[:, f])
        ref.step(batch, 960)
        # the port's native symbol stage decodes the same packets, so its
        # host-side state (energies, range coder seed) follows along
        port._native.decode_plan_arenas(batch, 960)
    port.state = convert.stream_state_from_numpy(
        synthesis_jax.StreamState(*(np.asarray(v) for v in ref.state)),
        "cpu")
    port.plc_state = convert.plc_state_from_numpy(
        plc_jax.PlcState(*(np.asarray(v) for v in ref.plc_state)), "cpu")
    for f in range(K, F):
        batch = frame_batch(serving, S, f, lost[:, f])
        got = port.step(batch).numpy()
        want = np.asarray(ref.step(batch, 960))
        for s in range(S):
            err = np.abs(got[s] - want[s]).max()
            assert err < _tol(lost, s, f), (f, s, err, bool(lost[s, f]))


def test_short_frames_match_jax():
    """2.5 ms frames (LM 0, which keeps the one-frame-delayed postfilter
    state), freshly encoded by libopus, one stream losing a packet."""
    from mousiki_tpu.bitstream.packet import parse_packet
    from mousiki_tpu.testing import oracle
    if not oracle.available():
        pytest.skip("libopus oracle unavailable")
    S, F, frame = 2, 6, 120
    enc = oracle.RefEncoder(48000, 2, oracle.APP_RESTRICTED_LOWDELAY)
    enc.ctl_set(oracle.SET_BITRATE, 96000)
    pcm16 = oracle.float_to_i16(
        oracle.make_test_signal(frame * (F + 2), 2, seed=4))
    pays = [parse_packet(enc.encode(
        pcm16[f * frame:(f + 1) * frame].reshape(-1), frame)).frames[0]
        for f in range(F)]
    lost = np.zeros((S, F), bool)
    lost[1, 3] = True
    port = CeltStreamPipeline(S, use_plan=True, device="cpu")
    ref = JaxPipeline(S, channels=2, use_plan=True)
    for f in range(F):
        batch = [None if lost[s, f] else pays[f] for s in range(S)]
        got = port.step(batch, frame).numpy()
        want = np.asarray(ref.step(batch, frame))
        assert got.shape == (S, frame, 2)
        for s in range(S):
            err = np.abs(got[s] - want[s]).max()
            assert err < _tol(lost, s, f), (f, s, err)


def _stepped(streams, S, F, lost):
    pipe = CeltStreamPipeline(S, use_plan=True, device="cpu")
    return [pipe.step(frame_batch(streams, S, f, lost[:, f]))
            for f in range(F)]


@pytest.mark.parametrize("mode", ["overlap_host", "chunk4", "chunk3",
                                  "scanned"])
def test_stream_modes_equal_stepped_output(serving, mode):
    """The threaded overlap (two arenas), the chunked stream (10 frames in
    chunks of 4 or 3, so the last chunk is short) and the scanned decode
    give the stepped output exactly, with lost packets among the frames."""
    S, F = 3, 10
    lost = _loss_pattern(S, F, seed=3)
    want = _stepped(serving, S, F, lost)
    frames = [frame_batch(serving, S, f, lost[:, f]) for f in range(F)]
    pipe = CeltStreamPipeline(S, use_plan=True, device="cpu", host_threads=2)
    if mode == "scanned":
        got = pipe.decode_frames_scanned(frames)
        assert got.shape == (F, S, 960, 2)
    elif mode == "overlap_host":
        pipe.overlap_host = True
        got = list(pipe.decode_stream(iter(frames)))
        ring = pipe._native._plan_db[960][1]
        assert len(ring) == 2
        assert ring[0][0]["backing"] is not ring[1][0]["backing"]
    else:
        got = list(pipe.decode_stream(iter(frames), chunk=int(mode[-1])))
    assert len(got) == F
    for f in range(F):
        assert torch.equal(got[f], want[f]), (mode, f)
    # the streams go on from the same state as the stepped pipeline's
    more = frame_batch(serving, S, 10)
    stepped = CeltStreamPipeline(S, use_plan=True, device="cpu")
    for f in range(F):
        stepped.step(frame_batch(serving, S, f, lost[:, f]))
    assert torch.equal(pipe.step(more), stepped.step(more))


def test_empty_streams_and_chunk_arguments(serving):
    pipe = CeltStreamPipeline(3, use_plan=True, device="cpu")
    assert list(pipe.decode_stream(iter([]))) == []
    assert list(pipe.decode_stream(iter([]), chunk=4)) == []
    with pytest.raises(ValueError, match=">= 1 frame"):
        pipe.decode_frames_scanned([])
    nonplan = CeltStreamPipeline(3, use_plan=False, device="cpu")
    with pytest.raises(ValueError, match="plan mode"):
        list(nonplan.decode_stream(iter([frame_batch(serving, 3, 0)]),
                                   chunk=2))
    with pytest.raises(ValueError, match="no loss concealment"):
        nonplan.step([None] + frame_batch(serving, 3, 0)[1:])
    python = CeltStreamPipeline(3, use_native=False, device="cpu")
    with pytest.raises(ValueError, match="no loss concealment"):
        python.step([None] + frame_batch(serving, 3, 0)[1:])
    with pytest.raises(NotImplementedError, match="mesh"):
        CeltStreamPipeline(3, mesh=object(), device="cpu")


def test_constructor_takes_the_reference_arguments(serving):
    """The reference's order and defaults: (n_streams, channels,
    use_native, mesh, host_threads, use_plan), the default non-plan, and
    plan mode refused with the Python host; device is keyword-only."""
    positional = CeltStreamPipeline(3, 2, True, None, 1, device="cpu")
    assert not positional.use_plan and positional._native is not None
    assert positional._native.n_threads == 1
    default = CeltStreamPipeline(3, device="cpu")
    assert not default.use_plan and default._py_hosts is None
    assert CeltStreamPipeline(3, 2, None, None, 0, True,
                              device="cpu").use_plan
    with pytest.raises(ValueError, match="plan mode requires the native"):
        CeltStreamPipeline(3, use_native=False, use_plan=True, device="cpu")
    with pytest.raises(TypeError):
        CeltStreamPipeline(3, 2, None, None, 0, False, "cpu")
    for ref in (JaxPipeline(3, 2, True), JaxPipeline(3)):
        assert not ref.use_plan and ref._native is not None


def test_python_host_matches_jax_and_native(serving):
    """use_native=False: one copied Python CeltDecoder a stream in front of
    the device synthesis, against the JAX use_native=False pipeline (1e-5)
    and the port's native non-plan path (2e-4), over 4 golden frames."""
    S, F = 2, 4
    python = CeltStreamPipeline(S, 2, use_native=False, device="cpu")
    assert python._native is None and len(python._py_hosts) == S
    native = CeltStreamPipeline(S, 2, device="cpu")
    ref = JaxPipeline(S, 2, use_native=False)
    assert ref._py_hosts is not None
    for f in range(F):
        batch = frame_batch(serving, S, f)
        got = python.step(batch)
        assert got.shape == (S, 960, 2)
        want = np.asarray(ref.step(batch))
        assert np.abs(got.numpy() - want).max() <= 1e-5, f
        assert (got - native.step(batch)).abs().max() <= 2e-4, f
        assert np.abs(got.numpy() - golden_pcm(serving, S, f)).max() \
            <= 2e-4, f


def _encoded_frames(frame, F):
    """F stereo CELT payloads of `frame` samples from the libopus encoder."""
    from mousiki_tpu.bitstream.packet import parse_packet
    from mousiki_tpu.testing import oracle
    if not oracle.available():
        pytest.skip("libopus oracle unavailable")
    enc = oracle.RefEncoder(48000, 2, oracle.APP_RESTRICTED_LOWDELAY)
    enc.ctl_set(oracle.SET_BITRATE, 96000)
    pcm16 = oracle.float_to_i16(
        oracle.make_test_signal(frame * (F + 2), 2, seed=4))
    return [parse_packet(enc.encode(
        pcm16[f * frame:(f + 1) * frame].reshape(-1), frame)).frames[0]
        for f in range(F)]


@pytest.mark.parametrize("frame", [120, 240, 480, 960])
def test_non_plan_path_matches_plan_and_jax(serving, frame):
    """use_plan=False (the host reconstructs the bands) against plan mode
    (2e-4), stepped and through decode_stream, and at 20 ms against the
    JAX non-plan pipeline (1e-5; that one decodes 20 ms frames only)."""
    S, F = 2, 6
    if frame == 960:
        batches = [frame_batch(serving, S, f) for f in range(F)]
    else:
        batches = [[p] * S for p in _encoded_frames(frame, F)]
    plan = CeltStreamPipeline(S, use_plan=True, device="cpu")
    nonplan = CeltStreamPipeline(S, use_plan=False, device="cpu")
    streamed = CeltStreamPipeline(S, use_plan=False, device="cpu")
    ref = None
    if frame == 960:
        ref = JaxPipeline(S, channels=2, use_native=True, use_plan=False)
    got_stream = list(streamed.decode_stream(iter(batches), frame))
    for f, batch in enumerate(batches):
        got = nonplan.step(batch, frame)
        assert got.shape == (S, frame, 2)
        assert torch.equal(got, got_stream[f])
        assert (got - plan.step(batch, frame)).abs().max() < 2e-4, f
        if ref is not None:
            want = np.asarray(ref.step(batch, frame))
            assert np.abs(got.numpy() - want).max() <= 1e-5, f
