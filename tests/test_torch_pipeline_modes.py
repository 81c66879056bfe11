"""CeltStreamPipeline (mousiki_tpu_torch): the stream modes (overlap_host,
chunks, the scanned decode) equal to stepped output, and the non-plan
path against the plan path and the JAX package at every frame size
(split from tests/test_torch_pipeline.py so that the tier-1 suite's
files stay short).
"""

import numpy as np
import pytest
import torch

from golden_streams import frame_batch
from mousiki_tpu.pipeline import CeltStreamPipeline as JaxPipeline
from mousiki_tpu_torch.pipeline import CeltStreamPipeline
from test_torch_pipeline import (_encoded_frames,  # noqa: F401
                                 _loss_pattern, _stepped, serving)
from torch_threads import one_torch_thread  # noqa: F401


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
