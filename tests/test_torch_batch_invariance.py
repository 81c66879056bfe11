"""A stream's decode step does not depend on the batch it shares
(ROADMAP hazard g): the same streams through the port's stream decoders
as one batch of 16 and as 8 batches of 2 and as batches of 5 + 11, on
the CPU, every lane and every stage of the step compared
(batch_stages.py), and the concealment's pitch decisions held to the JAX
package's on the same decoder memory.

Paths: CeltStreamPipeline in plan mode on the three golden stereo
streams, 8 frames, 30% loss from frame 2 (seed 5, as
tests/test_torch_streaming.py draws it); OpusStreamPipeline on the five
golden mono streams (CELT, SILK 16 and 8 kHz, two hybrid), 6 frames,
15% loss from frame 1 (seed 31); and its device-SILK lane,
loss-free, 4 frames, as 5 + 11 only (eight pipelines of 2 cost eight
steps a frame on the CPU).

Bars: every lane within the reference's 1e-5 of the whole batch's PCM
(tests/test_sharded_plan.py); every float stage within STAGE_TOL of the
whole batch's, relative to the stage's largest value; integer stages
(the pitch) equal; the port's pitch equal to the JAX package's on every
stream of every lossy frame.
"""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest

from batch_stages import lossy_frames, split_errors
from golden_streams import frame_batch, load_mono_mix, load_stereo_celt
from mousiki_tpu.ops import plc_jax
from mousiki_tpu_torch.ops import plc
from mousiki_tpu_torch.pipeline import (SERVING_PROFILE, CeltStreamPipeline,
                                        OpusStreamPipeline, set_plan_profile)
from torch_threads import one_torch_thread  # noqa: F401

S = 16
SPLITS = {"8x2": (2,) * 8, "5+11": (5, 11)}
PCM_TOL = 1e-5
# float64 sums in different orders round alike to float32 but for rare
# ties, which on a value near zero differ by one of its ulps: far under
# one ulp of the stage's largest value (6e-8), which is where a float32
# product of another batch size differs
STAGE_TOL = 1e-9


def _celt():
    frames, lost = lossy_frames(partial(frame_batch, load_stereo_celt()), S,
                                8, 0.3, 5, 2)
    return frames, lost, lambda n: CeltStreamPipeline(n, 2, use_plan=True,
                                                      device="cpu")


def _mixed():
    frames, lost = lossy_frames(
        partial(frame_batch, load_mono_mix(), packets=True), S, 6, 0.15, 31,
        1)
    return frames, lost, lambda n: OpusStreamPipeline(n, channels=1,
                                                      device="cpu")


def _device_silk():
    frames, lost = lossy_frames(
        partial(frame_batch, load_mono_mix(), packets=True), S, 4, 0.0, 0, 4)
    return frames, lost, lambda n: OpusStreamPipeline(
        n, channels=1, silk_synthesis="device", device="cpu")


# each path and the splits it is run as
PATHS = {"celt": (_celt, SPLITS), "mixed": (_mixed, SPLITS),
         "device_silk": (_device_silk, {"5+11": SPLITS["5+11"]})}


@pytest.fixture(scope="module")
def runs():
    """Each path's split comparison, run once, on demand."""
    set_plan_profile(*SERVING_PROFILE)
    done = {}

    def get(path):
        if path not in done:
            setup, splits = PATHS[path]
            frames, lost, make = setup()
            done[path] = (split_errors(make, frames, S, splits), lost)
        return done[path]

    try:
        yield get
    finally:
        set_plan_profile()


CASES = [(path, split) for path, (_, splits) in PATHS.items()
         for split in splits]


@pytest.mark.parametrize("path,split", CASES)
def test_every_lane_matches_the_whole_batch(runs, path, split):
    res, lost = runs(path)
    if path != "device_silk":
        assert lost.any()
    assert res[split]["pcm"] <= PCM_TOL, res[split]


@pytest.mark.parametrize("path,split", CASES)
def test_every_stage_matches_the_whole_batch(runs, path, split):
    res, _ = runs(path)
    stages = dict(res[split]["stages"])
    want = {"x_plane", "imdct", "comb_filter", "pcm"}
    want |= ({"up48"} if path != "celt" else set())
    want |= ({"silk_synthesis"} if path == "device_silk" else
             {"pitch", "lpc", "excitation", "extension", "plc_freq"})
    assert want <= set(stages), sorted(stages)
    assert stages.pop("pitch", 0.0) == 0, res[split]
    assert max(stages.values()) <= STAGE_TOL, res[split]


@pytest.mark.parametrize("path", ["celt", "mixed"])
def test_plc_pitches_match_jax(runs, path):
    """hazard e: the float64 correlation must not flip a pitch against
    the JAX package's float32 one, on any stream of any lossy frame."""
    res, lost = runs(path)
    frames = [f for f in range(lost.shape[1]) if lost[:, f].any()]
    assert frames
    for f in frames:
        mem = res["decode_mem"][f]
        got = plc._pitch_search(mem).numpy()
        want = np.asarray(plc_jax._pitch_search(jnp.asarray(mem.numpy())))
        np.testing.assert_array_equal(got, want, err_msg=f"frame {f}")
