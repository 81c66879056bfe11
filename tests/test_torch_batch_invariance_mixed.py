"""The batch invariance of tests/test_torch_batch_invariance.py on the
mixed path and its device-SILK lane (split from it, the CELT path's
cases staying there, so that the tier-1 suite's files stay short): the
same streams as one batch of 16 and as smaller batches, every lane and
every stage compared, and the concealment's pitch decisions held to the
JAX package's on the same decoder memory.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mousiki_tpu.ops import plc_jax
from mousiki_tpu_torch.ops import plc
from test_torch_batch_invariance import (PCM_TOL,  # noqa: F401
                                         STAGE_TOL, path_cases, runs)
from torch_threads import one_torch_thread  # noqa: F401

CASES = path_cases("mixed", "device_silk")


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


@pytest.mark.parametrize("path", ["mixed"])
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
