"""The port's NativeCeltEncoderBatch (its own build of csrc/celt_host.cpp)
against the JAX package's on the same spectra and parameters: packets and
tapset decisions byte-equal over 8 frames."""

import numpy as np
import pytest
import torch

from mousiki_tpu.celt import host_native as jax_host_native
from mousiki_tpu.testing import oracle
from mousiki_tpu_torch.celt import host_native
from mousiki_tpu_torch.ops import encode_front as front
from torch_threads import one_torch_thread  # noqa: F401

S, FRAMES = 3, 8


def _front_outputs(channels, nbytes):
    """Real encoder inputs: the port's front on seeded music, with a click
    in one stream so that both block sizes occur."""
    rng = np.random.default_rng(21)
    sigs = [oracle.make_test_signal(960 * FRAMES, channels, seed=s)
            for s in range(S)]
    sigs[1][2000:2120] += 0.5 * rng.standard_normal((120, channels)) \
        .astype(np.float32)
    consts = front.make_front_consts(960, "cpu")
    state = front.init_front_state(S, channels, 960, "cpu")
    nby = torch.full((S,), nbytes, dtype=torch.int32)
    frames = []
    for f in range(FRAMES):
        pcm = np.clip(np.stack([sig[f * 960:(f + 1) * 960] for sig in sigs]),
                      -0.95, 0.95)
        out, state = front.front_step(
            consts, state, torch.from_numpy(pcm), nby,
            torch.zeros((S,), dtype=torch.int32))
        host = {k: v.numpy() for k, v in out.items()}
        iparams = np.zeros((S, 6), np.int32)
        for col, key in enumerate(("silence", "pf_on", "pitch_index", "qg",
                                   "is_transient")):
            iparams[:, col] = host[key]
        iparams[:, 5] = nbytes
        fparams = np.stack([host["tone_freq"], host["toneishness"],
                            host["tf_estimate"]], axis=1)
        frames.append((host["freq"], iparams, fparams))
    return frames


@pytest.mark.parametrize("channels,nbytes", [(1, 160), (2, 320)])
def test_native_encoder_equals_jax_packages(channels, nbytes):
    if jax_host_native._load() is None:
        pytest.skip("the JAX package's native library did not build")
    got_enc = host_native.NativeCeltEncoderBatch(S, channels=channels)
    want_enc = jax_host_native.NativeCeltEncoderBatch(S, channels=channels)
    transients = 0
    for freq, iparams, fparams in _front_outputs(channels, nbytes):
        np.testing.assert_array_equal(got_enc.tapsets(), want_enc.tapsets())
        got = got_enc.encode(freq, iparams, fparams, 960)
        want = want_enc.encode(freq, iparams, fparams, 960)
        assert got == want
        assert all(p is not None and len(p) == nbytes for p in got)
        transients += int(iparams[:, 4].sum())
    assert transients >= 1
    np.testing.assert_array_equal(got_enc.tapsets(), want_enc.tapsets())
    assert got_enc.tapsets().dtype == np.int32


def test_native_encoder_checks_shapes():
    enc = host_native.NativeCeltEncoderBatch(2, channels=2)
    with pytest.raises(ValueError):
        enc.encode(np.zeros((2, 1, 960), np.float32),
                   np.zeros((2, 6), np.int32), np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError):
        enc.encode(np.zeros((2, 2, 960), np.float32),
                   np.zeros((2, 5), np.int32), np.zeros((2, 3), np.float32))
