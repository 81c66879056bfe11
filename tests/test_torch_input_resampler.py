"""mousiki_tpu_torch.ops.input_resampler against the JAX package's: the
batched device resample (one gather and one strict-fp32 contraction)
within 1e-5 of max|y| of JAX's, and the numpy streaming resampler and
one-shot resample, the reference's own code, equal to it exactly."""

import numpy as np
import pytest
import torch

from mousiki_tpu.ops import input_resampler as jax_rs
from mousiki_tpu_torch.ops import input_resampler as rs
from torch_threads import one_torch_thread  # noqa: F401

RATES = [8000, 16000, 24000, 44100, 96000]


def _signal(rate, n_streams, seconds=0.25, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(rate * seconds)) / rate
    tones = np.stack([np.sin(2 * np.pi * (300 + 400 * s) * t)
                      for s in range(n_streams)])
    return (0.5 * tones + 0.1 * rng.standard_normal(tones.shape)).astype(
        np.float32)


@pytest.mark.parametrize("rate", RATES)
def test_resample_batched_matches_jax(rate):
    x = _signal(rate, 3)
    want = np.asarray(jax_rs.resample_batched(x, rate, 48000, 5))
    got = rs.resample_batched(torch.from_numpy(x), rate, 48000, 5)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("rate", RATES)
def test_streaming_resampler_equals_reference(rate):
    """ArbitraryResampler in uneven chunks, two channels, and the one-shot
    resample_block: the same numbers as the reference's."""
    x = _signal(rate, 2, seed=1).T.astype(np.float64)
    got_rs = rs.ArbitraryResampler(rate, 48000, 2, 5)
    want_rs = jax_rs.ArbitraryResampler(rate, 48000, 2, 5)
    assert got_rs.output_latency == want_rs.output_latency
    for i in range(0, len(x), 777):
        np.testing.assert_array_equal(got_rs.process(x[i:i + 777]),
                                      want_rs.process(x[i:i + 777]))
    np.testing.assert_array_equal(rs.resample_block(x, rate, 48000, 7),
                                  jax_rs.resample_block(x, rate, 48000, 7))
