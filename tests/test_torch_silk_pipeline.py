"""The port's SilkStreamPipeline on the CPU against the JAX package's, on
the committed golden SILK payloads (16 and 8 kHz internal rate, 20 ms).

Bars: host synthesis within 1e-5 of the JAX pipeline (the native pcm is
bit-equal; only the resampler's fp32 sum order differs); device synthesis
within 1e-4 of the JAX device pipeline; device against host synthesis
above 45 dB SNR, the bar of test_pipeline.py's device-synthesis test.
"""

import numpy as np
import pytest
import torch

from golden_streams import load_mono_mix
from mousiki_tpu.pipeline import SilkStreamPipeline as JaxSilkPipeline
from mousiki_tpu_torch.pipeline import SilkStreamPipeline
from torch_threads import one_torch_thread  # noqa: F401

S, F = 2, 12


@pytest.fixture(scope="module")
def silk():
    mono = load_mono_mix()
    return {16: mono[1].payloads, 8: mono[2].payloads}


@pytest.mark.parametrize("khz", [16, 8])
def test_silk_pipeline_matches_jax(silk, khz):
    host = SilkStreamPipeline(S, fs_khz=khz, device="cpu")
    dev = SilkStreamPipeline(S, fs_khz=khz, synthesis="device", device="cpu")
    ref_host = JaxSilkPipeline(S, fs_khz=khz)
    ref_dev = JaxSilkPipeline(S, fs_khz=khz, synthesis="device")
    got_h, got_d = [], []
    for f in range(F):
        batch = [silk[khz][f]] * S
        h, d = host.step(batch), dev.step(batch)
        assert h.shape == (S, 960) and h.dtype == torch.float32
        want_h = np.asarray(ref_host.step(batch))
        want_d = np.asarray(ref_dev.step(batch))
        assert np.abs(h.numpy() - want_h).max() <= 1e-5, f
        assert np.abs(d.numpy() - want_d).max() <= 1e-4, f
        got_h.append(h[0].numpy())
        got_d.append(d[0].numpy())
    a, b = np.concatenate(got_h), np.concatenate(got_d)
    snr = 10 * np.log10((a ** 2).mean() / ((a - b) ** 2).mean() + 1e-12)
    assert snr > 45.0, snr


def test_silk_pipeline_arguments():
    with pytest.raises(TypeError):
        SilkStreamPipeline(2)                           # device is required
    with pytest.raises(ValueError, match="8/12/16"):
        SilkStreamPipeline(2, fs_khz=24, device="cpu")
    with pytest.raises(ValueError, match="synthesis"):
        SilkStreamPipeline(2, synthesis="tpu", device="cpu")
    with pytest.raises(ValueError, match="20 ms"):
        SilkStreamPipeline(2, frame_ms=40, synthesis="device", device="cpu")
    pipe = SilkStreamPipeline(2, device="cpu")
    with pytest.raises(ValueError, match="payloads"):
        pipe.step([b""])
