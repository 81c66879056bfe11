"""The port's single-stream OpusDecoder with neural recovery against the
JAX package's: deep PLC concealment, DRED decode, and the deep PLC
shim's device rule (split from tests/test_torch_opus_decoder.py so that
the tier-1 suite's files stay short).
"""

import numpy as np
import pytest
import torch

from golden_streams import load_mono_mix
from mousiki_tpu.models import dred as jax_dred
from mousiki_tpu_torch.hostcodec import opus_decoder
from mousiki_tpu_torch.models import dred as rdovae
from test_torch_opus_decoder import (NEURAL_TOL,  # noqa: F401
                                     _check_periods, _deep_pair,
                                     dred_stream, periods, plc_models)
from torch_threads import one_torch_thread  # noqa: F401


def test_deep_plc_concealment_matches_jax(plc_models, periods):
    """The golden wide-band SILK stream: 5 good packets, 2 lost, 2 good,
    1 lost, each side concealing with FARGAN + PitchDNN."""
    stream = load_mono_mix()[1]
    port, ref = _deep_pair(plc_models)
    pcm = {"port": [], "jax": []}
    for f in range(9):
        pkt = None if f in (5, 6, 8) else stream.packets[f]
        pcm["port"].append(port.decode(pkt, 960))
        pcm["jax"].append(ref.decode(pkt, 960))
        np.testing.assert_array_equal(port.deep_plc.last_features,
                                      ref.deep_plc.last_features)
    _check_periods(periods)
    assert len(periods["port"]) == 3
    for f in (5, 6, 8):
        got, want = pcm["port"][f], pcm["jax"][f]
        assert got.shape == (960, 1) and np.abs(want).max() > 1e-3
        assert np.abs(got - want).max() <= NEURAL_TOL, f
    assert port.deep_plc.loss_count == ref.deep_plc.loss_count == 1


def test_dred_decode_matches_jax(plc_models, dred_stream, periods):
    """tests/test_dred_e2e.py:86-109: packets 8 and 9 lost, the DRED of
    packet 10 parsed, processed and decoded over the gap, packet 10
    decoded after it: features within 1e-4 of their scale, PCM within
    1e-4."""
    pkts, jd, td = dred_stream
    port, ref = _deep_pair(plc_models)
    port.set_dred_models(td, rdovae.synthetic_stats())
    ref.set_dred_models(jd, jax_dred.synthetic_stats())
    for pkt in pkts[:8]:
        np.testing.assert_array_equal(port.decode(pkt, 960),
                                      ref.decode(pkt, 960))
    got, want = port.dred_parse(pkts[10]), ref.dred_parse(pkts[10])
    assert got is not None and want is not None
    np.testing.assert_array_equal(got.state_q, want.state_q)
    fg, fw = np.stack(port.dred_process(got)), np.stack(ref.dred_process(want))
    assert fg.shape == fw.shape == (4 * got.nb_latents, 20)
    scale = max(1.0, float(np.abs(fw).max()))
    assert np.abs(fg - fw).max() <= NEURAL_TOL * scale
    for k in (2, 1):
        a = port.dred_decode(got, dred_offset_10ms=2 * k, frame_size=960)
        b = ref.dred_decode(want, dred_offset_10ms=2 * k, frame_size=960)
        assert a.shape == (960, 1) and np.isfinite(a).all()
        assert np.abs(a - b).max() <= NEURAL_TOL, k
    _check_periods(periods)
    assert len(port.deep_plc.fec_queue) == len(ref.deep_plc.fec_queue)
    a, b = port.decode(pkts[10], 960), ref.decode(pkts[10], 960)
    assert np.abs(a - b).max() <= NEURAL_TOL
    assert port.final_range == ref.final_range


def test_deep_plc_shim_device_rule(plc_models):
    """set_deep_plc builds the state on its FARGAN model's device, else the
    PitchDNN model's; with no model it takes the GPU, and raises where
    there is none."""
    from mousiki_tpu_torch.hostcodec.models import deep_plc as shim
    tp = plc_models[3]
    assert shim.DeepPlcState(pitch_model=tp).device.type == "cpu"
    dec = opus_decoder.OpusDecoder(48000, 1)
    if torch.cuda.is_available():
        dec.set_deep_plc(None)
        assert dec.deep_plc.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dec.set_deep_plc(None)
        assert getattr(dec, "deep_plc", None) is None
