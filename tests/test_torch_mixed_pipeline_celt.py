"""OpusStreamPipeline (mousiki_tpu_torch) against the JAX package's: an
all-CELT batch, stereo SILK and hybrid, and a hand-over of the state
from the JAX pipeline mid-stream (split from
tests/test_torch_mixed_pipeline.py so that the tier-1 suite's files stay
short).
"""

import numpy as np

from golden_streams import frame_batch, golden_pcm
from mousiki_tpu.ops import plc_jax, silk_resampler_jax, synthesis_jax
from mousiki_tpu.pipeline import OpusStreamPipeline as JaxPipeline
from mousiki_tpu.testing import oracle
from mousiki_tpu_torch import convert
from mousiki_tpu_torch.pipeline import OpusStreamPipeline
from test_torch_mixed_pipeline import (F, GOLDEN_TOL,  # noqa: F401
                                       JAX_TOL, _encode, _loss_tol, mono,
                                       needs_oracle)
from torch_threads import one_torch_thread  # noqa: F401


def test_all_celt_batch_matches_jax_and_golden(mono):
    """A batch no SILK stream rides: the resamplers run on zero rows and
    add nothing to the CELT output."""
    S = 2
    celt = [mono[0]]
    port = OpusStreamPipeline(S, device="cpu")
    ref = JaxPipeline(S)
    for f in range(4):
        batch = frame_batch(celt, S, f, packets=True)
        got = port.step(batch).numpy()
        want = np.asarray(ref.step(batch, 960))
        assert list(port.last_modes) == [0, 0]
        assert np.abs(got - want).max() <= JAX_TOL, f
        assert np.abs(got - golden_pcm(celt, S, f)).max() <= GOLDEN_TOL, f


@needs_oracle
def test_stereo_silk_and_hybrid_match_jax():
    """Stereo SILK and stereo hybrid packets (joint mid/side decode on the
    native host), with one lost frame each."""
    swb = (oracle.SET_BANDWIDTH, 1104)
    streams = [
        _encode(2, oracle.APP_VOIP, 32000, seed=3,
                ctl=((oracle.SET_BANDWIDTH, 1103),)),
        _encode(2, oracle.APP_VOIP, 48000, seed=51, ctl=(swb, (4006, 1104))),
    ]
    assert (streams[0][0][0] >> 2) & 1 and streams[0][0][0] >> 3 < 12
    S = len(streams)
    lost = np.zeros((S, F), bool)
    lost[0, 6] = lost[1, 8] = True
    port = OpusStreamPipeline(S, channels=2, device="cpu")
    ref = JaxPipeline(S, channels=2)
    for f in range(F):
        batch = [None if lost[s, f] else streams[s][f] for s in range(S)]
        got = port.step(batch).numpy()
        want = np.asarray(ref.step(batch, 960))
        assert list(port.last_modes) == list(ref.last_modes), f
        for s in range(S):
            err = np.abs(got[s] - want[s]).max()
            assert err < _loss_tol(lost, s, f), (f, s, err)


def test_handover_from_jax_mid_stream(mono):
    """Run the JAX pipeline for 5 frames (a rate switch and a loss among
    them), carry its device state into the port through convert.py, then
    continue both; and the port's state goes back to numpy unchanged."""
    S, K = 5, 5
    ref = JaxPipeline(S)
    port = OpusStreamPipeline(S, device="cpu")

    def batch_of(f):
        batch = frame_batch(mono, S, f, packets=True)
        if f == K - 1:
            batch[0] = None                 # a CELT loss in flight
        return batch

    for f in range(K):
        ref.step(batch_of(f), 960)
        # the port's native stage decodes the same packets, so its
        # host-side state follows along
        port._native.decode(batch_of(f), 960)
    port.state = convert.stream_state_from_numpy(
        synthesis_jax.StreamState(*(np.asarray(v) for v in ref.state)),
        "cpu")
    port.plc_state = convert.plc_state_from_numpy(
        plc_jax.PlcState(*(np.asarray(v) for v in ref.plc_state)), "cpu")
    mixed = convert.MixedState(
        rs_states={r: silk_resampler_jax.Up48State(
            *(np.asarray(v) for v in st)) for r, st in ref.rs_states.items()},
        silk_prev=np.asarray(ref.silk_prev),
        prev_fs=np.asarray(ref.prev_fs), silk_dev_state=None)
    convert.load_mixed_state(port, mixed)
    back = convert.mixed_state_to_numpy(port)
    np.testing.assert_array_equal(back.silk_prev, mixed.silk_prev)
    np.testing.assert_array_equal(back.prev_fs, mixed.prev_fs)
    for r in (8, 12, 16):
        for a, b in zip(back.rs_states[r], mixed.rs_states[r]):
            np.testing.assert_array_equal(a, b)
    for f in range(K, F):
        got = port.step(batch_of(f)).numpy()
        want = np.asarray(ref.step(batch_of(f), 960))
        tol = 5e-3 if f == K else 2e-4      # frame K recovers from the loss
        assert np.abs(got - want).max() < tol, f
