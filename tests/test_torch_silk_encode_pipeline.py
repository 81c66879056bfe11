"""mousiki_tpu_torch.pipeline.SilkEncodePipeline (S host SILK encoders on
threads, their quantizer calls batched onto the device quantizer): the
case of tests/test_encode_pipeline.py on the port, and the executor with
both quantizers."""

import numpy as np
import pytest
import torch

from mousiki_tpu.testing import oracle
from mousiki_tpu_torch.parallel.nsq_batch import NsqBatchExecutor
from mousiki_tpu_torch.pipeline import OpusStreamPipeline, SilkEncodePipeline
from torch_threads import one_torch_thread  # noqa: F401

S, F = 3, 8


def _signals():
    return [oracle.make_test_signal(960 * (F + 1), 1, seed=10 + s)
            for s in range(S)]


def _best_snr(want, got):
    """SNR at the best delay, past the encoder's warm-up frame."""
    a, b = want[960:], got[960:]
    best = -1e9
    for lag in range(0, 400):
        bb = b[lag:][: len(a) - lag]
        aa = a[: len(bb)]
        best = max(best, 10 * np.log10(
            (aa ** 2).mean() / ((aa - bb) ** 2).mean() + 1e-12))
    return best


@pytest.fixture(scope="module")
def batched_packets():
    sigs = _signals()
    pipe = SilkEncodePipeline(S, bitrate=24000, device="cpu")
    pkts = [[] for _ in range(S)]
    for f in range(F):
        pcm = np.stack([sigs[s][f * 960:(f + 1) * 960, 0] for s in range(S)])
        out = pipe.step(pcm)
        assert len(out) == S
        for s in range(S):
            pkts[s].append(out[s])
    # every wide-band frame went through the device quantizer, one call a
    # round for all streams
    assert F <= pipe._ex.dispatches <= 3 * F
    return sigs, pkts


def test_stream_alone_equals_stream_in_batch(batched_packets):
    """Lane independence: stream 0 alone gives stream 0's packets."""
    sigs, pkts = batched_packets
    solo = SilkEncodePipeline(1, bitrate=24000, device="cpu")
    solo_pkts = [solo.step(torch.from_numpy(
        sigs[0][None, f * 960:(f + 1) * 960, 0].copy()))[0]
        for f in range(F)]
    assert solo_pkts == pkts[0]


@pytest.mark.skipif(not oracle.available(),
                    reason="libopus oracle unavailable")
def test_packets_decode_in_libopus(batched_packets):
    sigs, pkts = batched_packets
    for s in range(S):
        dec = oracle.RefDecoder(48000, 1)
        got = np.concatenate([dec.decode_float(p, 960)[:, 0]
                              for p in pkts[s]])
        best = _best_snr(sigs[s][: len(got), 0], got)
        print(f"stream {s}: {best:.2f} dB in libopus (bar 2)")
        assert best > 2.0, (s, best)   # noise coded at 24 kbit/s: loose


def test_packets_decode_in_the_ports_decoder(batched_packets):
    sigs, pkts = batched_packets
    dec = OpusStreamPipeline(S, channels=1, device="cpu")
    got = np.concatenate(
        [dec.step([pkts[s][f] for s in range(S)]).numpy()[:, :, 0]
         for f in range(F)], axis=1)
    assert got.shape == (S, 960 * F) and np.isfinite(got).all()
    assert set(int(m) for m in dec.last_modes) == {1}        # SILK
    for s in range(S):
        assert _best_snr(sigs[s][: 960 * F, 0], got[s]) > 2.0


@pytest.mark.parametrize("use_del_dec", [True, False])
def test_executor_with_either_quantizer(use_del_dec):
    """The executor alone, with two host encoders: the device quantizer
    stands in for the host's (the delayed-decision one, or the
    single-state one with the encoder pinned to it), and the packets stay
    close to the host-quantized encoder's in size."""
    from mousiki_tpu_torch.hostcodec.bitstream.packet import Mode
    from mousiki_tpu_torch.hostcodec.opus_encoder import APP_VOIP, OpusEncoder

    def encoder(hook=None):
        e = OpusEncoder(48000, 1, APP_VOIP)
        e.set_bitrate(24000)
        e.force_mode = Mode.SILK
        e.silk.use_del_dec = use_del_dec
        if hook is not None:
            e.silk.nsq_fn = hook
        return e

    n, frames = 2, 3
    sigs = _signals()[:n]
    ex = NsqBatchExecutor(n, use_del_dec=use_del_dec, device="cpu")
    encs = [encoder(ex.hook) for _ in range(n)]
    hosts = [encoder() for _ in range(n)]
    for f in range(frames):
        pcm = [sigs[s][f * 960:(f + 1) * 960].astype(np.float64)
               for s in range(n)]
        got = ex.run([(lambda s=s: encs[s].encode(pcm[s], 960))
                      for s in range(n)])
        want = [hosts[s].encode(pcm[s], 960) for s in range(n)]
        for g, w in zip(got, want):
            assert g[0] == w[0]                       # the same TOC
            assert abs(len(g) - len(w)) <= max(8, len(w) // 4), \
                (f, len(g), len(w))
    assert ex.dispatches >= frames
    # an error inside a task surfaces in the caller, not as a hang
    with pytest.raises(ZeroDivisionError):
        ex.run([lambda: 1 / 0, lambda: 2])


def test_arguments():
    with pytest.raises(TypeError):
        SilkEncodePipeline(2)                         # no default device
    pipe = SilkEncodePipeline(2, device="cpu")
    with pytest.raises(ValueError):
        pipe.step(np.zeros((3, 960)))
