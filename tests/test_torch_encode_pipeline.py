"""mousiki_tpu_torch.pipeline.CeltEncodePipeline: its packets decode in
libopus with the quality the JAX pipeline's are held to (the cases of
tests/test_encode_pipeline.py), step_chunk and encode_stream yield one
list of S packets a frame, and the share of packets byte-equal to the JAX
pipeline's is printed."""

import os
import sys

import numpy as np
import pytest
import torch

from mousiki_tpu.testing import oracle
from mousiki_tpu_torch.pipeline import CeltEncodePipeline
from torch_threads import one_torch_thread  # noqa: F401

_TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
if _TOOLS not in sys.path:
    sys.path.insert(0, _TOOLS)

needs_libopus = pytest.mark.skipif(not oracle.available(),
                                   reason="libopus oracle unavailable")


def _signal(n_frames, channels, seed=0):
    sig = oracle.make_test_signal(960 * n_frames, channels, seed=seed)
    return np.clip(sig, -0.95, 0.95).astype(np.float32)


def _toc(channels):
    # CELT-only fullband 20 ms TOC byte
    return bytes([(31 << 3) | (4 if channels == 2 else 0)])


def _downmix_16k(x48):
    taps = 96
    t = np.arange(-taps, taps + 1, dtype=np.float64)
    h = np.sinc(t / 3.0) / 3.0 * np.hanning(2 * taps + 1)
    mono = np.asarray(x48, np.float64)
    if mono.ndim > 1:
        mono = mono.mean(axis=1)
    return np.convolve(mono, h, mode="same")[::3]


def _err4(sig, decoded):
    from opus_compare import compare
    ref = _downmix_16k(sig)
    got = _downmix_16k(decoded)
    return compare(32768.0 * ref.astype(np.float32),
                   32768.0 * got.astype(np.float32))


def _frame(sigs, f):
    return np.stack([sig[f * 960:(f + 1) * 960] for sig in sigs])


@needs_libopus
@pytest.mark.parametrize("channels,bitrate", [(2, 128000), (1, 96000),
                                              (2, 64000)])
def test_packets_decode_in_libopus(channels, bitrate):
    S, n_frames = 3, 24
    sigs = [_signal(n_frames, channels, seed=s) for s in range(S)]
    pipe = CeltEncodePipeline(S, channels=channels, bitrate=bitrate,
                              device="cpu")
    decs = [oracle.RefDecoder(48000, channels) for _ in range(S)]
    outs = [[] for _ in range(S)]
    for f in range(n_frames):
        pkts = pipe.step(_frame(sigs, f))
        assert len(pkts) == S
        for s, p in enumerate(pkts):
            assert p is not None and len(p) > 10
            outs[s].append(decs[s].decode_float(_toc(channels) + p, 960))
    worst = 0.0
    for s in range(S):
        r = _err4(sigs[s][: n_frames * 960], np.concatenate(outs[s], axis=0))
        assert r["err4"] < 0.5, (s, r)
        worst = max(worst, r["err4"])
    print(f"C={channels} {bitrate} bit/s: worst err4 {worst:.4f} (bar 0.5)")


def _chunks(sigs, K, n_chunks):
    for c in range(n_chunks):
        yield np.stack([_frame(sigs, c * K + k) for k in range(K)])


@needs_libopus
def test_encode_stream_and_step_chunk_yield_every_frame():
    """encode_stream and step_chunk give K * chunks lists of S packets of
    the quality of stepped encoding (not the same bytes: the tapset
    feedback lags, and the spectra cross as float16)."""
    S, K, n_chunks = 2, 4, 3
    n_frames = K * n_chunks
    sigs = [_signal(n_frames, 2, seed=s) for s in range(S)]
    streamed = list(CeltEncodePipeline(S, channels=2, bitrate=96000,
                                       device="cpu")
                    .encode_stream(_chunks(sigs, K, n_chunks)))
    chunked_pipe = CeltEncodePipeline(S, channels=2, bitrate=96000,
                                      device="cpu")
    chunked = []
    for chunk in _chunks(sigs, K, n_chunks):
        got = chunked_pipe.step_chunk(torch.from_numpy(chunk))
        assert len(got) == K
        chunked.extend(got)
    for frames in (streamed, chunked):
        assert len(frames) == n_frames
        decs = [oracle.RefDecoder(48000, 2) for _ in range(S)]
        outs = [[] for _ in range(S)]
        for pkts in frames:
            assert len(pkts) == S
            for s, p in enumerate(pkts):
                assert p is not None and len(p) > 10
                outs[s].append(decs[s].decode_float(_toc(2) + p, 960))
        for s in range(S):
            r = _err4(sigs[s][: n_frames * 960],
                      np.concatenate(outs[s], axis=0))
            assert r["err4"] < 0.5, (s, r)
            print(f"chunked encode, stream {s}: err4 {r['err4']:.4f}")
    # a short last chunk comes out whole
    pipe = CeltEncodePipeline(S, channels=2, bitrate=96000, device="cpu")
    parts = [np.stack([_frame(sigs, k) for k in range(4)]),
             np.stack([_frame(sigs, k) for k in range(4, 6)])]
    assert len(list(pipe.encode_stream(iter(parts)))) == 6


def test_packets_against_the_jax_pipeline():
    """The same PCM through the JAX pipeline and the port: the share of
    byte-equal packets is printed (the fronts agree to float tolerance, and
    the symbol encoders are the same code, so most packets are equal); the
    packet sizes are equal."""
    pytest.importorskip("jax")
    from mousiki_tpu.pipeline import CeltEncodePipeline as JaxPipeline
    S, n_frames = 3, 8
    sigs = [_signal(n_frames, 2, seed=s) for s in range(S)]
    ours = CeltEncodePipeline(S, channels=2, bitrate=128000, device="cpu")
    theirs = JaxPipeline(S, channels=2, bitrate=128000)
    if theirs._native is None:
        pytest.skip("the JAX package's native encoder did not build")
    equal = total = 0
    for f in range(n_frames):
        got = ours.step(_frame(sigs, f))
        want = theirs.step(_frame(sigs, f))
        assert [len(p) for p in got] == [len(p) for p in want]
        equal += sum(a == b for a, b in zip(got, want))
        total += S
    print(f"packets byte-equal to the JAX pipeline's: {equal}/{total}")
    assert ours.nbytes == theirs.nbytes == 320


def test_pipeline_arguments():
    with pytest.raises(TypeError):
        CeltEncodePipeline(2)                      # no default device
    pipe = CeltEncodePipeline(2, channels=1, bitrate=64000, device="cpu")
    with pytest.raises(ValueError):
        pipe.step(np.zeros((2, 960, 2), np.float32))
    with pytest.raises(ValueError):
        pipe.step_chunk(np.zeros((2, 960, 1), np.float32))
    out = pipe.front(np.zeros((2, 960, 1), np.float32))
    assert out["freq"].shape == (2, 1, 960) and bool(out["silence"].all())
