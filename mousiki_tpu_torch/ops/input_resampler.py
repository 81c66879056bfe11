"""Arbitrary-rate input resampler (libopusenc front-end equivalent): port
of mousiki_tpu/ops/input_resampler.py.

Parity target: reference `src/libopusenc/resample.rs` (the speex
resampler libopusenc uses to bring any input rate to 48 kHz). Same
design parameters -- the quality ladder's filter length / oversampling /
bandwidth table -- but re-architected: instead of the speex per-sample
inner loops, the polyphase Kaiser-windowed-sinc filter bank is built once
as a dense (phases, taps) matrix and each output block is one gather +
row-wise dot product. The bank design, the streaming `ArbitraryResampler`
and `resample_block` are the reference's numpy code, unchanged (the host
encoder's input stage); `resample_batched` runs S streams on a device as
one gather and one strict-fp32 contraction.

The Kaiser windows are evaluated analytically (np.kaiser) at the beta
the speex window tables approximate, so output is equivalent-quality,
not bit-identical.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import _device  # noqa: F401  (strict fp32: TF32 off)

# quality -> (base filter half-length, oversample, down-bw, up-bw, beta)
# (resample.rs:8-19 QualityMapping; Kaiser6/8/10/12 window tables)
_QUALITY = [
    (8, 4, 0.830, 0.860, 6.0),
    (16, 4, 0.850, 0.880, 6.0),
    (32, 4, 0.882, 0.910, 6.0),
    (48, 8, 0.895, 0.917, 8.0),
    (64, 8, 0.921, 0.940, 8.0),
    (80, 16, 0.922, 0.940, 10.0),
    (96, 16, 0.940, 0.945, 10.0),
    (128, 16, 0.950, 0.950, 10.0),
    (160, 16, 0.960, 0.960, 10.0),
    (192, 32, 0.968, 0.968, 12.0),
    (256, 32, 0.975, 0.975, 12.0),
]

_MAX_PHASES = 4096  # above this, phases are sampled from an oversampled bank


def _design(in_rate: int, out_rate: int, quality: int):
    """Polyphase Kaiser-sinc bank: (den phases, taps) weights + geometry."""
    base_len, oversample, down_bw, up_bw, beta = _QUALITY[
        max(0, min(10, quality))]
    g = math.gcd(in_rate, out_rate)
    num, den = in_rate // g, out_rate // g  # input advance num per den outs
    if out_rate >= in_rate:
        cutoff = up_bw          # relative to input Nyquist
        taps = base_len
    else:
        cutoff = down_bw * out_rate / in_rate
        taps = int(base_len * in_rate / out_rate)
        taps -= taps % 2
    taps = max(8, taps)

    phases = den
    if phases > _MAX_PHASES:
        phases = _MAX_PHASES
    # filter center sits taps/2 into the history window
    i = np.arange(taps, dtype=np.float64)
    frac = np.arange(phases, dtype=np.float64)[:, None] / phases
    t = i[None, :] - taps / 2 + 1 - frac    # sample offsets per phase
    h = cutoff * np.sinc(cutoff * t)
    # Kaiser window evaluated at each tap position (len taps+1 support)
    x = np.clip(t / (taps / 2), -1.0, 1.0)
    win = np.i0(beta * np.sqrt(1.0 - x * x)) / np.i0(beta)
    bank = (h * win).astype(np.float64)
    bank /= bank.sum(axis=1, keepdims=True)  # unity DC gain per phase
    return bank, num, den, taps, phases


class ArbitraryResampler:
    """Streaming arbitrary-rate resampler, one or more channels.

    process() consumes float PCM (n, C) at in_rate and returns the
    resampled (m, C) block at out_rate, carrying taps of history across
    calls (speex_resampler_process_interleaved_float equivalent)."""

    def __init__(self, in_rate: int, out_rate: int = 48000,
                 channels: int = 1, quality: int = 5):
        if in_rate <= 0 or out_rate <= 0:
            raise ValueError("rates must be positive")
        self.in_rate, self.out_rate, self.channels = in_rate, out_rate, channels
        (self.bank, self.num, self.den,
         self.taps, self.phases) = _design(in_rate, out_rate, quality)
        # the virtual input stream starts with taps//2 zeros so the filter
        # is centered on the first real sample (speex skip_zeros latency)
        self._buf = np.zeros((self.taps // 2, channels))
        self._buf_start = 0  # absolute index of _buf[0] in the virtual stream
        self._next_out = 0   # absolute index of the next output sample

    @property
    def input_latency(self) -> int:
        return self.taps // 2

    @property
    def output_latency(self) -> int:
        return (self.taps // 2) * self.den // self.num

    def process(self, x: np.ndarray) -> np.ndarray:
        if x.ndim == 1:
            x = x[:, None]
        self._buf = np.concatenate([self._buf, x], axis=0)
        avail = self._buf_start + self._buf.shape[0]
        # output k gathers virtual input [k*num//den, +taps); emit every k
        # whose window is fully available
        p_max = avail - self.taps  # largest admissible gather start
        if p_max < 0:
            return np.zeros((0, x.shape[1]), x.dtype)
        k_end = ((p_max + 1) * self.den - 1) // self.num + 1
        n_out = k_end - self._next_out
        if n_out <= 0:
            return np.zeros((0, x.shape[1]), x.dtype)
        pos = np.arange(self._next_out, k_end) * self.num
        idx = pos // self.den - self._buf_start
        phase = pos % self.den
        if self.phases != self.den:
            phase = phase * self.phases // self.den
        gat = self._buf[idx[:, None] + np.arange(self.taps)[None, :]]
        out = np.einsum("mtc,mt->mc", gat, self.bank[phase])
        self._next_out = k_end
        # drop input no future output needs
        keep_from = (k_end * self.num) // self.den - self._buf_start
        if keep_from > 0:
            self._buf = self._buf[keep_from:]
            self._buf_start += keep_from
        return out.astype(x.dtype, copy=False)


def resample_block(x: np.ndarray, in_rate: int, out_rate: int = 48000,
                   quality: int = 5) -> np.ndarray:
    """One-shot whole-signal resample (centered, latency-compensated)."""
    if x.ndim == 1:
        x = x[:, None]
    bank, num, den, taps, phases = _design(in_rate, out_rate, quality)
    half = taps // 2
    buf = np.concatenate([np.zeros((half, x.shape[1])), x,
                          np.zeros((taps, x.shape[1]))], axis=0)
    n_out = x.shape[0] * den // num
    pos = np.arange(n_out) * num
    idx = pos // den
    phase = pos % den
    if phases != den:
        phase = phase * phases // den
    gat = buf[idx[:, None] + np.arange(taps)[None, :]]
    return np.einsum("mtc,mt->mc", gat, bank[phase]).astype(x.dtype,
                                                            copy=False)


def resample_batched(x, in_rate: int, out_rate: int = 48000,
                     quality: int = 5):
    """Batched device resample: (S, N) float32 streams -> (S, M) on x's
    device, as one gather and one strict-fp32 contraction (TF32 is off,
    _device.py)."""
    bank, num, den, taps, phases = _design(in_rate, out_rate, quality)
    half = taps // 2
    S, N = x.shape
    n_out = N * den // num
    pos = np.arange(n_out) * num
    idx = pos // den
    phase = pos % den
    if phases != den:
        phase = phase * phases // den
    xp = F.pad(x, (half, taps))
    gidx = torch.as_tensor(idx[:, None] + np.arange(taps)[None, :],
                           device=x.device)
    gat = xp[:, gidx]                                        # (S, M, T)
    w = torch.as_tensor(bank.astype(np.float32)[phase], device=x.device)
    return torch.einsum("smt,mt->sm", gat, w)
