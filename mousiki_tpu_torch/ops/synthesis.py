"""Batched CELT synthesis in PyTorch: port of mousiki_tpu/ops/synthesis_jax.py.

Per step, for S streams at once: denormalise (band-energy scale through a
bin->band gather), long/short IMDCT as float32 matrix products, the TDAC
overlap combine, the chunked comb postfilter, and the de-emphasis tail
(IIR, 1/32768 scale and (S, C, N) -> (S, N, C) interleave: one CUDA
kernel of ops/deemphasis.py on the card). Public layouts follow the JAX
module: state tensors are (S, C, ...), PCM comes out as (S, N, C).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from .. import _device
from ..celt.modes import DECODE_BUFFER_SIZE, E_MEANS, MODE
from ._tables import COMB_GAINS, bin_band_map
from .deemphasis import deemphasis_pcm
from .mdct import imdct_matrix

OVERLAP = 120
HALF = OVERLAP // 2
N960 = 960
COMB_MIN = 15
CHUNK = COMB_MIN - 2


class SynthesisConsts(NamedTuple):
    m_long: torch.Tensor      # (n, n) IMDCT basis
    m_short: torch.Tensor     # (120, 120)
    window: torch.Tensor      # (120,)
    bin_band: torch.Tensor    # (n,) int64
    e_means: torch.Tensor     # (22,)
    comb_gains: torch.Tensor  # (3, 3)


def make_consts(n: int, device) -> SynthesisConsts:
    """Constants for frame size n (120/240/480/960 = LM 0-3)."""
    dev = _device.as_device(device)
    M = n // MODE.short_mdct_size
    e_means = np.concatenate([E_MEANS[:21], [0.0]]).astype(np.float32)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return SynthesisConsts(
        m_long=f32(imdct_matrix(n)),
        m_short=f32(imdct_matrix(120)),
        window=f32(MODE.window),
        bin_band=torch.as_tensor(bin_band_map(MODE, M).astype(np.int64),
                                 device=dev),
        e_means=f32(e_means),
        comb_gains=f32(COMB_GAINS),
    )


class StreamState(NamedTuple):
    """Per-stream decoder state on the device; leading axis = streams."""
    decode_mem: torch.Tensor       # (S, C, DECODE_BUFFER_SIZE + HALF)
    preemph: torch.Tensor          # (S, C)
    pf_period: torch.Tensor        # (S,) int32 (previous frame's)
    pf_gain: torch.Tensor          # (S,)
    pf_tapset: torch.Tensor        # (S,) int32
    pf_period_old: torch.Tensor    # (S,) int32
    pf_gain_old: torch.Tensor      # (S,)
    pf_tapset_old: torch.Tensor    # (S,) int32


def init_state(n_streams: int, channels: int, device) -> StreamState:
    dev = _device.as_device(device)
    S = n_streams

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    def per(value):
        return torch.full((S,), value, dtype=torch.int32, device=dev)

    return StreamState(
        decode_mem=z(S, channels, DECODE_BUFFER_SIZE + HALF),
        preemph=z(S, channels),
        pf_period=per(COMB_MIN),
        pf_gain=z(S),
        pf_tapset=per(0),
        pf_period_old=per(COMB_MIN),
        pf_gain_old=z(S),
        pf_tapset_old=per(0),
    )


class FrameDesc(NamedTuple):
    """Dense per-frame descriptors from the host symbol stage (axis 0 = S)."""
    x: torch.Tensor            # (S, C, n) unit-norm band shapes
    band_log_e: torch.Tensor   # (S, C, 22) decoded energies (band 21 = pad)
    transient: torch.Tensor    # (S,) bool
    silence: torch.Tensor      # (S,) bool
    pf_pitch: torch.Tensor     # (S,) int32 new postfilter period
    pf_gain: torch.Tensor      # (S,) new postfilter gain
    pf_tapset: torch.Tensor    # (S,) int32


def denormalise(consts: SynthesisConsts, x, band_log_e, silence):
    """freq[s,c,k] = x * 2^(bandLogE[band(k)] + eMeans[band(k)])."""
    lg = band_log_e + consts.e_means[None, None, :]
    g = torch.exp2(torch.clamp(lg, max=32.0))
    gk = torch.index_select(g, 2, consts.bin_band)
    freq = x * gk
    return torch.where(silence[:, None, None], torch.zeros_like(freq), freq)


def imdct_blocks(consts: SynthesisConsts, freq, transient):
    """Raw IMDCT output (S, C, N) of the long (1 x N) or short (8 x 120)
    block layout, selected per stream."""
    S, C, N = freq.shape
    raw_long = torch.matmul(freq, consts.m_long.T)               # (S, C, N)
    B = N // 120
    # short blocks: block b coefficient k = freq[b + B*k]
    fs = freq.reshape(S, C, 120, B).transpose(2, 3)     # (S, C, B, 120)
    raw_short = torch.matmul(fs, consts.m_short.T).reshape(S, C, N)
    return torch.where(transient[:, None, None], raw_short, raw_long)


@lru_cache(maxsize=None)
def _tdac(n: int, n2: int, device: torch.device):
    """Per output position j: the mirrored index into T = [tail | raw] and
    the two weights of out = c1*T[j] + c2*T[mirror] (overlap_windows),
    as tensors on `device`."""
    w = np.asarray(MODE.window, np.float32)
    j = np.arange(n)
    r = j % n2
    g = (j // n2) * n2
    i2 = OVERLAP - 1 - r
    mirror = np.clip(g + i2, 0, n + HALF - 1)
    rc = np.clip(r, 0, OVERLAP - 1)
    i2c = np.clip(i2, 0, OVERLAP - 1)
    head = r < HALF
    mid = (r >= HALF) & (r < OVERLAP)
    c1 = np.where(head, w[i2c], np.where(mid, w[rc], 1.0)).astype(np.float32)
    c2 = np.where(head, -w[rc], np.where(mid, w[i2c], 0.0)).astype(np.float32)
    return (torch.as_tensor(mirror.astype(np.int64), device=device),
            torch.as_tensor(c1, device=device),
            torch.as_tensor(c2, device=device))


def overlap_windows(consts: SynthesisConsts, raw, prev_tail, transient):
    """Vectorized TDAC combine for both block layouts; returns (out, new_tail).

    T = [prev_tail | raw]; per block b at offset g=b*n2:
      r <  HALF:        out = w[ov-1-r]*T[g+r] - w[r]*T[g+ov-1-r]
      HALF <= r < ov:   out = w[r]*T[g+r] + w[ov-1-r]*T[g+ov-1-r]
      r >= ov:          out = T[g+r]
    computed for n2=N (1 block) and n2=120 (N/120 blocks), selected per
    stream."""
    N = raw.shape[-1]
    T = torch.cat([prev_tail, raw], dim=-1)       # (S, C, N + HALF)
    tj = T[..., :N]

    def combine(n2):
        mirror, c1, c2 = _tdac(N, n2, T.device)
        return c1 * tj + c2 * torch.index_select(T, 2, mirror)

    out = torch.where(transient[:, None, None], combine(120), combine(N))
    return out, T[..., N:N + HALF]


@lru_cache(maxsize=None)
def _comb_taps(device: torch.device):
    """Tap-gain column and lag offset of the 5 taps (0, +1, -1, +2, -2)."""
    return (torch.tensor([0, 1, 1, 2, 2], device=device),
            torch.tensor([0, 1, -1, 2, -2], device=device))


def comb_filter_batched(consts, buf, pos, N, t0, t1, g0, g1, tap0, tap1):
    """Batched comb filter over buf[..., pos:pos+N], in place on `buf`.

    buf: (S, C, L); periods t0/t1 (S,) >= 15; gains (S,); taps (S,) int.
    A Python loop over chunks of COMB_MIN-2 = 13 samples, the chunking of
    the reference fori_loop: the feedback lag is >= 13 (periods are
    clamped to >= 15), so each chunk reads only outputs of earlier chunks.
    Returns buf."""
    S, C, _ = buf.shape
    dev = buf.device
    w = consts.window
    gains = consts.comb_gains
    t0 = t0.long()
    t1 = t1.long()
    tap0 = tap0.long()
    tap1 = tap1.long()
    active = (g0 != 0.0) | (g1 != 0.0)
    same = (g0 == g1) & (t0 == t1) & (tap0 == tap1)
    ov = torch.where(same, 0, OVERLAP)                       # (S,)
    n_chunks = -(-N // CHUNK)
    L = n_chunks * CHUNK
    rel = torch.arange(L, device=dev)                        # sample in [0, N)
    # f(i) = w[i]^2 inside the blend window, 1 afterwards
    wsq = torch.cat([w * w, torch.ones(1, dtype=w.dtype, device=dev)])
    in_blend = rel[None, :] < ov[:, None]                    # (S, L)
    f = torch.where(in_blend, wsq[torch.clamp(rel, max=OVERLAP)][None, :],
                    torch.ones((), dtype=w.dtype, device=dev))
    # after the blend region the reference stops when g1 == 0
    valid = ((rel[None, :] < N) & active[:, None]
             & (in_blend | (g1 != 0.0)[:, None]))            # (S, L)
    # taps at offsets (0, +1, -1, +2, -2) of lags t0 and t1, weighted as
    # (1-f)*part0 + f*part1 with part = g*(c0*x0 + c1*(x+1 + x-1) + ...)
    tg0 = gains[tap0] * g0[:, None]                          # (S, 3)
    tg1 = gains[tap1] * g1[:, None]
    sel, offs = _comb_taps(dev)
    wts = torch.cat([(1 - f)[:, None, :] * tg0[:, sel, None],
                     f[:, None, :] * tg1[:, sel, None]], dim=1)  # (S, 10, L)
    lags = torch.cat([t0[:, None] - offs[None, :],
                      t1[:, None] - offs[None, :]], dim=1)   # (S, 10)
    idx = pos + rel[None, None, :] - lags[:, :, None]        # (S, 10, L)
    wts = wts.reshape(S, 10, n_chunks, CHUNK).permute(2, 0, 1, 3)
    idx = idx.reshape(S, 10, n_chunks, CHUNK).permute(2, 0, 1, 3)
    valid = valid.reshape(S, n_chunks, CHUNK).permute(1, 0, 2)
    wts = wts.contiguous()
    idx = idx.reshape(n_chunks, S, 1, 10 * CHUNK).expand(
        n_chunks, S, C, 10 * CHUNK).contiguous()
    for ci in range(n_chunks):
        start = pos + ci * CHUNK
        taps = torch.gather(buf, 2, idx[ci]).reshape(S, C, 10, CHUNK)
        cur = buf[..., start:start + CHUNK]
        y = cur + (taps * wts[ci][:, None]).sum(dim=2)
        buf[..., start:start + CHUNK] = torch.where(valid[ci][:, None, :],
                                                    y, cur)
    return buf


def synthesis_step(consts: SynthesisConsts, state: StreamState,
                   desc: FrameDesc, n: int = N960, lost=None, freq_plc=None):
    """One frame (n = 120/240/480/960 samples, LM 0-3) for all streams;
    returns (pcm (S, n, C) contiguous, new state). consts must be
    make_consts(n).

    lost/freq_plc: lost streams take the PLC re-entry spectrum (already
    full-scale) instead of their denormalised decoded bands; callers also
    set the lost streams' desc.pf_* to the state's current postfilter
    params and transient/silence to False (see band_exec.plan_plc_core)."""
    N = n
    freq = denormalise(consts, desc.x, desc.band_log_e, desc.silence)
    if lost is not None:
        freq = torch.where(lost[:, None, None], freq_plc, freq)
    raw = imdct_blocks(consts, freq, desc.transient)

    # shift decode_mem left by N; the previous raw tail lands at DECODE-N
    mem = torch.roll(state.decode_mem, -N, dims=-1)
    pos = DECODE_BUFFER_SIZE - N
    prev_tail = mem[..., pos:pos + HALF]
    out, new_tail = overlap_windows(consts, raw, prev_tail, desc.transient)
    mem[..., pos:pos + N] = out
    mem[..., pos + N:pos + N + HALF] = new_tail

    # postfilter: old->current over the first shortMdctSize, then
    # current->new for the rest
    per = torch.clamp(state.pf_period, min=COMB_MIN)
    per_old = torch.clamp(state.pf_period_old, min=COMB_MIN)
    new_per = torch.clamp(desc.pf_pitch, min=COMB_MIN)
    blend = min(120, N)
    with record_function("synthesis.comb_filter"):
        comb_filter_batched(consts, mem, pos, blend, per_old, per,
                            state.pf_gain_old, state.pf_gain,
                            state.pf_tapset_old, state.pf_tapset)
        if N > blend:
            comb_filter_batched(consts, mem, pos + blend, N - blend, per,
                                new_per, state.pf_gain, desc.pf_gain,
                                state.pf_tapset, desc.pf_tapset)

    synth = mem[..., pos:pos + N].contiguous()
    with record_function("synthesis.deemphasis"):
        pcm, new_preemph = deemphasis_pcm(synth, state.preemph)

    # state rotation (celt_decoder.rs:4011): old <- current, current <- new;
    # for LM != 0 old is then overwritten with the new values too, so only
    # 2.5 ms frames keep the one-frame-delayed "old" postfilter params
    if n == 120:
        old_p, old_g, old_t = per, state.pf_gain, state.pf_tapset
    else:
        old_p, old_g, old_t = new_per, desc.pf_gain, desc.pf_tapset
    new_state = StreamState(
        decode_mem=mem,
        preemph=new_preemph,
        pf_period=new_per,
        pf_gain=desc.pf_gain,
        pf_tapset=desc.pf_tapset,
        pf_period_old=old_p,
        pf_gain_old=old_g,
        pf_tapset_old=old_t,
    )
    return pcm, new_state
