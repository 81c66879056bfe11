"""Batched CELT packet-loss concealment in PyTorch: port of
mousiki_tpu/ops/plc_jax.py.

For S streams at once: open-loop pitch search on the decode history,
24-order LPC fit (windowed autocorrelation + Levinson), periodic
excitation extension with per-period decay, LPC synthesis with the
decoder's saturation, comb-filter undo, and forward-MDCT re-entry. The
caller masks the result into the synthesis step per stream.

Every sum and product across a row (the correlations, energies, the
autocorrelation, the Levinson and LPC-synthesis inner products, the
re-entry MDCT) accumulates in float64 and is rounded to float32 once, so
that a stream conceals alike whatever batch it shares (_device.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from .. import _device
from ..celt.modes import (CELT_LPC_ORDER, DECODE_BUFFER_SIZE,
                          PLC_PITCH_LAG_MAX, PLC_PITCH_LAG_MIN)
from ._tables import COMB_GAINS, fold_operator
from .mdct import mdct_matrix
from .synthesis import COMB_MIN

DBS = DECODE_BUFFER_SIZE
ORDER = CELT_LPC_ORDER
HIST = 1024  # COMBFILTER_MAXPERIOD: LPC/excitation window


class PlcState(NamedTuple):
    loss_count: torch.Tensor   # (S,) int32
    plc_pitch: torch.Tensor    # (S,) int32
    lpc: torch.Tensor          # (S, C, ORDER) f32


def init_plc_state(n_streams: int, channels: int, device) -> PlcState:
    dev = _device.as_device(device)
    return PlcState(
        torch.zeros((n_streams,), dtype=torch.int32, device=dev),
        torch.full((n_streams,), PLC_PITCH_LAG_MAX, dtype=torch.int32,
                   device=dev),
        torch.zeros((n_streams, channels, ORDER), dtype=torch.float32,
                    device=dev))


def make_plc_consts(frame: int, window, device) -> dict:
    """Static operators: forward-MDCT basis + fold for the re-entry, the
    Hann LPC window and autocorrelation lag weights."""
    dev = _device.as_device(device)
    w = np.asarray(window, np.float32)
    han = np.hanning(HIST + 2)[1:-1].astype(np.float32)
    lagw = 1.0 - (0.008 * np.arange(1, ORDER + 1, dtype=np.float32)) ** 2
    i1, i2, g1, g2 = fold_operator(frame, w)

    def t(a):
        return torch.as_tensor(a, device=dev)

    return {
        "F": _device.operator64(mdct_matrix(frame), dev),
        "fold": (t(i1.astype(np.int64)), t(i2.astype(np.int64)), t(g1),
                 t(g2)),
        "han": t(han),
        "lagw": t(lagw),
        "comb_gains": t(COMB_GAINS),
    }


def _pitch_search(mem):
    """(S, C, DBS+...) decode memory -> (S,) PLC pitch at 48 kHz."""
    mono = mem[:, :, :DBS].mean(dim=1)            # (S, 2048)
    lp = 0.5 * (mono[:, 0::2] + mono[:, 1::2])    # (S, 1024)
    S, n = lp.shape
    lp64 = lp.double()
    frame = lp64[:, n - 512:]
    e_f = ((frame * frame).sum(-1) + 1e-9).float()
    lo = PLC_PITCH_LAG_MIN // 2
    hi = PLC_PITCH_LAG_MAX // 2
    # c[lag2] = frame . lp[n-512-lag2 : n-lag2]: a grouped correlation;
    # correlation and energies in float64, each rounded once
    out = F.conv1d(lp64[None], frame[:, None, :], groups=S)[0]  # (S, n-511)
    e2 = torch.cumsum(lp64 * lp64, dim=-1)
    e2p = torch.cat([torch.zeros((S, 1), dtype=e2.dtype, device=e2.device),
                     e2], dim=-1)
    lags = torch.arange(lo, hi + 1, device=mem.device)
    j = n - 512 - lags
    c = out[:, j].float()
    e = (e2p[:, j + 512] - e2p[:, j] + 1e-9).float()
    score = torch.where(c > 0, c * torch.rsqrt(e_f[:, None] * e),
                        torch.full_like(c, -1.0))
    best = torch.argmax(score, dim=-1)
    lag = (lags[best] * 2).to(torch.int32)
    return torch.clamp(lag, PLC_PITCH_LAG_MIN, PLC_PITCH_LAG_MAX)


def _lpc_fit(consts, hist):
    """(S, C, HIST) history -> (S, C, ORDER) LPC (windowed autocorr +
    Levinson with the decoder's noise floor, clamps and bw expansion)."""
    xw = (hist * consts["han"]).double()
    n = HIST
    ac = torch.stack([(xw[..., :n - i] * xw[..., i:]).sum(-1)
                      for i in range(ORDER + 1)], dim=-1).float()  # (S, C, 25)
    ac0 = ac[..., 0] * 1.0001 + 1e-9 * n
    ac = torch.cat([ac0[..., None], ac[..., 1:] * consts["lagw"]], dim=-1)
    ac64 = ac.double()

    a = torch.zeros_like(ac[..., :ORDER])
    err = ac[..., 0]
    for i in range(ORDER):
        # acc = ac[i+1] - sum_{j<i} a[j] * ac[i-j], the sum in float64
        dot = (a[..., :i] * ac64[..., 1:i + 1].flip(-1)).sum(-1)
        acc = (ac64[..., i + 1] - dot).float()
        k = torch.clamp(acc / torch.clamp(err, min=1e-12), -0.98, 0.98)
        # a[:i] -= k * a[i-1::-1] ; a[i] = k
        a2 = a.clone()
        a2[..., :i] = a[..., :i] - k[..., None] * a[..., :i].flip(-1)
        a2[..., i] = k
        a = a2
        err = err * (1 - k * k)
    bw = 0.99 ** torch.arange(1, ORDER + 1, dtype=torch.float32,
                              device=hist.device)
    return a * bw


def _fir_residual(x, a):
    """exc[i] = x[i] - sum_j a[j] x[i-1-j] over the last axis."""
    acc = x
    T = x.shape[-1]
    for j in range(ORDER):
        shifted = F.pad(x, (j + 1, 0))[..., :T]
        acc = acc - a[..., j:j + 1] * shifted
    return acc


def _lpc_synthesis(e_ext, tail, lpc):
    """(S, C, n) excitation through the LPC synthesis filter, with the
    ORDER samples `tail` of decoder history as initial conditions and the
    decoder's saturation. buf holds [ORDER samples of history | n
    outputs], oldest first. The float64 weights make each step's sum
    float64; the float32 buf rounds it once, where it is written."""
    S, C, n = e_ext.shape
    buf = torch.empty((S, C, ORDER + n), dtype=torch.float32,
                      device=e_ext.device)
    buf[..., :ORDER] = tail
    lpc_rev = lpc.flip(-1).double()  # weights, window oldest..newest
    with record_function("plc.lpc_synthesis"):
        for t in range(n):
            v = e_ext[..., t] + (buf[..., t:t + ORDER] * lpc_rev).sum(-1)
            buf[..., ORDER + t] = torch.clamp(v, -65536.0, 65536.0)
    return buf[..., ORDER:]


def celt_plc_freq(consts, state, plc: PlcState, lost, *, channels: int,
                  frame: int):
    """PLC re-entry spectrum for all streams (masked use by the caller).

    Returns (freq (S, C, frame) full-scale MDCT coefficients, new
    PlcState). Follows celt/decoder._decode_lost step by step."""
    S = lost.shape[0]
    C = channels
    N = frame
    mem = state.decode_mem
    dev = mem.device
    overlap = 120
    n_ext = N + overlap

    first = lost & (plc.loss_count == 0)
    pitch = torch.where(first, _pitch_search(mem), plc.plc_pitch)
    hist = mem[:, :, DBS - HIST:DBS]
    lpc = torch.where(first[:, None, None], _lpc_fit(consts, hist), plc.lpc)

    exc = _fir_residual(hist, lpc)                  # (S, C, HIST)
    # per-period decay from the last two pitch periods' energies
    p = pitch.long()
    ar = torch.arange(HIST, device=dev)
    m1 = (ar >= HIST - p[:, None])[:, None, :]
    m2 = ((ar >= HIST - 2 * p[:, None]) & (ar < HIST - p[:, None]))[:, None, :]
    exc64 = exc.double()
    ee = exc64 * exc64
    zero = torch.zeros((), dtype=ee.dtype, device=dev)
    e1 = torch.where(m1, ee, zero).sum(-1).float()
    e2 = torch.where(m2, ee, zero).sum(-1).float()
    has2 = (2 * p <= HIST)[:, None]
    e2 = torch.where(has2, e2, e1)
    decay = torch.sqrt(torch.clamp(e1 / torch.clamp(e2, min=1e-9), max=1.0))
    fade = torch.where(plc.loss_count == 0, 1.0, 0.8).to(torch.float32)
    fade = fade[:, None]

    # periodic excitation continuation with per-period attenuation
    nn = torch.arange(n_ext, device=dev)
    src = HIST - p[:, None] + nn[None, :] % p[:, None]        # (S, n_ext)
    periods = nn[None, :] // p[:, None]
    e_src = torch.gather(exc, 2, src[:, None, :].expand(S, C, n_ext))
    atten = fade[:, :, None] * torch.exp(
        torch.log(torch.clamp(decay, min=1e-9))[:, :, None]
        * periods[:, None, :].to(torch.float32))
    e_ext = e_src * atten

    ext = _lpc_synthesis(e_ext, mem[:, :, DBS - ORDER:DBS], lpc)

    # comb-filter undo over the re-entry window (decode_mem is in the
    # post-postfilter domain; the TDAC raw tails are pre-postfilter)
    full = torch.cat([mem[:, :, :DBS], ext], dim=-1)
    T = torch.clamp(state.pf_period, min=COMB_MIN).long()
    g = state.pf_gain
    tg = consts["comb_gains"][state.pf_tapset.long()]          # (S, 3)
    win = torch.arange(DBS, DBS + N + overlap, device=dev)

    def tapsum(off):
        idx = (win[None, :] - T[:, None] + off)[:, None, :]
        return torch.gather(full, 2, idx.expand(S, C, N + overlap))

    combv = (tg[:, 0, None, None] * tapsum(0)
             + tg[:, 1, None, None] * (tapsum(1) + tapsum(-1))
             + tg[:, 2, None, None] * (tapsum(2) + tapsum(-2)))
    gv = g[:, None, None]
    inb = full[:, :, DBS:DBS + N + overlap] - torch.where(
        gv != 0.0, gv * combv, torch.zeros_like(combv))

    i1, i2, g1, g2 = consts["fold"]
    folded = inb[..., i1] * g1 + inb[..., i2] * g2
    freq = torch.matmul(folded.double(), consts["F"].T).float()

    new_plc = PlcState(
        loss_count=torch.where(lost, plc.loss_count + 1,
                               torch.zeros_like(plc.loss_count)),
        plc_pitch=torch.where(lost, pitch, plc.plc_pitch),
        lpc=torch.where(lost[:, None, None], lpc, plc.lpc),
    )
    return freq, new_plc
