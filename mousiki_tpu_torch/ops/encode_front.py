"""Batched device front half of the CELT encoder: port of
mousiki_tpu/ops/encode_front_jax.py.

One step over S encoder streams computes everything between raw PCM and
the symbol layer: preemphasis, tone detection, the prefilter pitch search
and quantised-gain decision, the prefilter with its cross-frame blend,
the transient analysis and the forward MDCT (long and short, selected per
stream), as batched tensor ops. The native symbol encoder
(celt/host_native.NativeCeltEncoderBatch) takes the returned tensors and
writes the bitstream.

The reference runs three linear, time-invariant recurrences as scans: the
transient analysis' second-order high-pass and its two first-order
smoothers. Here each is one strict-fp32 product with a lower (or upper)
triangular Toeplitz matrix of the recurrence's impulse response, built
once in float64 (`hp_matrix`, `linrec_matrix`); the two smoothers are one
matrix.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from .. import _device
from ..celt.modes import COMBFILTER_MAXPERIOD, COMBFILTER_MINPERIOD, MODE
from . import _tables
from .mdct import mdct_matrix

OVERLAP = 120
PREEMPH = 0.85
_SHORT = 120          # short-block MDCT size


class FrontState(NamedTuple):
    """Cross-frame encoder state, leading axis = S streams."""
    preemph_mem: torch.Tensor   # (S, C)
    in_mem: torch.Tensor        # (S, C, OVERLAP) prefiltered overlap tail
    pf_mem: torch.Tensor        # (S, C, 1024) preemphasised history
    pf_period: torch.Tensor     # (S,) int32
    pf_gain: torch.Tensor       # (S,)
    pf_tapset: torch.Tensor     # (S,) int32


def linrec_matrix(n: int, coef: float, reverse: bool = False) -> np.ndarray:
    """(n, n) float64 matrix T of the first-order recurrence
    y[i] = x[i] + coef * y[i-1], so that y = x @ T.T (reverse=True runs
    the recurrence from the last sample down)."""
    d = np.arange(n)[:, None] - np.arange(n)[None, :]
    T = np.where(d >= 0, float(coef) ** np.maximum(d, 0), 0.0)
    return T.T.copy() if reverse else T


def hp_matrix(n: int) -> np.ndarray:
    """(n, n) float64 Toeplitz matrix of the transient analysis' high-pass
    (mem0' = mem0 - x + 0.5 mem1, out = mem0 + x, mem1' = x - mem0, from
    zero state): out = x @ T.T. Its poles have modulus sqrt(0.5), so the
    impulse response is below 1e-9 after 64 taps."""
    h = np.zeros(n)
    mem0 = mem1 = 0.0
    for i in range(n):
        xi = 1.0 if i == 0 else 0.0
        h[i] = mem0 + xi
        mem0, mem1 = mem0 - xi + 0.5 * mem1, xi - mem0
    d = np.arange(n)[:, None] - np.arange(n)[None, :]
    return np.where(d >= 0, h[np.maximum(d, 0)], 0.0)


def make_front_consts(frame: int, device) -> dict:
    """Constant operators and tables of the front step, on `device`."""
    dev = _device.as_device(device)
    w = np.asarray(MODE.window, np.float32)
    L = frame + OVERLAP
    len2 = L // 2

    def t(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    # fwd = 0.0625 * linrec(x2, 0.9375); bwd = 0.125 * linrec(fwd, 0.875,
    # reverse): one operator
    smooth = (0.0625 * 0.125) * (linrec_matrix(len2, 0.875, reverse=True)
                                 @ linrec_matrix(len2, 0.9375))
    consts = {
        "frame": frame,
        "window2": t(w * w),
        "inv_table": t(_tables.TRANSIENT_INV_TABLE),
        "comb_gains": t(_tables.COMB_GAINS),
        "hpT": t(hp_matrix(L).T),
        "smoothT": t(smooth.T),
        "blend": t(np.concatenate([w * w, np.ones(frame - OVERLAP,
                                                  np.float32)])),
    }
    for nb in {frame, _SHORT}:
        consts[f"FT{nb}"] = t(mdct_matrix(nb).astype(np.float32).T)
        i1, i2, g1, g2 = _tables.fold_operator(nb, w)
        consts[f"fold{nb}"] = (t(i1, np.int64), t(i2, np.int64), t(g1),
                               t(g2))
    return consts


def init_front_state(S: int, channels: int, frame: int, device) -> FrontState:
    """All-zero cross-frame state of S streams on `device` (`frame` does
    not size it; it is kept for the reference's signature)."""
    dev = _device.as_device(device)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return FrontState(
        preemph_mem=z(S, channels), in_mem=z(S, channels, OVERLAP),
        pf_mem=z(S, channels, COMBFILTER_MAXPERIOD),
        pf_period=torch.full((S,), COMBFILTER_MINPERIOD, dtype=torch.int32,
                             device=dev),
        pf_gain=z(S), pf_tapset=torch.zeros((S,), dtype=torch.int32,
                                            device=dev))


def _tone_lpc(x, delay: int):
    """Second-order LPC fit of x (S, n) at spacing `delay`, from the
    forward and backward covariances. The reference masks and rolls
    whole rows (fixed shapes under jit); slices give the same sums."""
    n = x.shape[-1]
    lim = n - 2 * delay
    x0 = x[..., :lim]
    r00 = (x0 * x0).sum(-1)
    r01 = (x0 * x[..., delay:delay + lim]).sum(-1)
    r02 = (x0 * x[..., 2 * delay:]).sum(-1)
    t2, t1 = x[..., lim:], x[..., n - delay:]
    h0, h1 = x[..., :delay], x[..., delay:2 * delay]
    r11 = r00 + (t2 * t2).sum(-1) - (h0 * h0).sum(-1)
    r22 = r11 + (t1 * t1).sum(-1) - (h1 * h1).sum(-1)
    r12 = r01 + (t2[..., :delay] * t1).sum(-1) - (h0 * h1).sum(-1)
    r00t, r01t = r00 + r22, r01 + r12
    r11t, r02t, r12t = 2.0 * r11, 2.0 * r02, r12 + r01
    den = r00t * r11t - r01t * r01t
    ok = (den > 0.0) & (den >= 0.001 * r00t * r11t)
    safe = torch.where(den == 0, torch.ones_like(den), den)
    a1 = torch.clamp((r02t * r11t - r01t * r12t) / safe, -1.0, 1.0)
    a0 = torch.clamp((r00t * r12t - r02t * r01t) / safe,
                     -1.999999, 1.999999)
    return ok, a0, a1


def _pick(table, index):
    """table[s, index[s]] for a (S, n) table and a (S,) integer index."""
    return table.gather(1, index.long()[:, None])[:, 0]


def front_step(consts: dict, state: FrontState, pcm, nbytes, tapset,
               lsb_depth: int = 24):
    """One batched front step.

    pcm: (S, frame, channels) float32 in [-1, 1]; nbytes: (S,) int32
    byte budgets of the frame; tapset: (S,) int32, the symbol encoder's
    spread-analysis feedback. The channel count and the frame size come
    from pcm's shape and must match the state and the constants. Returns
    (outputs dict, new FrontState): every analysis decision the symbol
    encoder takes over, and the MDCT spectrum `freq` (S, channels, frame).
    """
    S, N, C = pcm.shape
    if N != consts["frame"]:
        raise ValueError(f"pcm frame {N}, constants built for "
                         f"{consts['frame']}")
    if state.preemph_mem.shape != (S, C):
        raise ValueError(f"pcm {tuple(pcm.shape)} against a state of "
                         f"{tuple(state.preemph_mem.shape)} streams x "
                         "channels")
    dev = pcm.device
    f32 = torch.float32
    ov = OVERLAP
    zero = torch.zeros((), dtype=f32, device=dev)
    minp = torch.full((), COMBFILTER_MINPERIOD, dtype=torch.int32,
                      device=dev)
    nbytes = nbytes.to(torch.int32)
    tapset = tapset.to(torch.int32)

    with record_function("front.preemph"):
        x = pcm.to(f32).transpose(1, 2) * 32768.0             # (S, C, N)
        prev = torch.cat([state.preemph_mem[..., None] / PREEMPH,
                          x[..., :-1]], dim=-1)
        pre = x - PREEMPH * prev
        preemph_mem = PREEMPH * x[..., -1]
        inb = torch.cat([state.in_mem, pre], dim=-1)          # (S, C, N+ov)
        silence = pcm.reshape(S, -1).abs().amax(-1) \
            <= 1.0 / (1 << lsb_depth)

    with record_function("front.tone"):
        mono_inb = inb.sum(1) if C == 2 else inb[:, 0]
        tone_freq = torch.full((S,), -1.0, dtype=f32, device=dev)
        toneish = torch.zeros((S,), dtype=f32, device=dev)
        chosen = torch.zeros((S,), dtype=torch.bool, device=dev)
        for delay in (1, 2, 4, 8, 16, 32):
            ok, a0, a1 = _tone_lpc(mono_inb, delay)
            # the host's loop doubles the delay while there is no result
            # or (a0 > 1 and a1 < 0); the first delay that stops wins, and
            # delay 32 stops whatever (a0, a1) say
            stop = ok if delay == 32 else ok & ~((a0 > 1.0) & (a1 < 0.0))
            take = stop & ~chosen & (a0 * a0 + 3.999999 * a1 < 0.0)
            tf = torch.acos(torch.clamp(0.5 * a0, -1.0, 1.0)) / delay
            tone_freq = torch.where(take, tf, tone_freq)
            toneish = torch.where(take, -a1, toneish)
            chosen = chosen | stop

    with record_function("front.pitch"):
        # prefilter pitch search: 2x downsampled cross-correlation
        hist = state.pf_mem.mean(1)                           # (S, 1024)
        cur = pre.mean(1)                                     # (S, N)
        mono = torch.cat([hist, cur], dim=-1)                 # (S, 1024+N)
        lp = 0.5 * (mono[:, 0::2] + mono[:, 1::2])
        nlp = lp.shape[-1]
        half = N // 2
        fr = lp[:, -half:]
        e_f = (fr * fr).sum(-1) + 1e-9
        lo = COMBFILTER_MINPERIOD // 2 + 1
        hi = min(COMBFILTER_MAXPERIOD // 2 - 1, nlp - half - 1)
        # out[j] = fr . lp[j : j + half], lag = nlp - half - j: one
        # correlation a stream (conv1d correlates, no kernel flip)
        out = F.conv1d(lp[None], fr[:, None, :].contiguous(), groups=S)[0]
        e2p = torch.cat([torch.zeros((S, 1), dtype=f32, device=dev),
                         torch.cumsum(lp * lp, dim=-1)], dim=-1)
        lags = torch.arange(lo, hi, device=dev)
        j = nlp - half - lags
        c_l = out[:, j]                                       # (S, nlags)
        e_l = e2p[:, j + half] - e2p[:, j] + 1e-9
        score = torch.where(c_l > 0,
                            c_l * torch.rsqrt(e_f[:, None] * e_l), zero)
        best_i = torch.argmax(score, dim=-1)
        best_s = _pick(score, best_i)
        best_l = lags[best_i]
        # sub-multiple preference (the host stops at the first that fits)
        taken = torch.zeros((S,), dtype=torch.bool, device=dev)
        for div in (2, 3):
            cand = torch.div(best_l, div, rounding_mode="floor")
            s_c = _pick(score, torch.clamp(cand - lo, 0, len(lags) - 1))
            take = (~taken) & (cand >= lo) & (s_c > 0.85 * best_s)
            best_l = torch.where(take, cand, best_l)
            best_s = torch.where(take, torch.maximum(best_s, s_c), best_s)
            taken = taken | take
        # full-rate refinement, +/-2 around 2 * best_l
        nf = mono.shape[-1]
        cur_f = mono[:, -N:]
        e_fr_full = (cur_f * cur_f).sum(-1) + 1e-9
        p0 = torch.clamp(2 * best_l - 2, min=COMBFILTER_MINPERIOD)
        cand_p = torch.clamp(p0[:, None] + torch.arange(5, device=dev),
                             max=COMBFILTER_MAXPERIOD - 3)    # (S, 5)
        idx = (nf - N - cand_p)[:, :, None] + torch.arange(N, device=dev)
        segs = mono[:, None, :].expand(S, 5, nf).gather(2, idx)
        cc = (cur_f[:, None, :] * segs).sum(-1)
        ee = (segs * segs).sum(-1) + 1e-9
        fs = torch.where(cc > 0, cc * torch.rsqrt(e_fr_full[:, None] * ee),
                         zero)
        ki = torch.argmax(fs, dim=-1)
        best_fs = _pick(fs, ki)
        pitch_index = _pick(cand_p, ki).to(torch.int32)
        gain1 = torch.clamp(0.7 * best_fs, max=1.0)

        # prefilter decision
        enabled = (~silence) & (nbytes * 8 >= 17) & (nbytes > 12)
        # pure-tone rescue: halve the tone frequency until it is < 0.39
        tf_r = tone_freq
        for _ in range(6):
            tf_r = torch.where(tf_r >= 0.39, tf_r * 0.5, tf_r)
        rescue = (toneish > 0.99) & (gain1 < 0.4)
        has_tone = tf_r > 0.006148
        # the divisor is made safe before the cast: an infinite quotient
        # converts to different integers on different devices
        period = torch.floor(
            0.5 + 2.0 * math.pi / torch.where(has_tone, tf_r,
                                              torch.ones_like(tf_r)))
        pi_tone = torch.where(
            has_tone,
            torch.clamp(period, max=COMBFILTER_MAXPERIOD - 2)
            .to(torch.int32), minp)
        pitch_index = torch.where(rescue, pi_tone, pitch_index)
        gain1 = torch.where(rescue, torch.full_like(gain1, 0.75), gain1)
        qg = torch.clamp(
            torch.floor(0.5 + gain1 * 32.0 / 3.0).to(torch.int32) - 1, 0, 7)
        gain_q = 0.09375 * (qg + 1).to(f32)
        pf_threshold = torch.where(nbytes > 25, 0.2, 0.4).to(f32)
        pf_on = enabled & (gain_q > pf_threshold) \
            & (pitch_index > COMBFILTER_MINPERIOD)
        t1 = torch.where(pf_on, pitch_index, minp)
        g1 = torch.where(pf_on, gain_q, zero)

    with record_function("front.prefilter"):
        # the comb prefilter with its cross-frame blend
        ref = torch.cat([state.pf_mem, pre], dim=-1)          # (S,C,1024+N)
        nref = ref.shape[-1]
        offs = torch.arange(-2, 3, device=dev)[:, None] \
            + torch.arange(N, device=dev)[None, :]            # (5, N)

        def comb(t, tg):
            # the five taps around lag t[s]: one gather of (S, C, 5, N)
            iz = torch.clamp((COMBFILTER_MAXPERIOD - t.long())[:, None, None]
                             + offs, 0, nref - 1)
            taps = ref[:, :, None, :].expand(S, C, 5, nref).gather(
                3, iz[:, None].expand(S, C, 5, N))
            m2, m1, z0, pp1, pp2 = taps.unbind(2)
            return (tg[:, 0, None, None] * z0
                    + tg[:, 1, None, None] * (pp1 + m1)
                    + tg[:, 2, None, None] * (pp2 + m2))

        tg0 = consts["comb_gains"][state.pf_tapset.long()]
        tg1 = consts["comb_gains"][tapset.long()]
        p0v = state.pf_gain[:, None, None] * comb(
            torch.clamp(state.pf_period, min=COMBFILTER_MINPERIOD), tg0)
        p1v = g1[:, None, None] * comb(
            torch.clamp(t1, min=COMBFILTER_MINPERIOD), tg1)
        same = ((state.pf_gain == g1) & (state.pf_period == t1)
                & (state.pf_tapset == tapset))
        f = torch.where(same[:, None, None], torch.ones((), dtype=f32,
                                                       device=dev),
                        consts["blend"])
        pre_f = pre - (1.0 - f) * p0v - f * p1v
        pre_f = torch.where(silence[:, None, None], pre, pre_f)
        inb_f = torch.cat([state.in_mem, pre_f], dim=-1)

    with record_function("front.transient"):
        tmp = inb_f @ consts["hpT"]                           # (S, C, L)
        L = tmp.shape[-1]
        len2 = L // 2
        tmp = tmp * (torch.arange(L, device=dev) >= 12)
        x2 = tmp[..., 0:2 * len2:2] ** 2 + tmp[..., 1:2 * len2:2] ** 2
        mean_e = x2.sum(-1)
        bwd = x2 @ consts["smoothT"]
        max_e = bwd.amax(-1)
        frame_e = torch.sqrt(torch.clamp(mean_e * max_e * 0.5 * len2,
                                         min=0.0))
        norm = len2 / (frame_e + 1e-15)
        pz = torch.floor(64.0 * norm[..., None]
                         * (bwd[..., 12:max(12, len2 - 5):4] + 1e-15))
        pz = torch.clamp(pz, 0, 127).long()
        unmask = consts["inv_table"][pz].sum(-1)
        value = torch.floor(64.0 * unmask * 4.0 / (6.0 * (len2 - 17)))
        mask_metric = value.amax(-1) if C == 2 else value[:, 0]
        low_tone = (toneish > 0.98) & (tone_freq >= 0) & (tone_freq < 0.026)
        is_transient = (mask_metric > 200) & ~low_tone & ~silence
        tf_max = torch.clamp(
            torch.sqrt(27.0 * torch.clamp(mask_metric, min=0.0)) - 42.0,
            0.0, 163.0)
        tf_estimate = torch.sqrt(torch.clamp(0.0069 * tf_max - 0.139,
                                             min=0.0))

    with record_function("front.mdct"):
        # long and per-short-block forward MDCTs, selected by transient
        i1, i2, gg1, gg2 = consts[f"fold{N}"]
        fold_l = inb_f[..., i1] * gg1 + inb_f[..., i2] * gg2
        freq_long = fold_l @ consts[f"FT{N}"]
        i1s, i2s, g1s, g2s = consts[f"fold{_SHORT}"]
        segs = inb_f.unfold(-1, _SHORT + ov, _SHORT)          # (S,C,B,NB+ov)
        folds = segs[..., i1s] * g1s + segs[..., i2s] * g2s
        short = folds @ consts[f"FT{_SHORT}"]                 # (S,C,B,NB)
        # interleave: freq[b + B * j] = short[..., b, j]
        freq_short = short.transpose(2, 3).reshape(S, C, N)
        freq = torch.where(is_transient[:, None, None], freq_short,
                           freq_long)

    new_state = FrontState(
        preemph_mem=preemph_mem, in_mem=pre_f[..., N - ov:],
        pf_mem=ref[..., N:N + COMBFILTER_MAXPERIOD], pf_period=t1,
        pf_gain=g1,
        pf_tapset=torch.where(pf_on, tapset, torch.zeros_like(tapset)))
    outputs = {
        "freq": freq, "silence": silence, "tone_freq": tone_freq,
        "toneishness": toneish, "pf_on": pf_on, "pitch_index": pitch_index,
        "qg": qg, "gain1": g1, "is_transient": is_transient,
        "tf_estimate": tf_estimate,
    }
    return outputs, new_state


def front_scan(consts: dict, state: FrontState, pcms, nbytes, tapset,
               lsb_depth: int = 24, compact: bool = False):
    """K front steps in a row. pcms: (K, S, frame, channels); the tapset
    is held fixed over the chunk, so the symbol encoder's tapset decision
    feeds back with up to K frames of lag (an encoder's free choice,
    signalled in the stream as usual). Returns (outputs stacked on a
    leading K axis, final state). compact=True casts `freq` to float16:
    the spectra are band-normalised before the PVQ search, so float16's
    2^-11 relative noise is far below the quantiser's step, and the
    largest plane of the readback halves."""
    outs = []
    for pcm in pcms:
        out, state = front_step(consts, state, pcm, nbytes, tapset,
                                lsb_depth=lsb_depth)
        if compact:
            out["freq"] = out["freq"].to(torch.float16)
        outs.append(out)
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}, state
