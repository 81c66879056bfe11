"""Batched SILK synthesis in PyTorch: port of
mousiki_tpu/ops/silk_synthesis_jax.py, the device half of the SILK decoder.

Float formulation of the SILK decode core over S concurrent streams.
Everything is computed in the output domain, which makes the fixed-point
decoder's gain-adjustment rescaling of carried state unnecessary (multiply
its recurrences through by the subframe gain and the gain_adj factors
cancel):

  * scale: e[n] = gain[subfr(n)] * exc[n]
  * LTP (voiced): r[n] = e[n] + sum_j b_j r[n - lag + 2 - j] over
    [rewhitened history | frame]. The feedback lag is >= pitch-2 >= 14
    samples, so the recurrence runs as a loop over chunks of 8 samples
    with per-stream lag gathers, the same trick as the CELT comb filter.
  * LPC: y[n] = r[n] + sum_j a_j y[n-1-j], an order-16 IIR: one step a
    sample, all streams wide, with an (S, 16) carry.

The reference compiles both loops into one program (`fori_loop`,
`lax.scan`); in eager PyTorch they are Python loops, 40 chunk steps and
320 sample steps a 20 ms frame at 16 kHz, each a handful of small
launches. PCM parity with the bit-exact host decoder is float-level.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from .. import _device

LTP_ORDER = 5
MAX_D = 16
CHUNK = 8    # feedback reach is lag-2 >= 14 even at the NB minimum lag


class SilkFrameParams(NamedTuple):
    """Dense per-frame SILK parameters (leading axis = S streams)."""
    exc: torch.Tensor          # (S, L) float excitation (exc_q14 / 2^14)
    a: torch.Tensor            # (S, 2, 16) LPC coefs (a_q12 / 2^12) per half
    b: torch.Tensor            # (S, nb_subfr, 5) LTP taps (q14 / 2^14)
    pitch_l: torch.Tensor      # (S, nb_subfr) int lags (>= CHUNK+2 if voiced)
    gains: torch.Tensor        # (S, nb_subfr) linear gains (gains_q16 / 2^16)
    voiced: torch.Tensor       # (S,) bool
    ltp_scale: torch.Tensor    # (S,) float (ltp_scale_q14 / 2^14)
    interp: torch.Tensor = None  # (S,) bool: NLSF-interpolated halves
                                 # (the decode core's k == 2 rewhitening)


class SilkStreamState(NamedTuple):
    out_hist: torch.Tensor     # (S, H) previous output at the internal rate
    lpc_hist: torch.Tensor     # (S, 16) y[n-1], y[n-2], ... (output domain)


def init_silk_state(n_streams: int, fs_khz: int, device) -> SilkStreamState:
    dev = _device.as_device(device)
    H = 20 * fs_khz  # ltp_mem_length
    return SilkStreamState(
        torch.zeros((n_streams, H), dtype=torch.float32, device=dev),
        torch.zeros((n_streams, MAX_D), dtype=torch.float32, device=dev))


def _lpc_analysis_batched(x, a):
    """residual[n] = x[n] - sum_j a[j] x[n-1-j]; x: (S, T), a: (S, 16)."""
    T = x.shape[1]
    xp = torch.nn.functional.pad(x, (MAX_D, 0))
    acc = x
    for j in range(MAX_D):
        acc = acc - a[:, j:j + 1] * xp[:, MAX_D - 1 - j:MAX_D - 1 - j + T]
    return acc


def _ltp_chunks(r, params: SilkFrameParams, c_lo: int, c_hi: int,
                hist_len: int, nb_subfr: int, subfr_len: int):
    """Run the LTP recurrence over chunks c_lo..c_hi-1 of the frame, in
    place on r (S, hist + samples); chunk c_lo starts at r[:, hist_len]."""
    S = r.shape[0]
    dev = r.device
    tap_off = 2 - torch.arange(LTP_ORDER, device=dev)  # B0 at +2 .. B4 at -2
    pitch = params.pitch_l.long()
    voiced = params.voiced[:, None]
    zero = torch.zeros((), dtype=r.dtype, device=dev)
    for ci in range(c_lo, c_hi):
        n0 = hist_len + (ci - c_lo) * CHUNK
        n = n0 + torch.arange(CHUNK, device=dev)
        sub = min((ci * CHUNK) // subfr_len, nb_subfr - 1)
        lag = pitch[:, sub]                                   # (S,)
        bsub = params.b[:, sub, :]                            # (S, 5)
        idx = (n[None, :, None] - lag[:, None, None]
               + tap_off[None, None, :])                      # (S, CHUNK, 5)
        idx = torch.clamp(idx, 0, r.shape[1] - 1)
        past = torch.gather(r, 1, idx.reshape(S, -1)).reshape(
            S, CHUNK, LTP_ORDER)
        pred = (past * bsub[:, None, :]).sum(-1)
        r[:, n0:n0 + CHUNK] += torch.where(voiced, pred, zero)
    return r


def _lpc_scan(a, x, hist):
    """y[n] = x[n] + sum_j a[j] y[n-1-j], one step a sample; hist (S, 16)
    holds y[n-1], y[n-2], ... Returns (y (S, T), new hist)."""
    T = x.shape[1]
    # y laid out oldest first behind a 16-sample head: the carry of step n
    # is the reversed window y[n-16:n]
    buf = torch.cat([hist.flip(1), torch.empty_like(x)], dim=1)
    a_rev = a.flip(1)
    for n in range(T):
        buf[:, MAX_D + n] = x[:, n] + (buf[:, n:n + MAX_D] * a_rev).sum(-1)
    return buf[:, MAX_D:], buf[:, T:].flip(1)


def silk_synthesis_step(params: SilkFrameParams, state: SilkStreamState,
                        nb_subfr: int = 4, subfr_len: int = 80):
    """One SILK frame for all streams; returns (out (S, L), new state)."""
    S, L = params.exc.shape
    H = state.out_hist.shape[1]
    dev = params.exc.device

    sub_idx = torch.clamp(torch.arange(L, device=dev) // subfr_len,
                          max=nb_subfr - 1)
    g = torch.gather(params.gains, 1, sub_idx[None, :].expand(S, L))
    e = params.exc * g

    half = (L // 2 // subfr_len) * subfr_len
    a0 = params.a[:, 0, :]
    a1 = params.a[:, 1, :]

    # -- first half: rewhiten history with half-0 LPC, scaled by ltp_scale
    # (the decode core's k == 0 rewhitening) --
    white = _lpc_analysis_batched(state.out_hist, a0) \
        * params.ltp_scale[:, None]
    r1 = torch.cat([white, e[:, :half]], dim=1)            # (S, H + half)
    with record_function("silk.ltp"):
        r1 = _ltp_chunks(r1, params, 0, half // CHUNK, H, nb_subfr,
                         subfr_len)
    with record_function("silk.lpc"):
        y1, h1 = _lpc_scan(a0, r1[:, H:], state.lpc_hist)

    # -- second half: NLSF-interpolated frames rewhiten [history | y1]
    # with the half-1 LPC (k == 2, no ltp_scale); otherwise the LTP
    # residual recurrence simply continues --
    if params.interp is None:
        r2_init = r1
    else:
        rew = _lpc_analysis_batched(
            torch.cat([state.out_hist, y1], dim=1), a1)
        r2_init = torch.where(params.interp[:, None], rew, r1)
    r2 = torch.cat([r2_init, e[:, half:]], dim=1)          # (S, H + L)
    with record_function("silk.ltp"):
        r2 = _ltp_chunks(r2, params, half // CHUNK, L // CHUNK, H + half,
                         nb_subfr, subfr_len)
    with record_function("silk.lpc"):
        y2, h2 = _lpc_scan(a1, r2[:, H + half:], h1)

    out = torch.cat([y1, y2], dim=1)
    new_hist = torch.cat([state.out_hist, out], dim=1)[:, -H:]
    return out, SilkStreamState(new_hist, h2)
