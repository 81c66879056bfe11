"""Batched SILK noise-shaping quantizers: port of
mousiki_tpu/ops/silk_nsq_jax.py.

S encoder streams quantize one frame a call, as (S,)-wide lanes. The
quantizer's feedback (the shaping filter over the quantization error, the
one-sample low-frequency and tilt recurrences, the rate-distortion pulse
decision) is serial in the sample. Each quantizer is a wrapper over two
routes: CPU tensors take its plain version, a Python loop over the samples
of a subframe, a few dozen small tensor ops a sample; CUDA tensors launch
its hand-written kernel once (csrc/silk_nsq.cu, one block a stream, the
arithmetic in csrc/silk_nsq.h):

  * `nsq_frame` (`nsq_frame_reference`): the single-state quantizer;
  * `nsq_del_dec_frame` (`nsq_del_dec_frame_reference`): the
    delayed-decision quantizer, (S, N) trellis lanes with the
    decision-delay rings on a third axis; committed (delayed) samples
    land in the shared work buffers at the per-stream column t - dd[s].

Semantics follow the reference (and through it silk/noise_shape.py and
silk/nsq_del_dec.py of the host codec): explicit state in and out, work
buffers in absolute frame time (column M + t = frame time t), per-stream
masks for voiced / unvoiced / interpolated lanes. Lanes never mix: a
stream's pulses do not depend on its batch. Where the reference rebuilds
a buffer a sample, the loops here write in place (nothing is
differentiated), and the ring head of the delayed-decision quantizer,
equal for all streams, is a Python integer.

The random dither is the SILK linear congruential generator in int32,
which wraps on overflow on the CPU and on CUDA alike.

The kernels take the executor's shape only (parallel/nsq_batch.py: 4
subframes of 80 samples, M = 320, order <= 24, 4 trellis states) and
raise on another; `nsq_frame_host` and `nsq_del_dec_frame_host` run the
kernels' arithmetic on CPU tensors through the host build of
csrc/silk_nsq.h (the CPU tests).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _device
from . import _build

LTP_ORDER = 5
SHAPE_ORDER = 24
LPC_ORDER = 16
QUANT_LEVEL_ADJUST = 80.0 / 1024.0
RAND_MULTIPLIER = 196314165
RAND_INCREMENT = 907633515
DECISION_DELAY = 40
MAX_DD_STATES = 4
BIG_RD = float(2.0 ** 27)
_MIN_GAIN = 1.0 / 65536.0

# kernel launches made by `nsq_frame` and `nsq_del_dec_frame` (not by the
# plain versions)
nsq_frame_launches = 0
nsq_del_dec_launches = 0


def reset_launches() -> None:
    global nsq_frame_launches, nsq_del_dec_launches
    nsq_frame_launches = 0
    nsq_del_dec_launches = 0


class NsqParams(NamedTuple):
    """One frame of quantizer inputs, leading axis = S streams."""
    x: torch.Tensor          # (S, L) input at int16 scale
    a: torch.Tensor          # (S, 2, 16) LPC per half (q12 / 4096)
    b: torch.Tensor          # (S, nb_subfr, 5) LTP taps (q14 / 16384)
    ar_shp: torch.Tensor     # (S, nb_subfr, 24) shaping AR
    harm: torch.Tensor       # (S, nb_subfr)
    tilt: torch.Tensor       # (S, nb_subfr)
    lf_ma: torch.Tensor      # (S, nb_subfr)
    lf_ar: torch.Tensor      # (S, nb_subfr)
    gains: torch.Tensor      # (S, nb_subfr) linear gains (>= 1/65536)
    pitch_l: torch.Tensor    # (S, nb_subfr) int32
    lam: torch.Tensor        # (S,) RD lambda
    offset: torch.Tensor     # (S,) quant offset (from signal/offset type)
    voiced: torch.Tensor     # (S,) bool
    seed: torch.Tensor       # (S,) int32 frame seed
    ltp_scale: torch.Tensor  # (S,) ltp_scale_q14 / 16384
    interp: torch.Tensor     # (S,) bool NLSF interpolation flag


class NsqDevState(NamedTuple):
    """Cross-frame state of `nsq_frame`."""
    xq: torch.Tensor         # (S, M) unscaled quantized output history
    shp: torch.Tensor        # (S, M) shaping history (scaled domain)
    s_lpc: torch.Tensor      # (S, 16) newest-first xq_v history (scaled)
    s_ar2: torch.Tensor      # (S, 24) newest-first s_diff history
    s_lf_ar: torch.Tensor    # (S,)
    s_diff: torch.Tensor     # (S,)
    lag_prev: torch.Tensor   # (S,) int32
    prev_gain: torch.Tensor  # (S,)


class NsqDelDecState(NamedTuple):
    """Cross-frame state of `nsq_del_dec_frame`, collapsed to the winner:
    the trellis re-expands from it at the start of every frame."""
    xq: torch.Tensor         # (S, M) unscaled committed output history
    shp: torch.Tensor        # (S, M) committed shaping history (scaled)
    s_lpc: torch.Tensor      # (S, 16) newest-first xq_v history (scaled)
    s_ar2: torch.Tensor      # (S, 24) warped-chain state (post-rotation)
    s_lf_ar: torch.Tensor    # (S,)
    s_diff: torch.Tensor     # (S,)
    lag_prev: torch.Tensor   # (S,) int32
    prev_gain: torch.Tensor  # (S,)


def _init(cls, n_streams: int, ltp_mem_length: int, device):
    dev = _device.as_device(device)
    S, M = n_streams, ltp_mem_length

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return cls(z(S, M), z(S, M), z(S, LPC_ORDER), z(S, SHAPE_ORDER), z(S),
               z(S), torch.zeros((S,), dtype=torch.int32, device=dev),
               torch.ones((S,), dtype=torch.float32, device=dev))


def init_nsq_state(n_streams: int, ltp_mem_length: int = 320, *,
                   device) -> NsqDevState:
    return _init(NsqDevState, n_streams, ltp_mem_length, device)


def init_nsq_dd_state(n_streams: int, ltp_mem_length: int = 320, *,
                      device) -> NsqDelDecState:
    return _init(NsqDelDecState, n_streams, ltp_mem_length, device)


def _silk_rand(seed):
    """One step of the SILK generator on an int32 tensor (wraps)."""
    return seed * RAND_MULTIPLIER + RAND_INCREMENT


def _level_val(q0, offset):
    """Dequantized excitation level for the integer pulse q0."""
    q0f = q0.to(torch.float32)
    return torch.where(
        q0 > 0, q0f - QUANT_LEVEL_ADJUST + offset,
        torch.where(q0 == 0, offset,
                    torch.where(q0 == -1,
                                offset - (1.0 - QUANT_LEVEL_ADJUST),
                                q0f + QUANT_LEVEL_ADJUST + offset)))


def _dead_zone_q0(r, offset, rdo, use_dz):
    """The first pulse candidate (as a float tensor of whole numbers)."""
    q_ideal = r - offset
    q_dz = torch.where(
        q_ideal > rdo, torch.floor(q_ideal - rdo),
        torch.where(q_ideal < -rdo, torch.floor(q_ideal + rdo),
                    torch.where(q_ideal < 0.0, -1.0, 0.0)))
    return torch.where(use_dz, q_dz, torch.floor(q_ideal))


class _Subframe(NamedTuple):
    """What both quantizers derive from the parameters at the start of
    subframe k."""
    a_k: torch.Tensor
    b_k: torch.Tensor
    ar_shp_k: torch.Tensor
    gain: torch.Tensor
    lag: torch.Tensor        # (S,) int64
    rewhite: torch.Tensor
    changed: torch.Tensor
    adj: torch.Tensor
    wr_lo: torch.Tensor
    x_sc: torch.Tensor
    ltp_idx: torch.Tensor    # (S, sub, 5) columns of the LTP taps
    harm_idx: torch.Tensor   # (S, sub, 3) columns of the harmonic taps


def _subframe_setup(params: NsqParams, k: int, sub: int, M: int, L: int,
                    order: int, xq_w, ltp_w, lag_state, prev_gain,
                    cols_ml) -> _Subframe:
    """The per-subframe prologue shared by both quantizers: coefficient
    selection, the LTP re-whitening of the committed output into `ltp_w`
    (in place), and the gain-change factor."""
    fo = k * sub
    dev = params.x.device
    half0 = params.interp if k < 2 else torch.zeros_like(params.interp)
    a_k = torch.where(half0[:, None], params.a[:, 0], params.a[:, 1])
    gain = torch.clamp(params.gains[:, k], min=_MIN_GAIN)
    inv_gain = 1.0 / gain
    lag = torch.where(params.voiced, params.pitch_l[:, k].long(), lag_state)
    interp_mask = torch.where(params.interp, 1, 3)
    rewhite = params.voiced & ((k & interp_mask) == 0)

    # ---- LTP re-whitening: the residual of xq over times [fo - W, fo),
    # W = min(M - 1, lag + 18), computed over the whole buffer for every
    # stream and masked. The scaled copy lands on times [fo - lag - 2, fo)
    # only (what later reads touch); earlier times stay zero.
    W = torch.clamp(lag + LPC_ORDER + LTP_ORDER // 2, max=M - 1)
    seg_end = M + fo
    tcol = cols_ml[:seg_end]
    res = xq_w[:, :seg_end]
    acc = torch.zeros_like(res)
    for j in range(LPC_ORDER):
        acc[:, j + 1:] += a_k[:, j:j + 1] * res[:, :seg_end - j - 1]
    res = res - acc
    # the first 16 samples of each stream's segment are zeroed
    valid = tcol[None, :] >= (seg_end - W + LPC_ORDER)[:, None]
    ig = inv_gain * params.ltp_scale if k == 0 else inv_gain
    wr_lo = seg_end - (lag + LTP_ORDER // 2)
    wmask = valid & (tcol[None, :] >= wr_lo[:, None]) & rewhite[:, None]
    ltp_w[:, :seg_end] = torch.where(wmask, res * ig[:, None],
                                     ltp_w[:, :seg_end])

    changed = gain != prev_gain
    adj = torch.where(changed, prev_gain / gain, torch.ones_like(gain))
    base = (M + fo - lag)[:, None] + torch.arange(sub, device=dev)[None, :]
    ltp_idx = torch.clamp(
        base[:, :, None] + (2 - torch.arange(LTP_ORDER, device=dev)),
        0, M + L - 1)
    harm_idx = torch.clamp(
        base[:, :, None] + (1 - torch.arange(3, device=dev)), 0, M + L - 1)
    return _Subframe(
        a_k=a_k, b_k=params.b[:, k], ar_shp_k=params.ar_shp[:, k, :order],
        gain=gain, lag=lag, rewhite=rewhite, changed=changed, adj=adj,
        wr_lo=wr_lo, x_sc=params.x[:, fo:fo + sub] * inv_gain[:, None],
        ltp_idx=ltp_idx, harm_idx=harm_idx)


def _scale_where(buf, mask, adj):
    """buf *= adj[:, None] on the masked columns, in place."""
    buf.copy_(torch.where(mask, buf * adj[:, None], buf))


def nsq_frame_reference(params: NsqParams, state: NsqDevState, *,
                        nb_subfr: int = 4, sub: int = 80, M: int = 320,
                        order: int = SHAPE_ORDER):
    """The plain version of `nsq_frame`: quantize one frame for S streams.
    Returns (pulses (S, L) int32, xq_frame (S, L) unscaled quantized
    output, new state)."""
    S = params.x.shape[0]
    L = nb_subfr * sub
    dev = params.x.device
    f32 = torch.float32
    cols_ml = torch.arange(M + L, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    pad = torch.zeros((S, L), dtype=f32, device=dev)

    # absolute-time work buffers: column M + t <-> frame time t
    xq_w = torch.cat([state.xq, pad], dim=1)
    shp_w = torch.cat([state.shp, pad], dim=1)
    ltp_w = torch.zeros((S, M + L), dtype=f32, device=dev)
    # the two delay lines, oldest first: column 16 + t (24 + t) <-> time t
    lpc_h = torch.cat([state.s_lpc.flip(1), pad], dim=1)
    ar_h = torch.cat([state.s_ar2.flip(1), pad], dim=1)

    s_lf_ar = state.s_lf_ar
    s_diff = state.s_diff
    prev_gain = state.prev_gain
    lag_state = state.lag_prev.long()
    rand_seed = params.seed.to(torch.int32)
    pulses = torch.zeros((S, L), dtype=torch.int32, device=dev)

    voiced = params.voiced
    lam = params.lam
    offset = params.offset
    rdo = 0.5 * lam - 0.5
    use_dz = lam > 2.0

    for k in range(nb_subfr):
        fo = k * sub
        sf = _subframe_setup(params, k, sub, M, L, order, xq_w, ltp_w,
                             lag_state, prev_gain, cols_ml)
        gain, lag, adj = sf.gain, sf.lag, sf.adj

        # ---- gain-change adjustment of every scaled state --------------
        before = cols_ml[None, :] < M + fo
        _scale_where(shp_w, before & (cols_ml[None, :] >= fo)
                     & sf.changed[:, None], adj)
        # voiced and not re-whitened: rescale the live LTP window
        _scale_where(ltp_w, before & (cols_ml[None, :] >= sf.wr_lo[:, None])
                     & (sf.changed & voiced & ~sf.rewhite)[:, None], adj)
        s_lf_ar = s_lf_ar * adj
        s_diff = s_diff * adj
        lpc_h[:, fo:fo + LPC_ORDER] *= adj[:, None]
        ar_h[:, fo:fo + SHAPE_ORDER] *= adj[:, None]
        prev_gain = gain

        a_rev = sf.a_k.flip(1)
        ar_rev = sf.ar_shp_k.flip(1)
        harm = params.harm[:, k]
        tilt = params.tilt[:, k]
        lf_ma = params.lf_ma[:, k]
        lf_ar_c = params.lf_ar[:, k]
        has_lag = lag > 0

        for i in range(sub):
            n = fo + i
            t = M + n                            # absolute column
            rand_seed = _silk_rand(rand_seed)

            lpc_pred = (a_rev * lpc_h[:, n:n + LPC_ORDER]).sum(-1)
            # the five LTP taps at times t - lag + 2 - {0..4}
            ltp_taps = ltp_w.gather(1, sf.ltp_idx[:, i])
            ltp_pred = torch.where(voiced, (sf.b_k * ltp_taps).sum(-1), zero)

            n_ar = (ar_rev * ar_h[:, SHAPE_ORDER + n - order:
                                  SHAPE_ORDER + n]).sum(-1) + tilt * s_lf_ar
            n_lf = lf_ma * shp_w[:, t - 1] + lf_ar_c * s_lf_ar
            h3 = shp_w.gather(1, sf.harm_idx[:, i])
            n_ltp = torch.where(
                has_lag, harm * (0.25 * (h3[:, 0] + h3[:, 2])
                                 + 0.5 * h3[:, 1]), zero)

            x_i = sf.x_sc[:, i]
            r = x_i - (lpc_pred + ltp_pred - n_ar - n_lf - n_ltp)
            neg = rand_seed < 0
            r = torch.clamp(torch.where(neg, -r, r), -31.0, 30.0)

            q0 = _dead_zone_q0(r, offset, rdo, use_dz).to(torch.int32)
            v1 = _level_val(q0, offset)
            v2 = _level_val(q0 + 1, offset)
            rd1 = lam * v1.abs() + (r - v1) ** 2
            rd2 = lam * v2.abs() + (r - v2) ** 2
            take2 = rd2 < rd1
            q0 = torch.clamp(torch.where(take2, q0 + 1, q0), -1000, 1000)
            v1 = torch.where(take2, v2, v1)

            lpc_exc = torch.where(neg, -v1, v1) + ltp_pred
            xq_v = lpc_exc + lpc_pred
            xq_w[:, t] = xq_v * gain
            lpc_h[:, LPC_ORDER + n] = xq_v
            s_diff = xq_v - x_i
            ar_h[:, SHAPE_ORDER + n] = s_diff
            s_lf_ar = s_diff - n_ar
            shp_w[:, t] = s_lf_ar - n_lf
            ltp_w[:, t] = lpc_exc
            rand_seed = rand_seed + q0
            pulses[:, n] = q0
        lag_state = torch.where(voiced, lag, lag_state)

    new_state = NsqDevState(
        xq=xq_w[:, L:].clone(), shp=shp_w[:, L:].clone(),
        s_lpc=lpc_h[:, L:].flip(1), s_ar2=ar_h[:, L:].flip(1),
        s_lf_ar=s_lf_ar, s_diff=s_diff,
        lag_prev=torch.where(voiced, params.pitch_l[:, nb_subfr - 1],
                             torch.zeros_like(params.pitch_l[:, 0]))
        .to(torch.int32),
        prev_gain=prev_gain)
    return pulses, xq_w[:, M:], new_state


# ---------------------------------------------------------------------------
# The delayed-decision quantizer: the single-state loop above widened to
# (S, N) trellis lanes. The host's nsq_del_dec is the tested reference;
# agreement is by share of equal pulses (float summation order; the dither
# carries any flipped boundary decision on through the frame).
# ---------------------------------------------------------------------------

# planes of the decision-delay rings, one (S, N, 4, DD) tensor
_RQ, _RXQ, _RPRED, _RSHAPE = range(4)
# planes of the committed work buffers, one (S, 3, M + L) tensor
_WXQ, _WSHP, _WLTP = range(3)


def nsq_del_dec_frame_reference(params: NsqParams, state: NsqDelDecState,
                                *, nb_subfr: int = 4, sub: int = 80,
                                M: int = 320, order: int = SHAPE_ORDER,
                                n_states: int = MAX_DD_STATES, warping=0.0):
    """The plain version of `nsq_del_dec_frame`: delayed-decision quantize
    of one frame for S streams.

    Returns (pulses (S, L) int32, seed_used (S,) int32, new state).
    warping: a number or an (S,) tensor, the allpass coefficient of the
    shaping chain (0 = a plain delay line).
    """
    S = params.x.shape[0]
    N = n_states
    L = nb_subfr * sub
    DD = DECISION_DELAY
    dev = params.x.device
    f32 = torch.float32
    cols_ml = torch.arange(M + L, device=dev)
    ar_n = torch.arange(N, device=dev)
    ar_dd = torch.arange(DD, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)

    w = torch.as_tensor(warping, dtype=f32, device=dev).expand(S)
    # the warped rotation of a stream: new_s = rhs @ Lw[s].T with
    # Lw[j, m] = (-w)^(j - m) for j >= m (0^0 = 1 keeps the plain delay
    # line at w = 0)
    jj = torch.arange(order, device=dev)
    dpow = jj[:, None] - jj[None, :]
    Lw = torch.where(dpow >= 0,
                     torch.pow(-w[:, None, None], torch.clamp(dpow, min=0)),
                     zero)                                 # (S, order, order)

    # committed (shared) buffers: xq, shaping and whitened-LTP planes
    work = torch.zeros((S, 3, M + L), dtype=f32, device=dev)
    work[:, _WXQ, :M] = state.xq
    work[:, _WSHP, :M] = state.shp
    xq_w, shp_w, ltp_w = work[:, _WXQ], work[:, _WSHP], work[:, _WLTP]

    # trellis state (axis 1 = N)
    seeds = ((ar_n[None, :] + (params.seed.long()[:, None] & 3)) & 3) \
        .to(torch.int32)
    seed_init = seeds
    rd = torch.zeros((S, N), dtype=f32, device=dev)
    lf_ar = state.s_lf_ar[:, None].expand(S, N)
    diff = state.s_diff[:, None].expand(S, N)
    s_ar2 = state.s_ar2[:, None, :order].expand(S, N, order).contiguous()
    s_lpc = state.s_lpc[:, None, :].expand(S, N, LPC_ORDER).contiguous()
    r_rand = torch.zeros((S, N, DD), dtype=torch.int32, device=dev)
    rings = torch.zeros((S, N, 4, DD), dtype=f32, device=dev)
    rings[:, :, _RSHAPE, 0] = state.shp[:, M - 1, None]
    delayed_gain = torch.zeros((S, DD), dtype=f32, device=dev)

    # per-stream decision delay
    voiced = params.voiced
    lag_prev = state.lag_prev.long()
    dd = torch.full((S,), min(DD, sub), dtype=torch.int64, device=dev)
    vmin = torch.clamp(params.pitch_l[:, :nb_subfr].long()
                       - LTP_ORDER // 2 - 1, min=0).amin(1)
    dd = torch.where(voiced, torch.minimum(dd, vmin), dd)
    dd = torch.where(
        ~voiced & (lag_prev > 0),
        torch.minimum(dd, torch.clamp(lag_prev - LTP_ORDER // 2 - 1, min=0)),
        dd)

    prev_gain = state.prev_gain
    lag_state = lag_prev
    head = 0        # the ring head, equal for all streams (counts down)
    pulses = torch.zeros((S, L), dtype=torch.int32, device=dev)

    def winner_rows(win):
        """The ring planes of each stream's state `win`: (S, 4, DD)."""
        return rings.gather(
            1, win[:, None, None, None].expand(S, 1, 4, DD))[:, 0]

    def flush(rd, gain, fo, mask=None):
        """Commit the dd[s] delayed samples of each stream's winner to the
        columns [fo - dd, fo) of the pulses and of the work buffers, for
        the streams of `mask` (None = all). Returns (rd, win)."""
        win = torch.argmin(rd, dim=1)
        pen = torch.where(ar_n[None, :] == win[:, None], 0.0, BIG_RD)
        if mask is not None:
            pen = torch.where(mask[:, None], pen, zero)
        rd = rd + pen
        wr = winner_rows(win)
        # window column j <-> delayed sample i = j - DD + dd
        i = ar_dd[None, :] - DD + dd[:, None]                  # (S, DD)
        em = i >= 0
        if mask is not None:
            em = em & mask[:, None]
        last = torch.remainder((head + dd)[:, None] + DD - 1 - i, DD)
        vals = wr.gather(2, last[:, None, :].expand(S, 4, DD))
        lo = fo - DD
        pulses[:, lo:fo] = torch.where(
            em, torch.floor(vals[:, _RQ] + 0.5).to(torch.int32),
            pulses[:, lo:fo])
        xq_w[:, M + lo:M + fo] = torch.where(
            em, vals[:, _RXQ] * gain[:, None], xq_w[:, M + lo:M + fo])
        shp_w[:, M + lo:M + fo] = torch.where(
            em, vals[:, _RSHAPE], shp_w[:, M + lo:M + fo])
        return rd, win

    lam = params.lam[:, None]
    offset = params.offset[:, None]
    rdo = 0.5 * lam - 0.5
    use_dz = lam > 2.0

    for k in range(nb_subfr):
        fo = k * sub
        flush2 = None
        if k == 2:
            # mid-frame winner flush before re-whitening: only voiced,
            # interpolated streams re-whiten at k == 2, so only they flush
            flush2 = voiced & params.interp
            rd, _ = flush(rd, torch.clamp(params.gains[:, 1], min=_MIN_GAIN),
                          fo, mask=flush2)

        sf = _subframe_setup(params, k, sub, M, L, order, xq_w, ltp_w,
                             lag_state, prev_gain, cols_ml)
        gain, lag, adj = sf.gain, sf.lag, sf.adj

        # ---- gain-change adjustment ------------------------------------
        _scale_where(shp_w, (cols_ml[None, :] < M + fo)
                     & (cols_ml[None, :] >= fo) & sf.changed[:, None], adj)
        _scale_where(ltp_w, (cols_ml[None, :] < (M + fo - dd)[:, None])
                     & (cols_ml[None, :] >= sf.wr_lo[:, None])
                     & (sf.changed & voiced & ~sf.rewhite)[:, None], adj)
        lf_ar = lf_ar * adj[:, None]
        diff = diff * adj[:, None]
        s_lpc = s_lpc * adj[:, None, None]
        s_ar2 = s_ar2 * adj[:, None, None]
        rings[:, :, _RPRED:] *= adj[:, None, None, None]
        prev_gain = gain

        a_k = sf.a_k[:, None, :]
        ar_shp_k = sf.ar_shp_k[:, None, :]
        harm = params.harm[:, k]
        tilt = params.tilt[:, k, None]
        lf_ma = params.lf_ma[:, k, None]
        lf_ar_c = params.lf_ar[:, k, None]
        has_lag = lag > 0

        for i in range(sub):
            t = M + fo + i

            # reads of the committed history (per stream)
            ltp_taps = ltp_w.gather(1, sf.ltp_idx[:, i])
            ltp_pred = torch.where(voiced, (sf.b_k * ltp_taps).sum(-1),
                                   zero)[:, None]
            h3 = shp_w.gather(1, sf.harm_idx[:, i])
            n_ltp = torch.where(
                has_lag, harm * (0.25 * (h3[:, 0] + h3[:, 2])
                                 + 0.5 * h3[:, 1]), zero)[:, None]

            seeds = _silk_rand(seeds)
            sgn = torch.where(seeds < 0, -1.0, 1.0)

            lpc_pred = (a_k * s_lpc).sum(-1)                    # (S, N)
            n_ar = (ar_shp_k * s_ar2).sum(-1) + tilt * lf_ar
            n_lf = lf_ma * rings[:, :, _RSHAPE, head] + lf_ar_c * lf_ar

            x_i = sf.x_sc[:, i, None]
            r = x_i - (lpc_pred + ltp_pred - n_ar - n_lf - n_ltp)
            r = torch.clamp(sgn * r, -31.0, 30.0)

            q0i = _dead_zone_q0(r, offset, rdo, use_dz).to(torch.int32)
            v1 = _level_val(q0i, offset)
            v2 = torch.where(q0i == 0, v1 + (1.0 - QUANT_LEVEL_ADJUST),
                             torch.where(q0i == -1, offset, v1 + 1.0))
            rd1 = lam * v1.abs() + (r - v1) ** 2
            rd2 = lam * v2.abs() + (r - v2) ** 2
            swap = rd2 < rd1
            c0_rd = rd + torch.where(swap, rd2, rd1)
            c1_rd = rd + torch.where(swap, rd1, rd2)
            # both candidates of every state: (S, N, 2) planes
            vq = torch.stack([torch.where(swap, v2, v1),
                              torch.where(swap, v1, v2)], dim=-1)
            lexc = sgn[:, :, None] * vq + ltp_pred[:, :, None]
            xqv = lexc + lpc_pred[:, :, None]
            d = xqv - x_i[:, :, None]
            lfar = d - n_ar[:, :, None]
            cands = torch.stack([vq, lexc, xqv, d, lfar,
                                 lfar - n_lf[:, :, None]], dim=2)
            c0, c1 = cands[..., 0], cands[..., 1]               # (S, N, 6)

            head = (head + DD - 1) % DD
            last = torch.remainder(head + dd, DD)               # (S,)

            # the winner, and a penalty on states whose dither history
            # disagrees with its
            win = torch.argmin(c0_rd, dim=1)
            rr_last = r_rand.gather(
                2, last[:, None, None].expand(S, N, 1))[:, :, 0]
            bad = rr_last != rr_last.gather(1, win[:, None])
            c0_rd = torch.where(bad, c0_rd + BIG_RD, c0_rd)
            c1_rd = torch.where(bad, c1_rd + BIG_RD, c1_rd)

            # the worst head gives way to the best runner-up
            mx = torch.argmax(c0_rd, dim=1)
            mn = torch.argmin(c1_rd, dim=1)[:, None]
            c1_best = c1_rd.gather(1, mn)
            repm = (c1_best < c0_rd.gather(1, mx[:, None])) \
                & (ar_n[None, :] == mx[:, None])                # (S, N)
            src = torch.where(repm, mn, ar_n[None, :])          # (S, N)
            src3 = src[:, :, None]
            seeds = seeds.gather(1, src)
            seed_init = seed_init.gather(1, src)
            s_ar2 = s_ar2.gather(1, src3.expand(S, N, order))
            s_lpc = s_lpc.gather(1, src3.expand(S, N, LPC_ORDER))
            r_rand = r_rand.gather(1, src3.expand(S, N, DD))
            rings = rings.gather(1, src3[..., None].expand(S, N, 4, DD))
            # the replaced head takes the runner-up's candidate
            c0_rd = torch.where(repm, c1_best, c0_rd)
            c0 = torch.where(repm[:, :, None],
                             c1.gather(1, mn[:, :, None].expand(S, 1, 6)), c0)
            c0_q, c0l, c0x, c0d, c0f, c0s = c0.unbind(2)

            # delayed emission from the winner (after the replacement)
            wv = winner_rows(win).gather(
                2, last[:, None, None].expand(S, 4, 1))[:, :, 0]  # (S, 4)
            dg = delayed_gain.gather(1, last[:, None])[:, 0]
            q_out = torch.floor(wv[:, _RQ] + 0.5).to(torch.int32)
            committed = torch.stack([wv[:, _RXQ] * dg, wv[:, _RSHAPE],
                                     wv[:, _RPRED]], dim=1)     # (S, 3)
            if k == 0:
                emit = i >= dd
            elif k == 2:
                # streams that flushed fill their delay again; the others
                # kept their pipeline and emit every sample
                emit = ~flush2 | (i >= dd)
            else:
                emit = None
            pcol = torch.clamp(fo + i - dd, 0, L - 1)[:, None]
            xcol = torch.clamp(t - dd, 0, M + L - 1)[:, None, None] \
                .expand(S, 3, 1)
            if emit is not None:
                q_out = torch.where(emit, q_out, pulses.gather(1, pcol)[:, 0])
                committed = torch.where(emit[:, None], committed,
                                        work.gather(2, xcol)[:, :, 0])
            pulses.scatter_(1, pcol, q_out[:, None])
            work.scatter_(2, xcol, committed[:, :, None])

            # every state advances with its head candidate; the warped
            # rotation is a product and a sum over the last axis, so a
            # lane's arithmetic does not depend on the batch
            rhs = torch.cat(
                [(c0d + w[:, None] * s_ar2[:, :, 0])[:, :, None],
                 s_ar2[:, :, :-1] + w[:, None, None] * s_ar2[:, :, 1:]],
                dim=2)
            s_ar2 = (rhs[:, :, None, :] * Lw[:, None, :, :]).sum(-1)
            lf_ar = c0f
            diff = c0d
            s_lpc = torch.cat([c0x[:, :, None], s_lpc[:, :, :-1]], dim=2)
            rings[:, :, :, head] = torch.stack([c0_q, c0x, c0l, c0s], dim=-1)
            seeds = seeds + torch.floor(c0_q + 0.5).to(torch.int32)
            r_rand[:, :, head] = seeds
            rd = c0_rd
            delayed_gain[:, head] = gain
        lag_state = torch.where(voiced, lag, lag_state)

    # final flush and the winner's state
    rd, win = flush(rd, torch.clamp(params.gains[:, nb_subfr - 1],
                                    min=_MIN_GAIN), L)
    win1 = win[:, None]
    win3 = win[:, None, None]
    s_ar2_full = state.s_ar2.clone()
    s_ar2_full[:, :order] = s_ar2.gather(1, win3.expand(S, 1, order))[:, 0]
    new_state = NsqDelDecState(
        xq=xq_w[:, L:].clone(), shp=shp_w[:, L:].clone(),
        s_lpc=s_lpc.gather(1, win3.expand(S, 1, LPC_ORDER))[:, 0],
        s_ar2=s_ar2_full,
        s_lf_ar=lf_ar.gather(1, win1)[:, 0],
        s_diff=diff.gather(1, win1)[:, 0],
        lag_prev=torch.where(voiced, params.pitch_l[:, nb_subfr - 1],
                             torch.zeros_like(params.pitch_l[:, 0]))
        .to(torch.int32),
        prev_gain=prev_gain)
    seed_used = seed_init.gather(1, win1)[:, 0]
    return pulses, seed_used, new_state


# ---------------------------------------------------------------------------
# The kernels (csrc/silk_nsq.cu) and the host build of their arithmetic
# (csrc/silk_nsq.h): one launch a call, one block a stream.
# ---------------------------------------------------------------------------

# the executor's shape, the only one the kernels take
KERNEL_SHAPE = {"nb_subfr": 4, "sub": 80, "M": 320}
_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
_NB, _FRAME = KERNEL_SHAPE["nb_subfr"], KERNEL_SHAPE["sub"] * 4
# A batch's arrays at the kernels' shape, (name, dtype, a lane's shape), in
# the order of NsqArg in csrc/silk_nsq.h: the parameters (NsqParams'
# fields), the state (NsqDevState's), then, after the warping and its
# rotation, the outputs. parallel/nsq_batch.py stages the first two.
PARAM_FIELDS = (
    ("x", _F32, (_FRAME,)), ("a", _F32, (2, LPC_ORDER)),
    ("b", _F32, (_NB, LTP_ORDER)), ("ar_shp", _F32, (_NB, SHAPE_ORDER)),
    ("harm", _F32, (_NB,)), ("tilt", _F32, (_NB,)), ("lf_ma", _F32, (_NB,)),
    ("lf_ar", _F32, (_NB,)), ("gains", _F32, (_NB,)),
    ("pitch_l", _I32, (_NB,)), ("lam", _F32, ()), ("offset", _F32, ()),
    ("voiced", _BOOL, ()), ("seed", _I32, ()), ("ltp_scale", _F32, ()),
    ("interp", _BOOL, ()))
STATE_FIELDS = (
    ("xq", _F32, (KERNEL_SHAPE["M"],)), ("shp", _F32, (KERNEL_SHAPE["M"],)),
    ("s_lpc", _F32, (LPC_ORDER,)), ("s_ar2", _F32, (SHAPE_ORDER,)),
    ("s_lf_ar", _F32, ()), ("s_diff", _F32, ()), ("lag_prev", _I32, ()),
    ("prev_gain", _F32, ()))
# pulses, the single state's unscaled frame, the delayed decision's
# winning seed, the new state
OUTPUT_FIELDS = (("pulses", _I32, (_FRAME,)), ("xq_frame", _F32, (_FRAME,)),
                 ("seed_used", _I32, ()), *STATE_FIELDS)
_N_ARGS = len(PARAM_FIELDS) + len(STATE_FIELDS) + 2 + len(OUTPUT_FIELDS)


def _kernel_inputs(params: NsqParams, state, nb_subfr: int, sub: int,
                   M: int, order: int) -> tuple[list, torch.device]:
    """Check a call against what the kernels take (the executor's shape,
    the dtypes the executor gives, every tensor on one device); returns
    the parameters and the state, contiguous, in NsqArg's order, and the
    device. Raises on anything else."""
    if {"nb_subfr": nb_subfr, "sub": sub, "M": M} != KERNEL_SHAPE:
        raise ValueError(f"the quantizer kernels take {KERNEL_SHAPE}, got "
                         f"nb_subfr={nb_subfr}, sub={sub}, M={M}")
    if not 1 <= order <= SHAPE_ORDER:
        raise ValueError(f"order {order} outside [1, {SHAPE_ORDER}]")
    S = params.x.shape[0]
    dev = params.x.device
    out = []
    for (name, dtype, lane), t in zip((*PARAM_FIELDS, *STATE_FIELDS),
                                      (*params, *state)):
        if t.dtype != dtype or tuple(t.shape) != (S, *lane):
            raise TypeError(f"{name} must be {(S, *lane)} {dtype}, got "
                            f"{tuple(t.shape)} {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        out.append(t.contiguous())
    return out, dev


def _outputs(S: int, dev, del_dec: bool) -> dict:
    """A quantizer's outputs, uninitialised (the kernel writes every
    element): pulses, the unscaled frame (single state) or the winning
    seed (delayed decision), the new state."""
    skip = "xq_frame" if del_dec else "seed_used"
    return {name: torch.empty((S, *lane), dtype=dtype, device=dev)
            for name, dtype, lane in OUTPUT_FIELDS if name != skip}


def _pointers(inputs: list, w, lw, outs: dict):
    """The array of NsqArg's pointers (0 for what the call does not use)."""
    ptrs = [t.data_ptr() for t in inputs]
    ptrs += [0 if t is None else t.data_ptr() for t in (w, lw)]
    ptrs += [outs[name].data_ptr() if name in outs else 0
             for name, *_ in OUTPUT_FIELDS]
    return (ctypes.c_void_p * _N_ARGS)(*ptrs)


def _rotation(w: torch.Tensor, order: int) -> torch.Tensor:
    """Lw[s, j, m] = (-w[s])^(j - m) for j >= m, else 0: the plain
    version's expression, for w of shape (n,)."""
    jj = torch.arange(order, device=w.device)
    dpow = jj[:, None] - jj[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=w.device)
    return torch.where(dpow >= 0,
                       torch.pow(-w[:, None, None], torch.clamp(dpow, min=0)),
                       zero)


# (warping, order, device) -> (w (1,), Lw (1, order, order)) of a warping
# given as a number on the card: built once, read by every stream
# (stride 0)
_ROTATIONS: dict = {}


def _warp_args(warping, S: int, order: int, dev, per_stream: bool):
    """(w, w stride, Lw, Lw stride) of the delayed decision on `dev`: for
    every stream as the plain version builds them where `per_stream` (or
    the warping is a tensor), else once for a number."""
    if per_stream or isinstance(warping, torch.Tensor):
        w = torch.as_tensor(warping, dtype=torch.float32, device=dev) \
            .expand(S).contiguous()
        return w, 1, _rotation(w, order).contiguous(), order * order
    key = (float(warping), order, str(dev))
    if key not in _ROTATIONS:
        w = torch.as_tensor(warping, dtype=torch.float32,
                            device=dev).reshape(1)
        _ROTATIONS[key] = (w, _rotation(w, order).contiguous())
    w, lw = _ROTATIONS[key]
    return w, 0, lw, 0


_P, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# each entry point's arguments: the pointer array, S and order, the
# delayed decision's strides of w and Lw, the kernels' CUDA stream
_ARGTYPES = {
    "mousiki_nsq_frame": [_P, _INT, _INT, _P],
    "mousiki_nsq_del_dec": [_P, _INT, _INT, _I64, _I64, _P],
    "silk_nsq_host_frame": [_P, _INT, _INT],
    "silk_nsq_host_del_dec": [_P, _INT, _INT, _I64, _I64],
}


def _entry(lib, symbol: str):
    fn = getattr(lib, symbol)
    fn.argtypes = _ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return fn


def build_kernel() -> None:
    """Compile and load the quantizer kernels now (they are otherwise
    built on first launch)."""
    _build.load("silk_nsq")


def _run(params, state, nb_subfr: int, sub: int, M: int, order: int,
         warping, host: bool) -> dict:
    """One quantizer call (the delayed decision where `warping` is not
    None) through the kernel, on CUDA tensors, or through the host build
    of its arithmetic, on CPU tensors (`host`); returns the outputs."""
    inputs, dev = _kernel_inputs(params, state, nb_subfr, sub, M, order)
    if host != (dev.type == "cpu"):
        raise ValueError(f"the {'host build' if host else 'kernel'} does "
                         f"not take tensors on {dev}")
    del_dec = warping is not None
    S = params.x.shape[0]
    outs = _outputs(S, dev, del_dec)
    if S == 0:
        return outs
    w = lw = None
    strides = ()
    if del_dec:
        w, w_stride, lw, lw_stride = _warp_args(warping, S, order, dev, host)
        strides = (w_stride, lw_stride)
    ptrs = _pointers(inputs, w, lw, outs)
    name = "del_dec" if del_dec else "frame"
    if host:
        symbol = f"silk_nsq_host_{name}"
        rc = _entry(_build.load_silk_nsq_host(), symbol)(ptrs, S, order,
                                                         *strides)
    else:
        symbol = f"mousiki_nsq_{name}"
        fn = _entry(_build.load("silk_nsq"), symbol)
        with torch.cuda.device(dev):
            rc = fn(ptrs, S, order, *strides,
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} failed: "
                           f"{'' if host else 'cuda error '}{rc}")
    return outs


def _frame_result(outs: dict):
    return (outs["pulses"], outs["xq_frame"],
            NsqDevState(*(outs[k] for k in NsqDevState._fields)))


def _del_dec_result(outs: dict):
    return (outs["pulses"], outs["seed_used"],
            NsqDelDecState(*(outs[k] for k in NsqDelDecState._fields)))


def _on_cpu(params: NsqParams) -> bool:
    dev = params.x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the quantizers run on cpu or cuda, not {dev}")
    return dev.type == "cpu"


def _states(n_states: int) -> None:
    if n_states != MAX_DD_STATES:
        raise ValueError(f"the delayed-decision kernel runs "
                         f"{MAX_DD_STATES} states, not {n_states}")


def nsq_frame(params: NsqParams, state: NsqDevState, *, nb_subfr: int = 4,
              sub: int = 80, M: int = 320, order: int = SHAPE_ORDER):
    """Quantize one frame for S streams. Returns (pulses (S, L) int32,
    xq_frame (S, L) unscaled quantized output, new state).

    CPU tensors take `nsq_frame_reference`; CUDA tensors launch
    nsq_frame_kernel once, and raise on a shape, dtype or device the
    kernel does not take."""
    if _on_cpu(params):
        return nsq_frame_reference(params, state, nb_subfr=nb_subfr,
                                   sub=sub, M=M, order=order)
    outs = _run(params, state, nb_subfr, sub, M, order, None, host=False)
    if params.x.shape[0]:
        global nsq_frame_launches
        nsq_frame_launches += 1
    return _frame_result(outs)


def nsq_del_dec_frame(params: NsqParams, state: NsqDelDecState, *,
                      nb_subfr: int = 4, sub: int = 80, M: int = 320,
                      order: int = SHAPE_ORDER,
                      n_states: int = MAX_DD_STATES, warping=0.0):
    """Delayed-decision quantize of one frame for S streams.

    Returns (pulses (S, L) int32, seed_used (S,) int32, new state).
    warping: a number or an (S,) tensor, the allpass coefficient of the
    shaping chain (0 = a plain delay line).

    CPU tensors take `nsq_del_dec_frame_reference`; CUDA tensors launch
    nsq_del_dec_kernel once (its rotation Lw built by the plain version's
    expression, once for a warping given as a number), and raise on a
    shape, dtype, device or number of states the kernel does not take."""
    if _on_cpu(params):
        return nsq_del_dec_frame_reference(
            params, state, nb_subfr=nb_subfr, sub=sub, M=M, order=order,
            n_states=n_states, warping=warping)
    _states(n_states)
    outs = _run(params, state, nb_subfr, sub, M, order, warping, host=False)
    if params.x.shape[0]:
        global nsq_del_dec_launches
        nsq_del_dec_launches += 1
    return _del_dec_result(outs)


def nsq_frame_host(params: NsqParams, state: NsqDevState, *,
                   nb_subfr: int = 4, sub: int = 80, M: int = 320,
                   order: int = SHAPE_ORDER):
    """`nsq_frame` on CPU tensors through the host build of the kernel's
    arithmetic (csrc/silk_nsq.h), the streams one after another."""
    return _frame_result(_run(params, state, nb_subfr, sub, M, order, None,
                              host=True))


def nsq_del_dec_frame_host(params: NsqParams, state: NsqDelDecState, *,
                           nb_subfr: int = 4, sub: int = 80, M: int = 320,
                           order: int = SHAPE_ORDER,
                           n_states: int = MAX_DD_STATES, warping=0.0):
    """`nsq_del_dec_frame` on CPU tensors through the host build of the
    kernel's arithmetic, the rotation Lw built for every stream as the
    plain version builds it."""
    _states(n_states)
    return _del_dec_result(_run(params, state, nb_subfr, sub, M, order,
                                warping, host=True))
