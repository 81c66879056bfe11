"""SILK encoder (mono, 10/20 ms): produces valid SILK streams.

The normative symbol writers (gains_quant, NLSF stage-1/2 encode,
encode_indices incl. voiced pitch/LTP coding, encode_pulses with shell
coder + LSB escapes) mirror libopus exactly. The analysis side (LPC, pitch
search, LTP codebook fit, gain selection) is float/greedy (reference
src/silk/{pitch_analysis_core,find_ltp,nsq}.rs); the excitation quantizer
runs closed-loop against an embedded bit-exact MIRROR of the decoder state
(ChannelDecoderState), so the encoder tracks exactly what any conformant
decoder reconstructs — voiced LTP feedback included — with zero drift.
"""

from __future__ import annotations

import math

import numpy as np

from . import tables as T
from .dec_api import DecCtrl, decoder_set_fs
from .decode_core import decode_core, lpc_analysis_filter, silk_rand
from .decode_indices import nlsf_unpack
from .decode_params import (INV_SCALE_Q16, N_LEVELS_QGAIN,
                            NLSF_QUANT_LEVEL_ADJ_Q10, OFFSET_GQ,
                            decode_parameters, decode_pitch, nlsf_stabilize,
                            nlsf2a)
from .decode_pulses import (LOG2_SHELL_CODEC_FRAME_LENGTH, N_RATE_LEVELS,
                            SHELL_CODEC_FRAME_LENGTH, SILK_MAX_PULSES)
from .fixed_math import (i16, i32, sat16, silk_log2lin, silk_lin2log, smulbb,
                         smulwb)
from .structs import (LTP_ORDER, MAX_LPC_ORDER, ChannelDecoderState,
                      NLSF_CB_NB_MB, NLSF_CB_WB, TYPE_UNVOICED, TYPE_VOICED)

SCALE_Q16 = (65536 * (N_LEVELS_QGAIN - 1)) // (((88 - 2) * 128) // 6)
QUANT_LEVEL_ADJUST_Q10 = 80
# Prediction-LPC bandwidth expansion: Levinson with clamped reflections is
# already minimum-phase; light expansion keeps coarse-rate closed-loop
# reconstruction stable without capping prediction gain (tuned on the
# tools/silk_quality_report.py corpus + the 8 kHz tone API tests).
LPC_BWEXP = float(__import__("os").environ.get("SILK_BWEXP", "0.99"))
# Exponent coupling the byte-budget retry into the NSQ RD lambda
# (experimental nsq-shaping path only; see silk/noise_shape.py).
NSQ_LAMBDA_COUPLING = float(__import__("os").environ.get("SILK_LAMX", "0.7"))


class _BudgetExceeded(Exception):
    """Raised when an encode attempt would overflow the byte budget."""


def gains_quant(gains_q16, prev_ind, conditional, nb_subfr):
    """Quantize subframe gains; returns (indices, dequant gains, prev_ind)."""
    ind = [0] * nb_subfr
    out = [0] * nb_subfr
    for k in range(nb_subfr):
        ind[k] = smulwb(SCALE_Q16, silk_lin2log(gains_q16[k]) - OFFSET_GQ)
        if ind[k] < prev_ind:
            ind[k] += 1
        ind[k] = max(0, min(N_LEVELS_QGAIN - 1, ind[k]))
        if k == 0 and not conditional:
            ind[k] = max(min(ind[k], N_LEVELS_QGAIN - 1),
                         prev_ind + T.MIN_DELTA_GAIN_QUANT)
            ind[k] = max(ind[k], prev_ind - 16)
            prev_ind = ind[k]
        else:
            ind[k] = ind[k] - prev_ind
            double_step = 2 * T.MAX_DELTA_GAIN_QUANT - N_LEVELS_QGAIN + prev_ind
            if ind[k] > double_step:
                ind[k] = double_step + ((ind[k] - double_step + 1) >> 1)
            ind[k] = max(T.MIN_DELTA_GAIN_QUANT,
                         min(T.MAX_DELTA_GAIN_QUANT, ind[k]))
            if ind[k] > double_step:
                prev_ind += (ind[k] << 1) - double_step
                prev_ind = min(prev_ind, N_LEVELS_QGAIN - 1)
            else:
                prev_ind += ind[k]
            ind[k] -= T.MIN_DELTA_GAIN_QUANT
        out[k] = silk_log2lin(min(smulwb(INV_SCALE_Q16, prev_ind) + OFFSET_GQ,
                                  3967))
    return ind, out, prev_ind


def nlsf_encode(nlsf_q15, cb, signal_type):
    """Stage-1 weighted NN search + greedy stage-2 residual quantization.

    Returns (indices list [stage1, res...], coded nlsf_q15)."""
    order = cb.order
    half = (1 if signal_type == 2 else 0) * cb.n_vectors
    # stage 1: nearest codebook vector (weighted squared error)
    best_i1 = 0
    best_err = None
    for i1 in range(cb.n_vectors):
        base = i1 * order
        err = 0.0
        for i in range(order):
            d = (nlsf_q15[i] - (cb.cb1_nlsf_q8[base + i] << 7)) / 32768.0
            err += d * d * cb.cb1_wght_q9[base + i]
        if best_err is None or err < best_err:
            best_err = err
            best_i1 = i1
    ec_ix, pred_q8 = nlsf_unpack(cb, best_i1)
    base = best_i1 * order
    # residual targets in Q10 of the weighted domain
    targets = [0.0] * order
    for i in range(order):
        w = cb.cb1_wght_q9[base + i]
        targets[i] = ((nlsf_q15[i] - (cb.cb1_nlsf_q8[base + i] << 7)) * w) / (1 << 14)
    # greedy backward quantization mirroring the decoder recursion
    indices = [0] * order
    out_q10 = 0
    for i in range(order - 1, -1, -1):
        pred_q10 = smulbb(out_q10, pred_q8[i]) >> 8
        best = None
        for cand in range(-10, 11):
            v = i16(cand << 10)
            if v > 0:
                v = i16(v - NLSF_QUANT_LEVEL_ADJ_Q10)
            elif v < 0:
                v = i16(v + NLSF_QUANT_LEVEL_ADJ_Q10)
            # decoder: out = smlawb(pred, v, step_q16) = pred + (v*step)>>16
            recon = pred_q10 + ((v * cb.quant_step_size_q16) >> 16)
            e = abs(recon - targets[i])
            if best is None or e < best[0]:
                best = (e, cand)
        indices[i] = best[1]
        # propagate the decoder-exact reconstruction
        v = i16(indices[i] << 10)
        if v > 0:
            v = i16(v - NLSF_QUANT_LEVEL_ADJ_Q10)
        elif v < 0:
            v = i16(v + NLSF_QUANT_LEVEL_ADJ_Q10)
        out_q10 = i16(pred_q10 + ((v * cb.quant_step_size_q16) >> 16))
    from .decode_params import nlsf_decode
    coded = nlsf_decode([best_i1] + indices, cb)
    return [best_i1] + indices, coded


def encode_indices(st_like, enc, ix, cond_coding, pitch_contour_icdf=None,
                   pitch_low_icdf=None):
    """Mirror of decode_indices for the symbol stream."""
    # signal type / quant offset
    typ = (ix.signal_type << 1) + ix.quant_offset_type
    if typ >= 2:
        enc.enc_icdf(typ - 2, T.SILK_TYPE_OFFSET_VAD_ICDF, 8)
    else:
        enc.enc_icdf(typ, T.SILK_TYPE_OFFSET_NO_VAD_ICDF, 8)
    # gains
    if cond_coding == 2:
        enc.enc_icdf(ix.gains_indices[0], T.SILK_DELTA_GAIN_ICDF, 8)
    else:
        enc.enc_icdf(ix.gains_indices[0] >> 3,
                     T.SILK_GAIN_ICDF[ix.signal_type], 8)
        enc.enc_icdf(ix.gains_indices[0] & 7, T.SILK_UNIFORM8_ICDF, 8)
    for i in range(1, st_like.nb_subfr):
        enc.enc_icdf(ix.gains_indices[i], T.SILK_DELTA_GAIN_ICDF, 8)
    # NLSF
    cb = st_like.psnlsf_cb
    half = (1 if ix.signal_type == 2 else 0) * cb.n_vectors
    enc.enc_icdf(ix.nlsf_indices[0], cb.cb1_icdf[half: half + cb.n_vectors], 8)
    ec_ix, _ = nlsf_unpack(cb, ix.nlsf_indices[0])
    for i in range(cb.order):
        val = ix.nlsf_indices[i + 1]
        icdf = cb.ec_icdf[ec_ix[i]: ec_ix[i] + 9]
        if val >= 4:
            enc.enc_icdf(8, icdf, 8)
            enc.enc_icdf(val - 4, T.SILK_NLSF_EXT_ICDF, 8)
        elif val <= -4:
            enc.enc_icdf(0, icdf, 8)
            enc.enc_icdf(-val - 4, T.SILK_NLSF_EXT_ICDF, 8)
        else:
            enc.enc_icdf(val + 4, icdf, 8)
    if st_like.nb_subfr == 4:
        enc.enc_icdf(ix.nlsf_interp_coef_q2,
                     T.SILK_NLSF_INTERPOLATION_FACTOR_ICDF, 8)
    if ix.signal_type == 2:  # TYPE_VOICED: pitch lag, contour, LTP, scale
        coded_delta = False
        if cond_coding == 2 and st_like.ec_prev_signal_type == 2:
            delta = ix.lag_index - st_like.ec_prev_lag_index + 9
            if 1 <= delta <= 20 and delta != 9:
                enc.enc_icdf(delta, T.PITCH_DELTA_ICDF, 8)
                coded_delta = True
            else:
                enc.enc_icdf(0, T.PITCH_DELTA_ICDF, 8)
        if not coded_delta:
            half = st_like.fs_khz >> 1
            enc.enc_icdf(ix.lag_index // half, T.PITCH_LAG_ICDF, 8)
            enc.enc_icdf(ix.lag_index % half,
                         st_like.pitch_lag_low_bits_icdf, 8)
        st_like.ec_prev_lag_index = ix.lag_index
        enc.enc_icdf(ix.contour_index, st_like.pitch_contour_icdf, 8)
        enc.enc_icdf(ix.per_index, T.SILK_LTP_PER_INDEX_ICDF, 8)
        for k in range(st_like.nb_subfr):
            enc.enc_icdf(ix.ltp_index[k],
                         T.SILK_LTP_GAIN_ICDF_PTRS[ix.per_index], 8)
        if cond_coding == 0:
            enc.enc_icdf(ix.ltp_scale_index, T.SILK_LTPSCALE_ICDF, 8)
    st_like.ec_prev_signal_type = ix.signal_type
    enc.enc_icdf(ix.seed, T.SILK_UNIFORM4_ICDF, 8)


def _combine_and_check(inp, max_pulses):
    out = []
    bad = False
    for k in range(len(inp) // 2):
        s = inp[2 * k] + inp[2 * k + 1]
        if s > max_pulses:
            bad = True
        out.append(s)
    return out, bad


def _shell_encode(enc, abs_pulses16):
    t0, t1, t2, t3 = T.SILK_SHELL_CODE_TABLES
    offs = T.SILK_SHELL_CODE_TABLE_OFFSETS

    def enc_split(child1, p, table):
        if p > 0:
            o = offs[p]
            enc.enc_icdf(child1, table[o: o + p + 1], 8)

    p1 = [abs_pulses16[2 * i] + abs_pulses16[2 * i + 1] for i in range(8)]
    p2 = [p1[2 * i] + p1[2 * i + 1] for i in range(4)]
    p3 = [p2[2 * i] + p2[2 * i + 1] for i in range(2)]
    p4 = p3[0] + p3[1]
    enc_split(p3[0], p4, t3)
    enc_split(p2[0], p3[0], t2)
    enc_split(p1[0], p2[0], t1)
    enc_split(abs_pulses16[0], p1[0], t0)
    enc_split(abs_pulses16[2], p1[1], t0)
    enc_split(p1[2], p2[1], t1)
    enc_split(abs_pulses16[4], p1[2], t0)
    enc_split(abs_pulses16[6], p1[3], t0)
    enc_split(p2[2], p3[1], t2)
    enc_split(p1[4], p2[2], t1)
    enc_split(abs_pulses16[8], p1[4], t0)
    enc_split(abs_pulses16[10], p1[5], t0)
    enc_split(p1[6], p2[3], t1)
    enc_split(abs_pulses16[12], p1[6], t0)
    enc_split(abs_pulses16[14], p1[7], t0)


def encode_pulses(enc, signal_type, quant_offset_type, pulses, frame_length):
    """Normative excitation encode (mirror of decode_pulses)."""
    n_blocks = frame_length >> LOG2_SHELL_CODEC_FRAME_LENGTH
    if n_blocks * SHELL_CODEC_FRAME_LENGTH < frame_length:
        n_blocks += 1
    padded = list(pulses) + [0] * (n_blocks * 16 - len(pulses))
    abs_pulses = [abs(p) for p in padded]
    sum_pulses = [0] * n_blocks
    n_rshifts = [0] * n_blocks
    scaled_abs = list(abs_pulses)
    for i in range(n_blocks):
        blk = scaled_abs[i * 16:(i + 1) * 16]
        while True:
            l1, bad1 = _combine_and_check(blk, T.SILK_MAX_PULSES_TABLE[0])
            l2, bad2 = _combine_and_check(l1, T.SILK_MAX_PULSES_TABLE[1])
            l3, bad3 = _combine_and_check(l2, T.SILK_MAX_PULSES_TABLE[2])
            l4, bad4 = _combine_and_check(l3, T.SILK_MAX_PULSES_TABLE[3])
            if bad1 or bad2 or bad3 or bad4:
                n_rshifts[i] += 1
                blk = [v >> 1 for v in blk]
            else:
                sum_pulses[i] = l4[0]
                break
        scaled_abs[i * 16:(i + 1) * 16] = blk

    # choose rate level by estimated bits
    best = None
    for k in range(N_RATE_LEVELS - 1):
        bits = T.SILK_RATE_LEVELS_BITS_Q5[signal_type >> 1][k]
        nb = T.SILK_PULSES_PER_BLOCK_BITS_Q5[k]
        for i in range(n_blocks):
            if n_rshifts[i] > 0:
                bits += nb[SILK_MAX_PULSES + 1]
            else:
                bits += nb[sum_pulses[i]]
        if best is None or bits < best[0]:
            best = (bits, k)
    rate_level = best[1]
    enc.enc_icdf(rate_level, T.SILK_RATE_LEVELS_ICDF[signal_type >> 1], 8)
    cdf = T.SILK_PULSES_PER_BLOCK_ICDF[rate_level]
    last_cdf = T.SILK_PULSES_PER_BLOCK_ICDF[N_RATE_LEVELS - 1]
    for i in range(n_blocks):
        if n_rshifts[i] == 0:
            enc.enc_icdf(sum_pulses[i], cdf, 8)
        else:
            enc.enc_icdf(SILK_MAX_PULSES + 1, cdf, 8)
            for _ in range(n_rshifts[i] - 1):
                enc.enc_icdf(SILK_MAX_PULSES + 1, last_cdf, 8)
            enc.enc_icdf(sum_pulses[i], last_cdf, 8)
    for i in range(n_blocks):
        if sum_pulses[i] > 0:
            _shell_encode(enc, scaled_abs[i * 16:(i + 1) * 16])
    for i in range(n_blocks):
        if n_rshifts[i] > 0:
            nls = n_rshifts[i]
            for k in range(16):
                abs_q = abs(padded[i * 16 + k])
                for j in range(nls - 1, 0, -1):
                    enc.enc_icdf((abs_q >> j) & 1, T.SILK_LSB_ICDF, 8)
                enc.enc_icdf(abs_q & 1, T.SILK_LSB_ICDF, 8)
            sum_pulses[i] |= nls << 5
    # signs
    base = 7 * (quant_offset_type + (signal_type << 1))
    icdf_row = T.SILK_SIGN_ICDF[base: base + 7]
    for i in range(n_blocks):
        p = sum_pulses[i]
        if p > 0:
            icdf = [icdf_row[min(p & 0x1F, 6)], 0]
            for j in range(16):
                q = padded[i * 16 + j]
                if q != 0:
                    enc.enc_icdf(0 if q < 0 else 1, icdf, 8)


def encode_core(st, ctrl, x, pulses_out, mute=False, res=None, fb_gamma=0.8):
    """Closed-loop excitation quantization: decode_core with the pulse
    decision inserted at each sample (reference src/silk/nsq.rs, zero
    noise shaping). Mutates the mirror decoder state `st` exactly like
    decode_core would for the chosen pulses; returns xq (int16 list)."""
    ix = st.indices
    offset_q10 = T.SILK_QUANTIZATION_OFFSETS_Q10[ix.signal_type >> 1][
        ix.quant_offset_type]
    nlsf_interp_flag = 1 if ix.nlsf_interp_coef_q2 < 4 else 0
    from .fixed_math import (add_sat32, lshift_sat32, rshift_round,
                             silk_div32_varq, silk_inverse32_varq, smlawb,
                             smulww)

    rand_seed = i32(ix.seed)
    exc = st.exc_q14
    sLPC = list(st.s_lpc_q14_buf) + [0] * st.subfr_length
    sLTP = [0] * st.ltp_mem_length
    sLTP_q15 = [0] * (st.ltp_mem_length + st.frame_length)
    xq = [0] * st.frame_length
    sLTP_buf_idx = st.ltp_mem_length
    lag = 0
    off16 = offset_q10 << 4
    adj16 = QUANT_LEVEL_ADJUST_Q10 << 4

    def quant_exc(want):
        """Choose the pulse whose decoded excitation best matches `want`."""
        if mute:
            return 0
        base = want - off16
        q = int(round(base / 16384.0))
        bestq, beste = 0, None
        for cand in (q - 1, q, q + 1):
            v = cand << 14
            if v > 0:
                v -= adj16
            elif v < 0:
                v += adj16
            v += off16
            e = abs(v - want)
            if beste is None or e < beste:
                beste, bestq = e, cand
        return max(-1000, min(1000, bestq))

    for k in range(st.nb_subfr):
        A_q12 = ctrl.pred_coef_q12[k >> 1]
        B_q14 = ctrl.ltp_coef_q14[k * LTP_ORDER:(k + 1) * LTP_ORDER]
        signal_type = ix.signal_type

        gain_q10 = ctrl.gains_q16[k] >> 6
        inv_gain_q31 = silk_inverse32_varq(ctrl.gains_q16[k], 47)
        inv_gain_f = (1 << 30) / ctrl.gains_q16[k]

        if ctrl.gains_q16[k] != st.prev_gain_q16:
            gain_adj_q16 = silk_div32_varq(st.prev_gain_q16,
                                           ctrl.gains_q16[k], 16)
            for i in range(MAX_LPC_ORDER):
                sLPC[i] = smulww(gain_adj_q16, sLPC[i])
        else:
            gain_adj_q16 = 1 << 16
        st.prev_gain_q16 = ctrl.gains_q16[k]

        if signal_type == TYPE_VOICED:
            lag = ctrl.pitch_l[k]
            if k == 0 or (k == 2 and nlsf_interp_flag):
                start_idx = (st.ltp_mem_length - lag - st.lpc_order
                             - LTP_ORDER // 2)
                assert start_idx > 0
                if k == 2:
                    st.out_buf[st.ltp_mem_length:
                               st.ltp_mem_length + 2 * st.subfr_length] = \
                        xq[: 2 * st.subfr_length]
                scratch = [0] * (st.ltp_mem_length - start_idx)
                lpc_analysis_filter(scratch, st.out_buf,
                                    start_idx + k * st.subfr_length, A_q12,
                                    st.ltp_mem_length - start_idx,
                                    st.lpc_order)
                for i2, v in enumerate(scratch):
                    sLTP[start_idx + i2] = v
                if k == 0:
                    inv_gain_q31 = i32(
                        smulwb(inv_gain_q31, ctrl.ltp_scale_q14) << 2)
                for i in range(lag + LTP_ORDER // 2):
                    sLTP_q15[sLTP_buf_idx - i - 1] = smulwb(
                        inv_gain_q31, sLTP[st.ltp_mem_length - i - 1])
            else:
                if gain_adj_q16 != 1 << 16:
                    for i in range(lag + LTP_ORDER // 2):
                        sLTP_q15[sLTP_buf_idx - i - 1] = smulww(
                            gain_adj_q16, sLTP_q15[sLTP_buf_idx - i - 1])

        pl = sLTP_buf_idx - lag + LTP_ORDER // 2
        for i in range(st.subfr_length):
            n = k * st.subfr_length + i
            # predictions (independent of the current sample's pulse)
            if signal_type == TYPE_VOICED:
                ltp_pred_q13 = 2
                ltp_pred_q13 = smlawb(ltp_pred_q13, sLTP_q15[pl + 0], B_q14[0])
                ltp_pred_q13 = smlawb(ltp_pred_q13, sLTP_q15[pl - 1], B_q14[1])
                ltp_pred_q13 = smlawb(ltp_pred_q13, sLTP_q15[pl - 2], B_q14[2])
                ltp_pred_q13 = smlawb(ltp_pred_q13, sLTP_q15[pl - 3], B_q14[3])
                ltp_pred_q13 = smlawb(ltp_pred_q13, sLTP_q15[pl - 4], B_q14[4])
                pl += 1
            else:
                ltp_pred_q13 = 0
            lpc_pred_q10 = st.lpc_order >> 1
            for j in range(st.lpc_order):
                lpc_pred_q10 = smlawb(lpc_pred_q10,
                                      sLPC[MAX_LPC_ORDER + i - 1 - j],
                                      A_q12[j])
            # target excitation: open-loop whitened residual plus damped
            # closed-loop correction. Full feedback (gamma=1) is unstable at
            # coarse quantization (the LPC synthesis filter amplifies the
            # fed-back rounding noise); gamma<1 bounds it while still pulling
            # the reconstruction toward the input (noise-shaping role of the
            # reference NSQ, src/silk/nsq.rs).
            slpc_target = x[n] * inv_gain_f
            res_target_cl = slpc_target - (lpc_pred_q10 << 4)
            if res is not None:
                e_ol = res[n] * inv_gain_f
                res_target = e_ol + fb_gamma * (res_target_cl - e_ol)
            else:
                res_target = res_target_cl
            if signal_type == TYPE_VOICED:
                exc_target = res_target - (ltp_pred_q13 << 1)
            else:
                exc_target = res_target
            rand_seed = silk_rand(rand_seed)
            want = -exc_target if rand_seed < 0 else exc_target
            pulse = quant_exc(want)
            pulses_out[n] = pulse
            # exact decoder reconstruction for the chosen pulse
            v = i32(pulse << 14)
            if v > 0:
                v -= adj16
            elif v < 0:
                v += adj16
            v = i32(v + off16)
            if rand_seed < 0:
                v = -v
            exc[n] = v
            rand_seed = i32(rand_seed + pulse)
            if signal_type == TYPE_VOICED:
                res_q14 = i32(exc[n] + i32(ltp_pred_q13 << 1))
                sLTP_q15[sLTP_buf_idx] = i32(res_q14 << 1)
                sLTP_buf_idx += 1
            else:
                res_q14 = exc[n]
            sLPC[MAX_LPC_ORDER + i] = add_sat32(res_q14,
                                                lshift_sat32(lpc_pred_q10, 4))
            xq[n] = sat16(rshift_round(
                smulww(sLPC[MAX_LPC_ORDER + i], gain_q10), 8))
        sLPC[:MAX_LPC_ORDER] = sLPC[st.subfr_length:
                                    st.subfr_length + MAX_LPC_ORDER]

    st.s_lpc_q14_buf[:] = sLPC[:MAX_LPC_ORDER]
    return xq


class SilkEncoder:
    """Mono SILK encoder state (fs 8/12/16 kHz internal).

    Embeds a mirror ChannelDecoderState that is advanced with the exact
    decoder arithmetic after every frame, so closed-loop quantization sees
    precisely the state any conformant decoder will have."""

    def __init__(self):
        self.fs_khz = 0
        self.api_fs_hz = 0
        self.seed_ctr = 0
        self.first = True
        self.resampler = None
        self.mirror = ChannelDecoderState()
        self.x_hist = None  # float input history at internal rate
        self.fb_gamma = None  # None = auto by quantizer fineness
        self.fec_enabled = False
        self.lbrr_store = None  # (ix, pulses) of the previous frame's LBRR
        from .lp_filter import LpState
        from .noise_shape import NsqState, ShapeState
        self.lp = LpState()  # bandwidth-transition low-pass
        # noise-shaping quality stack (reference noise_shape_analysis_flp /
        # process_gains_flp / nsq.rs); see silk/noise_shape.py
        self.shape = ShapeState()
        self.nsq = NsqState(0)
        # fixed-point noise-estimator VAD (reference vad.rs): continuous
        # speech activity + input tilt + per-band quality driving the
        # shaping lambda, pitch thresholds and quant-offset decision
        from .vad import VadState
        self.vad = VadState()
        # Reference analysis chain + noise-shaping NSQ (enc_analysis.py +
        # noise_shape.py): default ON -- beats libopus on the speech
        # corpus at every rate (QUALITY_SILK.md). SILK_NSQ_SHAPING=0
        # selects the legacy open-loop mirror-state quantizer.
        self.use_nsq_shaping = bool(int(
            __import__("os").environ.get("SILK_NSQ_SHAPING", "1")))
        # Delayed-decision trellis NSQ + warped shaping (the reference's
        # default-complexity quantizer, nsq_del_dec.rs:83 /
        # control_codec.rs:326): 4 states, shaping order 24, warped
        # feedback. SILK_NSQ_DELDEC=0 selects the single-state nsq.rs
        # port (the device-kernel-compatible path).
        self.use_del_dec = bool(int(
            __import__("os").environ.get("SILK_NSQ_DELDEC", "1")))
        self.n_del_dec_states = 4
        # reference analysis-chain state (enc_analysis.py): previous pitch
        # lag + LTP correlation (pitch-search biases), quantized NLSF of
        # the previous frame (interpolation), LTP gain budget
        self.prev_lag = 0
        self.prev_ltp_corr = 0.0
        self.prev_nlsf_q15 = None
        self.sum_log_gain_q7 = 0
        self.prev_voiced = False
        # cross-frame integral rate control: multiplies the quantization-
        # gain scale so active-frame bits track the target (the streaming
        # analogue of libopus's per-frame gain_mult retry loop); included
        # in snapshot/restore so the byte-budget retry attempts in
        # opus_encoder._encode_silk don't pollute it
        self.rate_mult = 1.0

    def snapshot(self):
        import copy
        return (self.fs_khz, self.api_fs_hz, self.seed_ctr, self.first,
                copy.deepcopy(self.resampler), copy.deepcopy(self.mirror),
                None if self.x_hist is None else self.x_hist.copy(),
                copy.deepcopy(self.lbrr_store), copy.deepcopy(self.lp),
                self.rate_mult, copy.deepcopy(self.shape),
                (copy.deepcopy(self.nsq), copy.deepcopy(self.vad)),
                (self.prev_lag, self.prev_ltp_corr,
                 None if self.prev_nlsf_q15 is None
                 else list(self.prev_nlsf_q15),
                 self.sum_log_gain_q7, self.prev_voiced))

    def restore(self, snap):
        import copy
        (self.fs_khz, self.api_fs_hz, self.seed_ctr, self.first,
         resampler, mirror, xh, lbrr, lp, self.rate_mult, shape, nsq,
         ref_state) = snap
        (self.prev_lag, self.prev_ltp_corr, pn, self.sum_log_gain_q7,
         self.prev_voiced) = ref_state
        self.prev_nlsf_q15 = None if pn is None else list(pn)
        # deep-copy so repeated restores from one snapshot stay independent
        self.resampler = copy.deepcopy(resampler)
        self.mirror = copy.deepcopy(mirror)
        self.x_hist = None if xh is None else xh.copy()
        self.lbrr_store = copy.deepcopy(lbrr)
        self.lp = copy.deepcopy(lp)
        self.shape = copy.deepcopy(shape)
        nsq_state, vad_state = nsq
        self.nsq = copy.deepcopy(nsq_state)
        self.vad = copy.deepcopy(vad_state)

    def set_fs(self, fs_khz: int, api_fs_hz: int, nb_subfr: int = 4):
        from .resampler import resampler_init
        from .structs import ResamplerState
        if (self.fs_khz != fs_khz or self.api_fs_hz != api_fs_hz
                or self.mirror.nb_subfr != nb_subfr):
            self.resampler = ResamplerState()
            if api_fs_hz != fs_khz * 1000:
                resampler_init(self.resampler, api_fs_hz, fs_khz * 1000, True)
            else:
                self.resampler = None
            self.fs_khz = fs_khz
            self.api_fs_hz = api_fs_hz
            self.mirror = ChannelDecoderState()
            self.mirror.nb_subfr = nb_subfr
            # mirror runs at the internal rate; its output resampler is unused
            decoder_set_fs(self.mirror, fs_khz, fs_khz * 1000)
            self.x_hist = np.zeros(self.mirror.ltp_mem_length)
            self.seed_ctr = 0
            self.first = True
            from .noise_shape import NsqState, ShapeState
            self.shape = ShapeState()
            self.nsq = NsqState(self.mirror.ltp_mem_length)
            from .vad import VadState
            self.vad = VadState()
            self.prev_lag = 0
            self.prev_ltp_corr = 0.0
            self.prev_nlsf_q15 = None
            self.sum_log_gain_q7 = 0
            self.prev_voiced = False

    @property
    def lpc_order(self):
        return 16 if self.fs_khz == 16 else 10

    @property
    def warping_q16(self):
        """Warping for shaping analysis + del-dec NSQ feedback
        (control_codec.rs: WARPING_MULTIPLIER 0.015 in Q16 * fs_kHz)."""
        return 983 * self.fs_khz if self.use_del_dec else 0

    @property
    def psnlsf_cb(self):
        return NLSF_CB_WB if self.fs_khz == 16 else NLSF_CB_NB_MB

    # -- analysis helpers ------------------------------------------------
    def _lpc_analysis(self, x):
        """Float LPC -> stabilized NLSF_Q15 (levinson on autocorrelation)."""
        d = self.lpc_order
        w = np.hanning(len(x) + 2)[1:-1]
        xw = x * w
        r = np.correlate(xw, xw, "full")[len(x) - 1: len(x) + d]
        r[0] *= 1.0001
        r[0] += 1e-3 * len(x)
        a = np.zeros(d)
        err = r[0]
        for i in range(d):
            acc = r[i + 1] - np.dot(a[:i], r[i:0:-1][:i])
            k = acc / max(err, 1e-9)
            k = np.clip(k, -0.98, 0.98)
            a_new = a.copy()
            a_new[i] = k
            a_new[:i] = a[:i] - k * a[i - 1::-1][:i]
            a = a_new
            err *= (1 - k * k)
        # Levinson with clamped reflections is already minimum-phase; only
        # a hair of bandwidth expansion for fixed-point headroom. (The old
        # 0.96 blanket expansion capped prediction gain at ~8 dB on
        # strongly resonant input, which starved the closed-loop NSQ.)
        a = a * (LPC_BWEXP ** np.arange(1, d + 1))
        # LSF via P/Q root method
        poly = np.concatenate([[1.0], -a])
        p = np.concatenate([poly, [0.0]]) + np.concatenate([[0.0], poly[::-1]])
        q = np.concatenate([poly, [0.0]]) - np.concatenate([[0.0], poly[::-1]])
        # deflate known roots at z=-1 (P) and z=1 (Q)
        p = np.polynomial.polynomial.polydiv(p[::-1], [1.0, 1.0])[0][::-1]
        q = np.polynomial.polynomial.polydiv(q[::-1], [-1.0, 1.0])[0][::-1]
        angles = []
        for pol in (p, q):
            roots = np.roots(pol)
            ang = np.angle(roots)
            angles.extend(a0 for a0 in ang if 1e-5 < a0 < np.pi - 1e-5)
        angles = sorted(angles)[:d]
        while len(angles) < d:
            angles.append((len(angles) + 1) * np.pi / (d + 1))
        nlsf = [int(min(32767, max(0, round(a0 / np.pi * 32768))))
                for a0 in angles]
        nlsf_stabilize(nlsf, self.psnlsf_cb.delta_min_q15, d)
        return nlsf

    def _whiten(self, xfull, a_q12):
        """LPC analysis filter (float) over [hist | frame]."""
        d = self.lpc_order
        a = np.asarray(a_q12, np.float64) / 4096.0
        res = xfull.copy()
        for j in range(d):
            res[j + 1:] -= a[j] * xfull[: len(xfull) - j - 1]
        res[:d] = 0.0
        return res

    def _pitch_search(self, res, frame_length):
        """Open-loop pitch: best lag + normalized correlation score."""
        fs = self.fs_khz
        min_lag, max_lag = 2 * fs, 18 * fs - 1
        H = len(res) - frame_length
        fr = res[H:]
        e_f = float(fr @ fr) + 1e-9
        best_l, best_s = min_lag, -1.0
        for L in range(min_lag, max_lag + 1):
            seg = res[H - L: H - L + frame_length]
            c = float(fr @ seg)
            if c <= 0:
                continue
            e = float(seg @ seg) + 1e-9
            s = c / math.sqrt(e_f * e) - 0.005 * (L / max_lag)
            if s > best_s:
                best_s, best_l = s, L
        # prefer the sub-octave if nearly as good (avoid pitch doubling)
        for div in (2, 3):
            cand = best_l // div
            if cand >= min_lag:
                seg = res[H - cand: H - cand + frame_length]
                c = float(fr @ seg)
                if c > 0:
                    e = float(seg @ seg) + 1e-9
                    s = c / math.sqrt(e_f * e)
                    if s > 0.85 * best_s:
                        best_l, best_s = cand, max(best_s, s)
                        break
        return best_l, best_s

    def _subfr_score(self, res, frame_length, nb_subfr, L, k):
        H = len(res) - frame_length
        sub = frame_length // nb_subfr
        a = H + k * sub
        fr = res[a: a + sub]
        seg = res[a - L: a - L + sub]
        c = float(fr @ seg)
        e = (float(fr @ fr) * float(seg @ seg)) + 1e-12
        return c / math.sqrt(e) if c > 0 else 0.0

    def _choose_contour(self, res, frame_length, nb_subfr, base_lag):
        """Pick (lag_index, contour_index) maximizing summed subframe corr."""
        fs = self.fs_khz
        min_lag = 2 * fs
        if fs == 8:
            cb = (T.SILK_CB_LAGS_STAGE2 if nb_subfr == 4
                  else T.SILK_CB_LAGS_STAGE2_10_MS)
        else:
            cb = (T.SILK_CB_LAGS_STAGE3 if nb_subfr == 4
                  else T.SILK_CB_LAGS_STAGE3_10_MS)
        n_contours = len(cb[0])
        cache = {}

        def score_lag(L, k):
            key = (L, k)
            if key not in cache:
                cache[key] = self._subfr_score(res, frame_length, nb_subfr,
                                               L, k)
            return cache[key]

        best = (-1.0, 0, 0)
        for lag_cand in range(max(min_lag, base_lag - 2),
                              min(18 * fs - 1, base_lag + 3)):
            lag_index = lag_cand - min_lag
            for ci in range(n_contours):
                pitch = decode_pitch(lag_index, ci, fs, nb_subfr)
                s = sum(score_lag(pitch[k], k) for k in range(nb_subfr))
                if s > best[0]:
                    best = (s, lag_index, ci)
        return best[1], best[2]

    def _fit_ltp(self, res, frame_length, nb_subfr, pitch_l):
        """Per-subframe 5-tap LTP: float fit + codebook quantization.

        Returns (per_index, ltp_index list, per-subframe residual rms)."""
        H = len(res) - frame_length
        sub = frame_length // nb_subfr
        XtX, Xty, yty, Xs, ys = [], [], [], [], []
        for k in range(nb_subfr):
            a = H + k * sub
            y = res[a: a + sub]
            L = pitch_l[k]
            X = np.empty((sub, LTP_ORDER))
            for j in range(LTP_ORDER):
                off = a - L + 2 - j
                X[:, j] = res[off: off + sub]
            XtX.append(X.T @ X + 1e-6 * np.eye(LTP_ORDER))
            Xty.append(X.T @ y)
            yty.append(float(y @ y))
            Xs.append(X)
            ys.append(y)
        best = None
        for p in range(len(T.SILK_LTP_VQ_PTRS_Q14)):
            cbk = np.asarray(T.SILK_LTP_VQ_PTRS_Q14[p], np.float64) / 128.0
            total = 0.0
            idxs = []
            rmss = []
            for k in range(nb_subfr):
                d = (yty[k] - 2.0 * (cbk @ Xty[k])
                     + np.einsum("ij,jk,ik->i", cbk, XtX[k], cbk))
                i_best = int(np.argmin(d))
                idxs.append(i_best)
                total += float(d[i_best])
                rmss.append(math.sqrt(max(float(d[i_best]), 1e-6)
                                      / len(ys[k])))
            if best is None or total < best[0]:
                best = (total, p, idxs, rmss)
        return best[1], best[2], best[3]

    # -- frame encode ----------------------------------------------------
    def encode_frame(self, enc, x16, nb_subfr, target_rate_bps, coarsen=1.0,
                     cond_coding=0, vad_active=True):
        """Encode one frame of int16 samples at the internal rate."""
        from .plc import plc_glue_frames, silk_plc
        from .cng import silk_cng
        from .structs import SideInfoIndices
        st = self.mirror
        d = self.lpc_order
        frame_length = len(x16)
        subfr_length = frame_length // nb_subfr
        x = np.asarray(x16, np.float64)
        xfull = np.concatenate([self.x_hist, x])
        H = len(self.x_hist)

        ix = SideInfoIndices()
        ix.seed = self.seed_ctr & 3
        self.seed_ctr += 1
        tell0 = enc.tell()
        rate_scale = (max(0.15, 24000.0 / max(8000, target_rate_bps))
                      * coarsen * self.rate_mult)
        shape_ctl = None
        rmss = []

        if self.use_nsq_shaping:
            # Reference analysis chain (enc_analysis.py): 3-stage pitch
            # search on the schur-whitened residual, RD LTP codebook
            # selection, burg LPC on the LTP-whitened gain-scaled input
            # with NLSF interpolation, residual-energy gain floor
            # (encode_frame_flp.rs / find_pred_coefs_flp.rs order).
            from . import enc_analysis as EA
            from .noise_shape import (control_snr, noise_shape_analysis,
                                      process_gains)
            from .vad import compute_speech_activity
            # fixed-point VAD (vad.rs): continuous activity + tilt +
            # band quality; the caller's vad_active (DTX) only caps it
            activity = compute_speech_activity(self.vad, x, self.fs_khz)
            if not vad_active:
                activity = min(activity, 0.1)
            input_tilt = self.vad.input_tilt_q15 / 32768.0
            input_quality = 0.5 * (
                self.vad.input_quality_bands_q15[0]
                + self.vad.input_quality_bands_q15[1]) / 32768.0
            (res_pitch, voiced, pitch_l, lag_ix, cont_ix, ltp_corr,
             pred_gain_pitch) = EA.find_pitch_lags(
                xfull, frame_length, self.fs_khz, nb_subfr,
                prev_lag=self.prev_lag,
                prev_signal_type_voiced=self.prev_voiced,
                ltp_corr_prev=self.prev_ltp_corr,
                speech_activity=activity, input_tilt=input_tilt,
                active=vad_active, first_frame=self.first)
            signal_type = TYPE_VOICED if voiced else TYPE_UNVOICED

            snr_db = control_snr(self.fs_khz, nb_subfr, target_rate_bps)
            shape_ctl = noise_shape_analysis(
                xfull, frame_length, nb_subfr, self.fs_khz, snr_db,
                voiced=voiced, ltp_corr=ltp_corr,
                pred_gain=math.sqrt(max(1.0, pred_gain_pitch)),
                pitch_l=pitch_l, pitch_res=res_pitch[H:],
                speech_activity=activity, shape=self.shape,
                input_quality=input_quality,
                warping_q16=self.warping_q16)

            inv_gains = 1.0 / np.maximum(shape_ctl.gains[:nb_subfr], 1e-9)
            if voiced:
                XX, xX = EA.find_ltp(res_pitch, H, pitch_l, subfr_length,
                                     nb_subfr)
                (b_ltp, ltp_idx, per_ix, self.sum_log_gain_q7,
                 lt_gain_db) = EA.quant_ltp_gains(
                    XX, xX, subfr_length, nb_subfr, self.sum_log_gain_q7)
                x_pre = EA.ltp_analysis_filter(
                    xfull, H - d, b_ltp, pitch_l, inv_gains, subfr_length,
                    nb_subfr, d)
            else:
                lt_gain_db = 0.0
                self.sum_log_gain_q7 = 0
                ltp_idx, per_ix = [0] * nb_subfr, 0
                x_pre = EA.scale_chunks(xfull, H - d, inv_gains,
                                        subfr_length, nb_subfr, d)

            first_lpc = self.first or self.prev_nlsf_q15 is None
            if first_lpc:
                min_inv_gain = 1e-2
            else:
                min_inv_gain = (2.0 ** (lt_gain_db / 3.0) / 1e4) \
                    / (0.25 + 0.75 * shape_ctl.coding_quality)
            prev_nlsf = self.prev_nlsf_q15 or [0] * d
            nlsf_q15, interp_q2, _ = EA.find_lpc(
                x_pre, nb_subfr, subfr_length, d, min_inv_gain, prev_nlsf,
                use_interp=nb_subfr == 4, first_frame=first_lpc,
                delta_min_q15=self.psnlsf_cb.delta_min_q15)
            nlsf_idx, coded_nlsf = nlsf_encode(nlsf_q15, self.psnlsf_cb,
                                               signal_type)
            a_h1 = np.asarray(nlsf2a(coded_nlsf, d), np.float64) / 4096.0
            if interp_q2 < 4 and not first_lpc:
                nlsf_h0 = [int(p + ((interp_q2 * (c - p)) >> 2))
                           for p, c in zip(prev_nlsf, coded_nlsf)]
                a_h0 = np.asarray(nlsf2a(nlsf_h0, d), np.float64) / 4096.0
            else:
                interp_q2 = 4
                a_h0 = a_h1
            res_nrg = EA.residual_energy(x_pre, [a_h0, a_h1],
                                         shape_ctl.gains, subfr_length,
                                         nb_subfr, d)
            process_gains(shape_ctl, nb_subfr, subfr_length, snr_db,
                          voiced=voiced, lt_pred_cod_gain=lt_gain_db,
                          res_nrg=res_nrg, speech_activity=activity,
                          input_tilt=input_tilt)

            a_q12 = nlsf2a(coded_nlsf, d)
            res = self._whiten(xfull, a_q12)
            ix.signal_type = signal_type
            ix.quant_offset_type = shape_ctl.quant_offset_type
            ix.nlsf_indices = nlsf_idx
            ix.nlsf_interp_coef_q2 = interp_q2
            if voiced:
                ix.lag_index = lag_ix
                ix.contour_index = cont_ix
                ix.per_index = per_ix
                ix.ltp_index = list(ltp_idx) + [0] * (4 - len(ltp_idx))
                ix.ltp_scale_index = 0
                # the decoder clamps pitch via decode_pitch; keep analysis
                # state consistent with what was coded
                pitch_l = decode_pitch(ix.lag_index, ix.contour_index,
                                       self.fs_khz, nb_subfr)
            self.prev_nlsf_q15 = list(coded_nlsf)
            self.prev_lag = int(pitch_l[-1]) if voiced else 0
            self.prev_ltp_corr = float(ltp_corr)
            self.prev_voiced = voiced
        else:
            nlsf_q15 = self._lpc_analysis(x)

            # open-loop pitch on the unquantized-whitened signal
            res0 = self._whiten(xfull, nlsf2a(nlsf_q15, d))
            energy = float(x @ x) / max(1, len(x))
            lag, score = self._pitch_search(res0, frame_length)
            voiced = bool(vad_active and score > 0.45 and energy > 10.0)
            signal_type = TYPE_VOICED if voiced else TYPE_UNVOICED

            nlsf_idx, coded_nlsf = nlsf_encode(nlsf_q15, self.psnlsf_cb,
                                               signal_type)
            a_q12 = nlsf2a(coded_nlsf, d)
            res = self._whiten(xfull, a_q12)

            ix.signal_type = signal_type
            ix.quant_offset_type = 0
            ix.nlsf_indices = nlsf_idx
            ix.nlsf_interp_coef_q2 = 4

            if voiced:
                ix.lag_index, ix.contour_index = self._choose_contour(
                    res, frame_length, nb_subfr, lag)
                pitch_l = decode_pitch(ix.lag_index, ix.contour_index,
                                       self.fs_khz, nb_subfr)
                ix.per_index, ltp_idx, rmss = self._fit_ltp(
                    res, frame_length, nb_subfr, pitch_l)
                ix.ltp_index = ltp_idx + [0] * (4 - len(ltp_idx))
                ix.ltp_scale_index = 0
            else:
                pitch_l = [0] * nb_subfr
                rmss = []
                for k in range(nb_subfr):
                    seg = res[H + k * subfr_length:
                              H + (k + 1) * subfr_length]
                    rmss.append(math.sqrt(float(seg @ seg) / len(seg))
                                + 1e-3)

        if self.use_nsq_shaping:
            # budget coupling: the byte-budget retry (coarsen) and the
            # cross-frame integral control (rate_mult) scale both the
            # quantization gains and the RD lambda -- the lambda>2 dead
            # zone in the NSQ is what actually makes bits fall when the
            # rate search escalates (gains alone saturate: closed-loop
            # noise feedback keeps pulse activity up at coarse steps)
            eff = coarsen * self.rate_mult
            shape_ctl.lambda_ *= max(1.0, eff) ** NSQ_LAMBDA_COUPLING
            if coarsen >= 500:
                # mute retry: zero pulses are coded, so the gains must be
                # minimal too -- scaled-up gains would otherwise decode as
                # a loud offset*gain noise burst
                gains_q16 = [65536] * nb_subfr
            else:
                gains_q16 = [int(max(65536, min(
                    1 << 30, g * 65536.0 * eff)))
                    for g in shape_ctl.gains[:nb_subfr]]
        else:
            gains_q16 = []
            for k in range(nb_subfr):
                g = int(max(65536, min(
                    1 << 30, (rmss[k] + 1e-3) * 50412.0 * rate_scale)))
                gains_q16.append(g)
        cond = cond_coding == 2
        gains_idx, _gains_dq, _ = gains_quant(
            gains_q16, st.last_gain_index, cond, nb_subfr)
        ix.gains_indices = gains_idx + [0] * (4 - len(gains_idx))

        if self.fec_enabled:
            # LBRR: an independently-coded coarser variant of THIS frame,
            # transmitted in the NEXT packet (reference silk/enc_api LBRR).
            import copy
            ix2 = copy.deepcopy(ix)
            lbrr_gains = [min(1 << 30, g * 5) for g in gains_q16]
            st_copy = copy.deepcopy(st)
            gq, _, _ = gains_quant(lbrr_gains, st_copy.last_gain_index,
                                   False, nb_subfr)
            ix2.gains_indices = gq + [0] * (4 - len(gq))
            if voiced:
                ix2.ltp_scale_index = 2  # rely less on cross-frame LTP
            st_copy.indices = ix2
            ctrl2 = DecCtrl()
            ctrl2.ltp_scale_q14 = 0
            decode_parameters(st_copy, ctrl2, 0)
            pulses2 = [0] * frame_length
            encode_core(st_copy, ctrl2, x, pulses2,
                        res=res[len(self.x_hist):], fb_gamma=0.0)
            self.lbrr_store = (ix2, pulses2)

        # mirror-decode the side info to get the exact decoder parameters.
        # NB: the NSQ runs BEFORE encode_indices (matching the reference
        # encode_frame order): the delayed-decision quantizer picks the
        # winner trellis state and its initial seed index is what must be
        # coded (nsq_del_dec.rs:306).
        st.indices = ix
        ctrl = DecCtrl()
        ctrl.ltp_scale_q14 = 0
        decode_parameters(st, ctrl, cond_coding)

        res_frame = res[len(self.x_hist):]
        if self.use_nsq_shaping and shape_ctl is not None and coarsen < 500:
            # Noise-shaping quantizer (reference nsq.rs / nsq_del_dec.rs)
            # followed by the exact mirror decode of the chosen pulses:
            # the NSQ picks the pulses, decode_core advances the embedded
            # decoder state with the decoder's own arithmetic (zero drift
            # by construction).
            # injectable quantizer: parallel.nsq_batch routes this call to
            # the batched device NSQ kernel (ops/silk_nsq_jax.py) when the
            # encoder runs inside SilkEncodePipeline; same signature and
            # NsqState writeback contract as nsq_shaped
            nsq_fn = getattr(self, "nsq_fn", None)
            common_kw = dict(
                signal_type=ix.signal_type, seed=ix.seed,
                nb_subfr=nb_subfr, frame_length=frame_length,
                ltp_mem_length=st.ltp_mem_length, lpc_order=d,
                pred_coef_q12=ctrl.pred_coef_q12,
                ltp_coef_q14=ctrl.ltp_coef_q14,
                gains_q16=ctrl.gains_q16, pitch_l=ctrl.pitch_l,
                ltp_scale_q14=ctrl.ltp_scale_q14,
                nlsf_interp_flag=ix.nlsf_interp_coef_q2 < 4)
            if nsq_fn is not None:
                out = nsq_fn(x, self.nsq, shape_ctl, **common_kw)
                if isinstance(out, tuple):
                    pulses, ix.seed = out   # del-dec: winner's seed index
                else:
                    pulses = out
            elif self.use_del_dec:
                from .nsq_del_dec import nsq_del_dec_best
                pulses, ix.seed = nsq_del_dec_best(
                    x, self.nsq, shape_ctl, **common_kw,
                    n_states=self.n_del_dec_states,
                    warping=self.warping_q16 / 65536.0)
            else:
                from .noise_shape import nsq_shaped
                pulses = nsq_shaped(x, self.nsq, shape_ctl, **common_kw)
            xq = decode_core(st, ctrl, pulses)
        else:
            pulses = [0] * frame_length
            # Open-loop excitation targets: the legacy path (LBRR, muted
            # budget-overflow retries, use_nsq_shaping=False experiments).
            gamma = self.fb_gamma
            if gamma is None:
                gamma = 0.0
            xq = encode_core(st, ctrl, x, pulses, mute=coarsen >= 500,
                             res=res_frame, fb_gamma=gamma)

        encode_indices(st, enc, ix, cond_coding)

        # decoder postamble (decode_frame parity) keeps every aux state in
        # lockstep: PLC energies, CNG buffers, out_buf, lag feedback
        silk_plc(st, ctrl, xq, False)
        st.loss_cnt = 0
        st.prev_signal_type = ix.signal_type
        st.first_frame_after_reset = 0
        mv_len = st.ltp_mem_length - st.frame_length
        st.out_buf[:mv_len] = st.out_buf[st.frame_length: st.ltp_mem_length]
        st.out_buf[mv_len: mv_len + frame_length] = xq
        silk_cng(st, ctrl, xq, frame_length)
        plc_glue_frames(st, xq, frame_length)
        st.lag_prev = ctrl.pitch_l[st.nb_subfr - 1] if ctrl.pitch_l else 0

        encode_pulses(enc, ix.signal_type, ix.quant_offset_type, pulses,
                      frame_length)
        # integral rate control update (coarser gain = fewer bits, so the
        # multiplier follows spent/budget). On the reference-analysis path
        # control_snr already sets the operating point, so the multiplier
        # only trims the residual bias: tight bounds + slow gain + an
        # active-frame gate (spent above a fraction of budget), because an
        # aggressive multiplier chases silence gaps and pumps the gains
        # 10x+ across speech onsets (measured err16 regression at 24/32k).
        if coarsen < 500 and vad_active:
            spent = enc.tell() - tell0
            budget = target_rate_bps * frame_length / (self.fs_khz * 1000.0)
            ratio = spent / max(1.0, budget)
            if self.use_nsq_shaping:
                if spent > 0.3 * budget:
                    self.rate_mult = min(2.0, max(0.6,
                                                  self.rate_mult
                                                  * ratio ** 0.1))
            else:
                self.rate_mult = min(6.0, max(0.1,
                                              self.rate_mult * ratio ** 0.35))
        self.x_hist = xfull[-st.ltp_mem_length:]
        self.first = False


def silk_encode_packet(senc: SilkEncoder, enc, pcm_api, fs_khz, api_fs_hz,
                       frame_ms, bitrate_bps, coarsen=1.0):
    """Top-level mono SILK packet payload: VAD/LBRR flags + 1-3 frames
    (10/20 ms single, 40/60 ms multi-frame with conditional coding)."""
    from .resampler import silk_resampler
    n_frames = max(1, frame_ms // 20)
    sub_ms = frame_ms if frame_ms <= 20 else 20
    nb_subfr = 4 if sub_ms == 20 else 2
    senc.set_fs(fs_khz, api_fs_hz, nb_subfr)
    if senc.resampler is not None:
        x16 = silk_resampler(senc.resampler, [sat16(int(round(v)))
                                              for v in pcm_api], len(pcm_api))
    else:
        x16 = [sat16(int(round(v))) for v in pcm_api]
    total_length = fs_khz * frame_ms
    x16 = (list(x16) + [0] * total_length)[:total_length]
    frame_length = fs_khz * sub_ms
    if senc.lp.mode != 0:
        # bandwidth-transition low-pass on the internal-rate input, one
        # ramp step per 20 ms frame (encode_frame.rs:242)
        for i in range(n_frames):
            seg = x16[i * frame_length:(i + 1) * frame_length]
            senc.lp.lp_variable_cutoff(seg)
            x16[i * frame_length:(i + 1) * frame_length] = seg
    lbrr = senc.lbrr_store if (senc.fec_enabled and n_frames == 1
                               and senc.lbrr_store is not None
                               and coarsen < 500) else None
    for _ in range(n_frames):
        enc.enc_bit_logp(1, 1)   # VAD flag: active
    enc.enc_bit_logp(1 if lbrr else 0, 1)   # LBRR flag
    if lbrr is not None:
        # single-frame packet: LBRR flag implies the one LBRR frame
        lbrr_ix, lbrr_pulses = lbrr
        encode_indices(senc.mirror, enc, lbrr_ix, 0)
        encode_pulses(enc, lbrr_ix.signal_type, lbrr_ix.quant_offset_type,
                      list(lbrr_pulses), frame_length)
    for i in range(n_frames):
        chunk = x16[i * frame_length:(i + 1) * frame_length]
        cond = 2 if i > 0 else 0
        senc.encode_frame(enc, chunk, nb_subfr, bitrate_bps, coarsen,
                          cond_coding=cond)
        if enc.get_error():
            raise _BudgetExceeded
    if enc.get_error():
        raise _BudgetExceeded


# ---------------------------------------------------------------- stereo
def quant_stereo_pred(w0_q13: float, w1_q13: float):
    """Quantize MS predictor pair to codebook indices (mirror of
    stereo_decode_pred / reference stereo_quant_pred.rs). Returns
    (ix 2x3, decoded pred_q13 pair as the decoder computes it)."""
    from .fixed_math import smlabb, smulwb

    def dec_val(full, ix1):
        low = T.SILK_STEREO_PRED_QUANT_Q13[full]
        step = smulwb(T.SILK_STEREO_PRED_QUANT_Q13[full + 1] - low, 6554)
        return smlabb(low, step, 2 * ix1 + 1)

    def quant_one(target):
        best = None
        for full in range(15):
            for ix1 in range(5):
                v = dec_val(full, ix1)
                e = abs(v - target)
                if best is None or e < best[0]:
                    best = (e, full, ix1, v)
        _, full, ix1, v = best
        return full // 3, full % 3, ix1, v

    # decoder computes pred0 = p0_coded - p1_coded, pred1 = p1_coded
    ix = [[0, 0, 0], [0, 0, 0]]
    ix[1][2], ix[1][0], ix[1][1], p1 = quant_one(w1_q13)
    ix[0][2], ix[0][0], ix[0][1], p0 = quant_one(w0_q13 + p1)
    return ix, [p0 - p1, p1]


def stereo_encode_pred(enc, ix) -> None:
    """Symbol writer mirroring stereo_decode_pred."""
    n = 5 * ix[0][2] + ix[1][2]
    enc.enc_icdf(n, T.SILK_STEREO_PRED_JOINT_ICDF, 8)
    for ch in range(2):
        enc.enc_icdf(ix[ch][0], T.SILK_UNIFORM3_ICDF, 8)
        enc.enc_icdf(ix[ch][1], T.SILK_UNIFORM5_ICDF, 8)


class SilkStereoEncoder:
    """Stereo SILK: LR->MS with quantized predictors, two channel encoders.

    Mirrors the decoder's MS->LR math (dec_api.stereo_ms_to_lr): the side
    channel codes side - P(mid) where P applies pred0 to the 3-tap smoothed
    mid and pred1 to mid, both interpolated over the first 8 ms."""

    def __init__(self):
        self.mid = SilkEncoder()
        self.side = SilkEncoder()
        self.fs_khz = 0
        self.api_fs_hz = 0
        self.rs_l = None
        self.rs_r = None
        self.pred_prev_q13 = [0, 0]
        self.mid_hist = [0, 0]   # 2-sample mid history for the smooth term

    def snapshot(self):
        import copy
        return (self.mid.snapshot(), self.side.snapshot(), self.fs_khz,
                self.api_fs_hz, copy.deepcopy(self.rs_l),
                copy.deepcopy(self.rs_r), list(self.pred_prev_q13),
                list(self.mid_hist))

    def restore(self, snap):
        import copy
        (ms, ss, self.fs_khz, self.api_fs_hz, rl, rr, pp, mh) = snap
        self.mid.restore(ms)
        self.side.restore(ss)
        self.rs_l = copy.deepcopy(rl)
        self.rs_r = copy.deepcopy(rr)
        self.pred_prev_q13 = list(pp)
        self.mid_hist = list(mh)

    def _set_fs(self, fs_khz, api_fs_hz, nb_subfr):
        from .resampler import resampler_init
        from .structs import ResamplerState
        if self.fs_khz != fs_khz or self.api_fs_hz != api_fs_hz:
            if api_fs_hz != fs_khz * 1000:
                self.rs_l = ResamplerState()
                self.rs_r = ResamplerState()
                resampler_init(self.rs_l, api_fs_hz, fs_khz * 1000, True)
                resampler_init(self.rs_r, api_fs_hz, fs_khz * 1000, True)
            else:
                self.rs_l = self.rs_r = None
            self.fs_khz = fs_khz
            self.api_fs_hz = api_fs_hz
            self.pred_prev_q13 = [0, 0]
            self.mid_hist = [0, 0]
        # channel encoders run at the internal rate (no inner resampler)
        self.mid.set_fs(fs_khz, fs_khz * 1000, nb_subfr)
        self.side.set_fs(fs_khz, fs_khz * 1000, nb_subfr)

    def encode_packet(self, enc, pcm_l, pcm_r, fs_khz, api_fs_hz, frame_ms,
                      bitrate_bps, coarsen=1.0):
        from .resampler import silk_resampler
        n_frames = max(1, frame_ms // 20)
        sub_ms = frame_ms if frame_ms <= 20 else 20
        nb_subfr = 4 if sub_ms == 20 else 2
        self._set_fs(fs_khz, api_fs_hz, nb_subfr)
        frame_length = fs_khz * frame_ms
        if self.rs_l is not None:
            l16 = list(silk_resampler(self.rs_l,
                                      [sat16(int(round(v))) for v in pcm_l],
                                      len(pcm_l)))
            r16 = list(silk_resampler(self.rs_r,
                                      [sat16(int(round(v))) for v in pcm_r],
                                      len(pcm_r)))
        else:
            l16 = [sat16(int(round(v))) for v in pcm_l]
            r16 = [sat16(int(round(v))) for v in pcm_r]
        l16 = (l16 + [0] * frame_length)[:frame_length]
        r16 = (r16 + [0] * frame_length)[:frame_length]

        from .fixed_math import rshift_round
        mid = [rshift_round(l16[n] + r16[n], 1) for n in range(frame_length)]
        side = [sat16(rshift_round(l16[n] - r16[n], 1))
                for n in range(frame_length)]

        # predictor fit: side ~ w0*smooth/2^15 + w1*mid/2^13 (Q13 weights)
        mh = self.mid_hist
        midx = np.asarray(mh + mid, np.float64)     # 2 extra history samples
        s = np.asarray(side, np.float64)
        smooth = (midx[:-2] + midx[2:] + 2.0 * midx[1:-1])  # aligns with mid
        basis = np.stack([smooth / (1 << 15), midx[1:-1] / (1 << 13)], 1)
        g = basis.T @ basis + 1e-3 * np.eye(2)
        w = np.linalg.solve(g, basis.T @ s)
        w0 = float(np.clip(w[0], -13000, 13000))
        w1 = float(np.clip(w[1], -13000, 13000))
        ix, pred_q13 = quant_stereo_pred(w0, w1)

        # side residual with the decoder's interpolation from the previous
        # frame's predictors over the first 8 ms
        interp_len = 8 * fs_khz
        denom = 1.0 / interp_len
        p0_prev, p1_prev = self.pred_prev_q13
        sres = [0] * frame_length
        for n in range(frame_length):
            if n < interp_len:
                f = (n + 1) * denom
                p0 = p0_prev + f * (pred_q13[0] - p0_prev)
                p1 = p1_prev + f * (pred_q13[1] - p1_prev)
            else:
                p0 = pred_q13[0]
                p1 = pred_q13[1]
            pred = smooth[n] * p0 / (1 << 15) + midx[n + 1] * p1 / (1 << 13)
            sres[n] = sat16(int(round(side[n] - pred)))
        self.pred_prev_q13 = list(pred_q13)
        self.mid_hist = mid[-2:]

        # flags: both channels VAD-active for every frame, no LBRR (side is
        # always coded, so the decoder never looks for a mid-only flag)
        for _ in range(2):
            for _ in range(n_frames):
                enc.enc_bit_logp(1, 1)
            enc.enc_bit_logp(0, 1)
        sub_len = fs_khz * sub_ms
        for i in range(n_frames):
            stereo_encode_pred(enc, ix)
            cond = 2 if i > 0 else 0
            self.mid.encode_frame(enc, mid[i * sub_len:(i + 1) * sub_len],
                                  nb_subfr, int(bitrate_bps * 0.6), coarsen,
                                  cond_coding=cond)
            self.side.encode_frame(enc, sres[i * sub_len:(i + 1) * sub_len],
                                   nb_subfr, int(bitrate_bps * 0.4), coarsen,
                                   cond_coding=cond)
            if enc.get_error():
                raise _BudgetExceeded
        if enc.get_error():
            raise _BudgetExceeded
