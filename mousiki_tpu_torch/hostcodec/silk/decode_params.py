"""SILK parameter dequantization: gains, NLSF->LPC, pitch contour, LTP.

Bit-exact ports of the normative algorithms (parity: reference
src/silk/{gain_quant,nlsf_decode,nlsf_stabilize,nlsf2a,lpc_fit,
lpc_inv_pred_gain,decode_pitch,decode_parameters}.rs / libopus silk/*.c).
"""

from __future__ import annotations

from . import tables as T
from .decode_indices import nlsf_unpack
from .fixed_math import (clz32, i16, i32, rshift_round, rshift_round64, sat16,
                         silk_bwexpander, silk_bwexpander_32, silk_div32,
                         silk_div32_16, silk_div32_varq, silk_inverse32_varq,
                         silk_log2lin, smlawb, smmul, smulbb, smulwb, smulww,
                         sub_sat32)
from .structs import (CODE_CONDITIONALLY, LTP_ORDER, MAX_LPC_ORDER,
                      MAX_LPC_STABILIZE_ITERATIONS, TYPE_VOICED)

N_LEVELS_QGAIN = 64
MIN_QGAIN_DB = 2
MAX_QGAIN_DB = 88
OFFSET_GQ = (MIN_QGAIN_DB * 128) // 6 + 16 * 128
INV_SCALE_Q16 = (65536 * (((MAX_QGAIN_DB - MIN_QGAIN_DB) * 128) // 6)) // (N_LEVELS_QGAIN - 1)
NLSF_QUANT_LEVEL_ADJ_Q10 = 102  # 0.1 in Q10
QA_NLSF = 16
QA_INV = 24
A_LIMIT_Q24 = int(0.99975 * (1 << 24) + 0.5)
INV_MAX_PRED_GAIN_Q30 = int((1.0 / 1e4) * (1 << 30))  # 1/MAX_PREDICTION_POWER_GAIN
BWE_AFTER_LOSS_Q16 = 63570
MAX_LOOPS_STABILIZE = 20


def gains_dequant(gains_indices, prev_ind: int, conditional: bool, nb_subfr: int):
    """Returns (gains_q16 list, new prev_ind)."""
    gains_q16 = [0] * nb_subfr
    for k in range(nb_subfr):
        if k == 0 and not conditional:
            prev_ind = max(gains_indices[k], prev_ind - 16)
        else:
            ind_tmp = gains_indices[k] + T.MIN_DELTA_GAIN_QUANT
            double_step = 2 * T.MAX_DELTA_GAIN_QUANT - N_LEVELS_QGAIN + prev_ind
            if ind_tmp > double_step:
                prev_ind += (ind_tmp << 1) - double_step
            else:
                prev_ind += ind_tmp
        prev_ind = max(0, min(N_LEVELS_QGAIN - 1, prev_ind))
        gains_q16[k] = silk_log2lin(
            min(smulwb(INV_SCALE_Q16, prev_ind) + OFFSET_GQ, 3967))
    return gains_q16, prev_ind


def nlsf_residual_dequant(indices, pred_q8, quant_step_q16, order):
    out = [0] * order
    out_q10 = 0
    for i in range(order - 1, -1, -1):
        pred_q10 = smulbb(out_q10, pred_q8[i]) >> 8
        out_q10 = i16(indices[i] << 10)
        if out_q10 > 0:
            out_q10 = i16(out_q10 - NLSF_QUANT_LEVEL_ADJ_Q10)
        elif out_q10 < 0:
            out_q10 = i16(out_q10 + NLSF_QUANT_LEVEL_ADJ_Q10)
        out_q10 = smlawb(pred_q10, out_q10, quant_step_q16)
        out[i] = out_q10
    return out


def nlsf_stabilize(nlsf_q15, delta_min_q15, L):
    for _ in range(MAX_LOOPS_STABILIZE):
        min_diff = nlsf_q15[0] - delta_min_q15[0]
        I = 0
        for i in range(1, L):
            diff = nlsf_q15[i] - (nlsf_q15[i - 1] + delta_min_q15[i])
            if diff < min_diff:
                min_diff = diff
                I = i
        diff = (1 << 15) - (nlsf_q15[L - 1] + delta_min_q15[L])
        if diff < min_diff:
            min_diff = diff
            I = L
        if min_diff >= 0:
            return
        if I == 0:
            nlsf_q15[0] = delta_min_q15[0]
        elif I == L:
            nlsf_q15[L - 1] = (1 << 15) - delta_min_q15[L]
        else:
            min_center = sum(delta_min_q15[:I]) + (delta_min_q15[I] >> 1)
            max_center = (1 << 15) - (delta_min_q15[I] >> 1)
            for k in range(L, I, -1):
                max_center -= delta_min_q15[k]
            center = max(min_center, min(max_center,
                                         rshift_round(nlsf_q15[I - 1] + nlsf_q15[I], 1)))
            nlsf_q15[I - 1] = center - (delta_min_q15[I] >> 1)
            nlsf_q15[I] = nlsf_q15[I - 1] + delta_min_q15[I]
    # fallback: sort and clamp
    nlsf_q15[:L] = sorted(nlsf_q15[:L])
    nlsf_q15[0] = max(nlsf_q15[0], delta_min_q15[0])
    for i in range(1, L):
        nlsf_q15[i] = max(nlsf_q15[i],
                          min(32767, nlsf_q15[i - 1] + delta_min_q15[i]))
    nlsf_q15[L - 1] = min(nlsf_q15[L - 1], (1 << 15) - delta_min_q15[L])
    for i in range(L - 2, -1, -1):
        nlsf_q15[i] = min(nlsf_q15[i], nlsf_q15[i + 1] - delta_min_q15[i + 1])


def nlsf_decode(nlsf_indices, cb):
    """Decode NLSF vector (Q15) from stage-1 + residual indices."""
    ec_ix, pred_q8 = nlsf_unpack(cb, nlsf_indices[0])
    res_q10 = nlsf_residual_dequant(nlsf_indices[1:1 + cb.order], pred_q8,
                                    cb.quant_step_size_q16, cb.order)
    base = nlsf_indices[0] * cb.order
    nlsf_q15 = [0] * cb.order
    for i in range(cb.order):
        w = cb.cb1_wght_q9[base + i]
        v = silk_div32_16(res_q10[i] << 14, w) + (cb.cb1_nlsf_q8[base + i] << 7)
        nlsf_q15[i] = max(0, min(32767, v))
    nlsf_stabilize(nlsf_q15, cb.delta_min_q15, cb.order)
    return nlsf_q15


_ORDERING16 = [0, 15, 8, 7, 4, 11, 12, 3, 2, 13, 10, 5, 6, 9, 14, 1]
_ORDERING10 = [0, 9, 6, 3, 4, 5, 8, 1, 2, 7]


def _nlsf2a_find_poly(clsf, dd):
    # clsf here is already the even- or odd-strided half (clsf[k] = full[2k(+1)])
    out = [0] * (dd + 1)
    out[0] = 1 << QA_NLSF
    out[1] = -clsf[0]
    for k in range(1, dd):
        ftmp = clsf[k]
        out[k + 1] = i32((out[k - 1] << 1) - i32(rshift_round64(ftmp * out[k], QA_NLSF)))
        for n in range(k, 1, -1):
            out[n] = i32(out[n] + out[n - 2]
                         - i32(rshift_round64(ftmp * out[n - 1], QA_NLSF)))
        out[1] = i32(out[1] - ftmp)
    return out


def lpc_fit(a_qin, qout, qin, d):
    """Limit int32 coefs to int16 at qout; returns (a_qout, a_qin updated)."""
    a_qout = [0] * d
    for it in range(10):
        maxabs = 0
        idx = 0
        for k in range(d):
            if abs(a_qin[k]) > maxabs:
                maxabs = abs(a_qin[k])
                idx = k
        maxabs = rshift_round(maxabs, qin - qout)
        if maxabs > 32767:
            maxabs = min(maxabs, 163838)
            chirp_q16 = int(0.999 * 65536) - silk_div32(
                (maxabs - 32767) << 14, (maxabs * (idx + 1)) >> 2)
            silk_bwexpander_32(a_qin, d, chirp_q16)
        else:
            break
    else:
        it = 10
    if it == 10:
        for k in range(d):
            a_qout[k] = sat16(rshift_round(a_qin[k], qin - qout))
            a_qin[k] = a_qout[k] << (qin - qout)
    else:
        for k in range(d):
            a_qout[k] = i16(rshift_round(a_qin[k], qin - qout))
    return a_qout


def _mul32_frac_q(a, b, q):
    return i32(rshift_round64(a * b, q))


def lpc_inverse_pred_gain(a_q12, order):
    """Returns invGain_Q30, or 0 if unstable (parity lpc_inv_pred_gain.rs)."""
    a_qa = []
    dc_resp = 0
    for k in range(order):
        dc_resp += a_q12[k]
        a_qa.append(i32(a_q12[k] << (QA_INV - 12)))
    if dc_resp >= 4096:
        return 0
    inv_gain_q30 = 1 << 30
    for k in range(order - 1, 0, -1):
        if a_qa[k] > A_LIMIT_Q24 or a_qa[k] < -A_LIMIT_Q24:
            return 0
        rc_q31 = i32(-(a_qa[k] << (31 - QA_INV)))
        rc_mult1_q30 = i32((1 << 30) - smmul(rc_q31, rc_q31))
        inv_gain_q30 = i32(smmul(inv_gain_q30, rc_mult1_q30) << 2)
        if inv_gain_q30 < INV_MAX_PRED_GAIN_Q30:
            return 0
        mult2q = 32 - clz32(abs(rc_mult1_q30))
        rc_mult2 = silk_inverse32_varq(rc_mult1_q30, mult2q + 30)
        for n in range((k + 1) >> 1):
            tmp1 = a_qa[n]
            tmp2 = a_qa[k - n - 1]
            tmp64 = rshift_round64(
                sub_sat32(tmp1, _mul32_frac_q(tmp2, rc_q31, 31)) * rc_mult2, mult2q)
            if tmp64 > 0x7FFFFFFF or tmp64 < -0x80000000:
                return 0
            a_qa[n] = tmp64
            tmp64 = rshift_round64(
                sub_sat32(tmp2, _mul32_frac_q(tmp1, rc_q31, 31)) * rc_mult2, mult2q)
            if tmp64 > 0x7FFFFFFF or tmp64 < -0x80000000:
                return 0
            a_qa[k - n - 1] = tmp64
    if a_qa[0] > A_LIMIT_Q24 or a_qa[0] < -A_LIMIT_Q24:
        return 0
    rc_q31 = i32(-(a_qa[0] << (31 - QA_INV)))
    rc_mult1_q30 = i32((1 << 30) - smmul(rc_q31, rc_q31))
    inv_gain_q30 = i32(smmul(inv_gain_q30, rc_mult1_q30) << 2)
    if inv_gain_q30 < INV_MAX_PRED_GAIN_Q30:
        return 0
    return inv_gain_q30


def nlsf2a(nlsf_q15, d):
    """NLSF (Q15) -> stable LPC coefficients a_Q12 (int16 list)."""
    ordering = _ORDERING16 if d == 16 else _ORDERING10
    clsf = [0] * d
    for k in range(d):
        f_int = nlsf_q15[k] >> 8
        f_frac = nlsf_q15[k] - (f_int << 8)
        cos_val = T.SILK_LSF_COS_TAB_FIX_Q12[f_int]
        delta = T.SILK_LSF_COS_TAB_FIX_Q12[f_int + 1] - cos_val
        clsf[ordering[k]] = rshift_round((cos_val << 8) + delta * f_frac,
                                         20 - QA_NLSF)
    dd = d >> 1
    P = _nlsf2a_find_poly(clsf[0::2], dd)
    Q = _nlsf2a_find_poly(clsf[1::2], dd)
    a32_qa1 = [0] * d
    for k in range(dd):
        ptmp = P[k + 1] + P[k]
        qtmp = Q[k + 1] - Q[k]
        a32_qa1[k] = i32(-qtmp - ptmp)
        a32_qa1[d - k - 1] = i32(qtmp - ptmp)
    a_q12 = lpc_fit(a32_qa1, 12, QA_NLSF + 1, d)
    for i in range(MAX_LPC_STABILIZE_ITERATIONS):
        if lpc_inverse_pred_gain(a_q12, d) != 0:
            break
        silk_bwexpander_32(a32_qa1, d, 65536 - (2 << i))
        for k in range(d):
            a_q12[k] = i16(rshift_round(a32_qa1[k], QA_NLSF + 1 - 12))
    return a_q12


def decode_pitch(lag_index, contour_index, fs_khz, nb_subfr):
    """Primary lag + per-subframe contour -> pitch lags."""
    if fs_khz == 8:
        if nb_subfr == 4:
            cb = T.SILK_CB_LAGS_STAGE2
        else:
            cb = T.SILK_CB_LAGS_STAGE2_10_MS
    else:
        if nb_subfr == 4:
            cb = T.SILK_CB_LAGS_STAGE3
        else:
            cb = T.SILK_CB_LAGS_STAGE3_10_MS
    min_lag = 2 * fs_khz
    max_lag = 18 * fs_khz
    lag = min_lag + lag_index
    return [max(min_lag, min(max_lag, lag + cb[k][contour_index]))
            for k in range(nb_subfr)]


def decode_parameters(st, ctrl, cond_coding):
    """Decode gains/NLSFs/pitch/LTP into ctrl (parity decode_parameters.rs)."""
    ix = st.indices
    gains, st.last_gain_index = gains_dequant(
        ix.gains_indices, st.last_gain_index,
        cond_coding == CODE_CONDITIONALLY, st.nb_subfr)
    ctrl.gains_q16 = gains

    nlsf_q15 = nlsf_decode(ix.nlsf_indices, st.psnlsf_cb)
    ctrl.pred_coef_q12 = [None, nlsf2a(nlsf_q15, st.lpc_order)]

    if st.first_frame_after_reset == 1:
        ix.nlsf_interp_coef_q2 = 4

    if ix.nlsf_interp_coef_q2 < 4:
        nlsf0 = [st.prev_nlsf_q15[i]
                 + ((ix.nlsf_interp_coef_q2
                     * (nlsf_q15[i] - st.prev_nlsf_q15[i])) >> 2)
                 for i in range(st.lpc_order)]
        ctrl.pred_coef_q12[0] = nlsf2a(nlsf0, st.lpc_order)
    else:
        ctrl.pred_coef_q12[0] = list(ctrl.pred_coef_q12[1])

    st.prev_nlsf_q15[: st.lpc_order] = nlsf_q15

    if st.loss_cnt:
        silk_bwexpander(ctrl.pred_coef_q12[0], st.lpc_order, BWE_AFTER_LOSS_Q16)
        silk_bwexpander(ctrl.pred_coef_q12[1], st.lpc_order, BWE_AFTER_LOSS_Q16)

    if ix.signal_type == TYPE_VOICED:
        ctrl.pitch_l = decode_pitch(ix.lag_index, ix.contour_index,
                                    st.fs_khz, st.nb_subfr)
        cbk = T.SILK_LTP_VQ_PTRS_Q14[ix.per_index]  # values are Q7 in the ROM
        ctrl.ltp_coef_q14 = [0] * (st.nb_subfr * LTP_ORDER)
        for k in range(st.nb_subfr):
            for i in range(LTP_ORDER):
                ctrl.ltp_coef_q14[k * LTP_ORDER + i] = cbk[ix.ltp_index[k]][i] << 7
        ctrl.ltp_scale_q14 = T.SILK_LTPSCALES_TABLE_Q14[ix.ltp_scale_index]
    else:
        ctrl.pitch_l = [0] * st.nb_subfr
        ctrl.ltp_coef_q14 = [0] * (st.nb_subfr * LTP_ORDER)
        ix.per_index = 0
        ctrl.ltp_scale_q14 = 0
