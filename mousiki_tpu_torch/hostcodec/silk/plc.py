"""SILK packet-loss concealment (parity: reference src/silk/plc.rs,
libopus silk/PLC.c) — classic LTP/LPC extrapolation with attenuation."""

from __future__ import annotations

from .decode_core import lpc_analysis_filter, silk_rand
from .decode_params import lpc_inverse_pred_gain
from .fixed_math import (add_sat32, clz32, i16, i32, lshift_sat32,
                         rshift_round, sat16, silk_bwexpander, silk_div32,
                         silk_div32_16, silk_inverse32_varq, silk_sqrt_approx,
                         smlawb, smulbb, smulwb, smulww)
from .structs import (LTP_ORDER, MAX_LPC_ORDER, MAX_NB_SUBFR,
                      TYPE_NO_VOICE_ACTIVITY, TYPE_VOICED)

NB_ATT = 2
HARM_ATT_Q15 = [32440, 31130]
PLC_RAND_ATTENUATE_V_Q15 = [31130, 26214]
PLC_RAND_ATTENUATE_UV_Q15 = [32440, 29491]
V_PITCH_GAIN_START_MIN_Q14 = 11469
V_PITCH_GAIN_START_MAX_Q14 = 15565
BWE_COEF_Q16 = 64881  # 0.99
PITCH_DRIFT_FAC_Q16 = 655
MAX_PITCH_LAG_MS = 18
RAND_BUF_SIZE = 128
RAND_BUF_MASK = RAND_BUF_SIZE - 1
LOG2_INV_LPC_GAIN_HIGH_THRES = 3
LOG2_INV_LPC_GAIN_LOW_THRES = 8


def sum_sqr_shift(x, length):
    """Energy of int16 signal with adaptive shift; returns (energy, shift)."""
    shft = 31 - clz32(length)
    nrg = length
    i = 0
    while i < length - 1:
        t = (x[i] * x[i] + x[i + 1] * x[i + 1]) & 0xFFFFFFFF
        nrg = i32(nrg + (t >> shft))
        i += 2
    if i < length:
        nrg = i32(nrg + ((x[i] * x[i]) >> shft))
    shft = max(0, shft + 3 - clz32(nrg))
    nrg = 0
    i = 0
    while i < length - 1:
        t = (x[i] * x[i] + x[i + 1] * x[i + 1]) & 0xFFFFFFFF
        nrg = i32(nrg + (t >> shft))
        i += 2
    if i < length:
        nrg = i32(nrg + ((x[i] * x[i]) >> shft))
    return nrg, shft


def plc_reset(st):
    st.s_plc.pitch_l_q8 = st.frame_length << 7
    st.s_plc.prev_gain_q16 = [1 << 16, 1 << 16]
    st.s_plc.subfr_length = 20
    st.s_plc.nb_subfr = 2


def silk_plc(st, ctrl, frame, lost: bool):
    if st.fs_khz != st.s_plc.fs_khz:
        plc_reset(st)
        st.s_plc.fs_khz = st.fs_khz
    if lost:
        _conceal(st, ctrl, frame)
        st.loss_cnt += 1
    else:
        _update(st, ctrl)


def _update(st, ctrl):
    plc = st.s_plc
    st.prev_signal_type = st.indices.signal_type
    ltp_gain_q14 = 0
    if st.indices.signal_type == TYPE_VOICED:
        j = 0
        while j * st.subfr_length < ctrl.pitch_l[st.nb_subfr - 1]:
            if j == st.nb_subfr:
                break
            temp = sum(ctrl.ltp_coef_q14[(st.nb_subfr - 1 - j) * LTP_ORDER:
                                         (st.nb_subfr - j) * LTP_ORDER])
            if temp > ltp_gain_q14:
                ltp_gain_q14 = temp
                plc.ltp_coef_q14 = list(
                    ctrl.ltp_coef_q14[(st.nb_subfr - 1 - j) * LTP_ORDER:
                                      (st.nb_subfr - j) * LTP_ORDER])
                plc.pitch_l_q8 = ctrl.pitch_l[st.nb_subfr - 1 - j] << 8
            j += 1
        plc.ltp_coef_q14 = [0] * LTP_ORDER
        plc.ltp_coef_q14[LTP_ORDER // 2] = ltp_gain_q14
        if ltp_gain_q14 < V_PITCH_GAIN_START_MIN_Q14:
            scale_q10 = silk_div32(V_PITCH_GAIN_START_MIN_Q14 << 10,
                                   max(ltp_gain_q14, 1))
            for i in range(LTP_ORDER):
                plc.ltp_coef_q14[i] = smulbb(plc.ltp_coef_q14[i], scale_q10) >> 10
        elif ltp_gain_q14 > V_PITCH_GAIN_START_MAX_Q14:
            scale_q14 = silk_div32(V_PITCH_GAIN_START_MAX_Q14 << 14,
                                   max(ltp_gain_q14, 1))
            for i in range(LTP_ORDER):
                plc.ltp_coef_q14[i] = smulbb(plc.ltp_coef_q14[i], scale_q14) >> 14
    else:
        plc.pitch_l_q8 = (st.fs_khz * 18) << 8
        plc.ltp_coef_q14 = [0] * LTP_ORDER
    plc.prev_lpc_q12 = list(ctrl.pred_coef_q12[1][: st.lpc_order]) + \
        [0] * (MAX_LPC_ORDER - st.lpc_order)
    plc.prev_ltp_scale_q14 = ctrl.ltp_scale_q14
    plc.prev_gain_q16 = list(ctrl.gains_q16[st.nb_subfr - 2: st.nb_subfr])
    plc.subfr_length = st.subfr_length
    plc.nb_subfr = st.nb_subfr


def _conceal(st, ctrl, frame):
    plc = st.s_plc
    prev_gain_q10 = [plc.prev_gain_q16[0] >> 6, plc.prev_gain_q16[1] >> 6]
    if st.first_frame_after_reset:
        plc.prev_lpc_q12 = [0] * MAX_LPC_ORDER

    # Pick the lowest-energy of the last two subframes as the random source
    # (energy scan uses the *current* frame geometry; the random-buffer base
    # below uses the PLC-saved geometry)
    exc_buf = []
    for k in range(2):
        base = (k + st.nb_subfr - 2) * st.subfr_length
        for i in range(st.subfr_length):
            exc_buf.append(sat16(
                smulww(st.exc_q14[base + i], prev_gain_q10[k]) >> 8))
    energy1, shift1 = sum_sqr_shift(exc_buf[: st.subfr_length], st.subfr_length)
    energy2, shift2 = sum_sqr_shift(exc_buf[st.subfr_length:], st.subfr_length)
    if (energy1 >> shift2) < (energy2 >> shift1):
        rand_base = max(0, (plc.nb_subfr - 1) * plc.subfr_length - RAND_BUF_SIZE)
    else:
        rand_base = max(0, plc.nb_subfr * plc.subfr_length - RAND_BUF_SIZE)

    b_q14 = list(plc.ltp_coef_q14)
    rand_scale_q14 = plc.rand_scale_q14

    harm_gain_q15 = HARM_ATT_Q15[min(NB_ATT - 1, st.loss_cnt)]
    if st.prev_signal_type == TYPE_VOICED:
        rand_gain_q15 = PLC_RAND_ATTENUATE_V_Q15[min(NB_ATT - 1, st.loss_cnt)]
    else:
        rand_gain_q15 = PLC_RAND_ATTENUATE_UV_Q15[min(NB_ATT - 1, st.loss_cnt)]

    silk_bwexpander(plc.prev_lpc_q12, st.lpc_order, BWE_COEF_Q16)
    a_q12 = plc.prev_lpc_q12[: st.lpc_order]

    if st.loss_cnt == 0:
        rand_scale_q14 = 1 << 14
        if st.prev_signal_type == TYPE_VOICED:
            for i in range(LTP_ORDER):
                rand_scale_q14 -= b_q14[i]
            rand_scale_q14 = max(3277, rand_scale_q14)
            rand_scale_q14 = i16(smulbb(rand_scale_q14, plc.prev_ltp_scale_q14) >> 14)
        else:
            inv_gain_q30 = lpc_inverse_pred_gain(a_q12, st.lpc_order)
            down_scale_q30 = min((1 << 30) >> LOG2_INV_LPC_GAIN_HIGH_THRES, inv_gain_q30)
            down_scale_q30 = max((1 << 30) >> LOG2_INV_LPC_GAIN_LOW_THRES, down_scale_q30)
            down_scale_q30 = i32(down_scale_q30 << LOG2_INV_LPC_GAIN_HIGH_THRES)
            rand_gain_q15 = smulwb(down_scale_q30, rand_gain_q15) >> 14

    rand_seed = plc.rand_seed
    lag = rshift_round(plc.pitch_l_q8, 8)
    sltp_buf_idx = st.ltp_mem_length

    # Rewhiten LTP state
    idx = st.ltp_mem_length - lag - st.lpc_order - LTP_ORDER // 2
    assert idx > 0
    sltp = [0] * st.ltp_mem_length
    scratch = [0] * (st.ltp_mem_length - idx)
    lpc_analysis_filter(scratch, st.out_buf, idx, a_q12,
                        st.ltp_mem_length - idx, st.lpc_order)
    sltp[idx:] = scratch
    inv_gain_q30 = silk_inverse32_varq(plc.prev_gain_q16[1], 46)
    inv_gain_q30 = min(inv_gain_q30, 0x7FFFFFFF >> 1)
    sltp_q14 = [0] * (st.ltp_mem_length + st.frame_length)
    for i in range(idx + st.lpc_order, st.ltp_mem_length):
        sltp_q14[i] = smulwb(inv_gain_q30, sltp[i])

    # LTP synthesis
    for k in range(st.nb_subfr):
        pl = sltp_buf_idx - lag + LTP_ORDER // 2
        for i in range(st.subfr_length):
            ltp_pred_q12 = 2
            for t in range(LTP_ORDER):
                ltp_pred_q12 = smlawb(ltp_pred_q12, sltp_q14[pl - t], b_q14[t])
            pl += 1
            rand_seed = silk_rand(rand_seed)
            ridx = (rand_seed >> 25) & RAND_BUF_MASK
            sltp_q14[sltp_buf_idx] = i32(
                smlawb(ltp_pred_q12, st.exc_q14[rand_base + ridx],
                       rand_scale_q14) << 2)
            sltp_buf_idx += 1
        for j in range(LTP_ORDER):
            b_q14[j] = smulbb(harm_gain_q15, b_q14[j]) >> 15
        if st.indices.signal_type != TYPE_NO_VOICE_ACTIVITY:
            rand_scale_q14 = smulbb(rand_scale_q14, rand_gain_q15) >> 15
        plc.pitch_l_q8 = smlawb(plc.pitch_l_q8, plc.pitch_l_q8, PITCH_DRIFT_FAC_Q16)
        plc.pitch_l_q8 = min(plc.pitch_l_q8, (MAX_PITCH_LAG_MS * st.fs_khz) << 8)
        lag = rshift_round(plc.pitch_l_q8, 8)

    # LPC synthesis over the concealed excitation
    base = st.ltp_mem_length - MAX_LPC_ORDER
    sltp_q14[base: base + MAX_LPC_ORDER] = st.s_lpc_q14_buf
    for i in range(st.frame_length):
        lpc_pred_q10 = st.lpc_order >> 1
        for j in range(st.lpc_order):
            lpc_pred_q10 = smlawb(lpc_pred_q10,
                                  sltp_q14[base + MAX_LPC_ORDER + i - 1 - j],
                                  a_q12[j])
        sltp_q14[base + MAX_LPC_ORDER + i] = add_sat32(
            sltp_q14[base + MAX_LPC_ORDER + i], lshift_sat32(lpc_pred_q10, 4))
        frame[i] = sat16(rshift_round(
            smulww(sltp_q14[base + MAX_LPC_ORDER + i], prev_gain_q10[1]), 8))
    st.s_lpc_q14_buf[:] = sltp_q14[base + st.frame_length:
                                   base + st.frame_length + MAX_LPC_ORDER]

    plc.rand_seed = rand_seed
    plc.rand_scale_q14 = rand_scale_q14
    for i in range(MAX_NB_SUBFR):
        if i < len(ctrl.pitch_l):
            ctrl.pitch_l[i] = lag


def plc_glue_frames(st, frame, length):
    plc = st.s_plc
    if st.loss_cnt:
        plc.conc_energy, plc.conc_energy_shift = sum_sqr_shift(frame, length)
        plc.last_frame_lost = 1
    else:
        if plc.last_frame_lost:
            energy, energy_shift = sum_sqr_shift(frame, length)
            if energy_shift > plc.conc_energy_shift:
                plc.conc_energy >>= energy_shift - plc.conc_energy_shift
            elif energy_shift < plc.conc_energy_shift:
                energy >>= plc.conc_energy_shift - energy_shift
            if energy > plc.conc_energy:
                lz = clz32(plc.conc_energy) - 1
                plc.conc_energy = i32(plc.conc_energy << lz)
                energy >>= max(24 - lz, 0)
                frac_q24 = silk_div32(plc.conc_energy, max(energy, 1))
                gain_q16 = i32(silk_sqrt_approx(frac_q24) << 4)
                slope_q16 = i32(silk_div32_16((1 << 16) - gain_q16, length) << 2)
                for i in range(length):
                    frame[i] = i16(smulwb(gain_q16, frame[i]))
                    gain_q16 += slope_q16
                    if gain_q16 > 1 << 16:
                        break
        plc.last_frame_lost = 0
