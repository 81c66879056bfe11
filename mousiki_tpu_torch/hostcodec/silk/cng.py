"""SILK comfort noise generation (parity: reference src/silk/cng.rs,
libopus 1.3.1 silk/CNG.c)."""

from __future__ import annotations

from .decode_core import silk_rand
from .decode_params import nlsf2a
from .fixed_math import (add_sat32, i16, i32, lshift_sat32, rshift_round,
                         sat16, silk_div32_16, silk_sqrt_approx, smlawb,
                         smulwb, smulww)
from .structs import MAX_LPC_ORDER, TYPE_NO_VOICE_ACTIVITY

CNG_BUF_MASK_MAX = 255
CNG_NLSF_SMTH_Q16 = 16348
CNG_GAIN_SMTH_Q16 = 4634


def _add_sat16(a, b):
    return max(-32768, min(32767, a + b))


def cng_reset(st):
    nlsf_step_q15 = silk_div32_16(32767, st.lpc_order + 1)
    acc = 0
    for i in range(st.lpc_order):
        acc += nlsf_step_q15
        st.s_cng.cng_smth_nlsf_q15[i] = acc
    st.s_cng.cng_smth_gain_q16 = 0
    st.s_cng.rand_seed = 3176576


def _cng_exc(exc_buf_q14, length, rand_seed):
    exc_mask = CNG_BUF_MASK_MAX
    while exc_mask > length:
        exc_mask >>= 1
    seed = rand_seed
    out = [0] * length
    for i in range(length):
        seed = silk_rand(seed)
        idx = (seed >> 24) & exc_mask
        out[i] = exc_buf_q14[idx]
    return out, seed


def silk_cng(st, ctrl, frame, length):
    cng = st.s_cng
    if st.fs_khz != cng.fs_khz:
        cng_reset(st)
        cng.fs_khz = st.fs_khz

    if st.loss_cnt == 0 and st.prev_signal_type == TYPE_NO_VOICE_ACTIVITY:
        for i in range(st.lpc_order):
            cng.cng_smth_nlsf_q15[i] += smulwb(
                st.prev_nlsf_q15[i] - cng.cng_smth_nlsf_q15[i], CNG_NLSF_SMTH_Q16)
        max_gain = 0
        subfr = 0
        for i in range(st.nb_subfr):
            if ctrl.gains_q16[i] > max_gain:
                max_gain = ctrl.gains_q16[i]
                subfr = i
        # shift buffer and insert highest-gain subframe excitation
        cng.cng_exc_buf_q14[st.subfr_length:st.nb_subfr * st.subfr_length] = \
            cng.cng_exc_buf_q14[: (st.nb_subfr - 1) * st.subfr_length]
        cng.cng_exc_buf_q14[: st.subfr_length] = \
            st.exc_q14[subfr * st.subfr_length:(subfr + 1) * st.subfr_length]
        for i in range(st.nb_subfr):
            cng.cng_smth_gain_q16 += smulwb(
                ctrl.gains_q16[i] - cng.cng_smth_gain_q16, CNG_GAIN_SMTH_Q16)

    if st.loss_cnt:
        gain_q16 = smulww(st.s_plc.rand_scale_q14, st.s_plc.prev_gain_q16[1])
        if gain_q16 >= (1 << 21) or cng.cng_smth_gain_q16 > (1 << 23):
            # high-gain path: top-half multiplies to avoid int32 overflow
            gain_q16 = (gain_q16 >> 16) * (gain_q16 >> 16)
            gain_q16 = i32((cng.cng_smth_gain_q16 >> 16) * (cng.cng_smth_gain_q16 >> 16)
                           - (gain_q16 << 5))
            gain_q16 = i32(silk_sqrt_approx(gain_q16) << 16)
        else:
            gain_q16 = smulww(gain_q16, gain_q16)
            gain_q16 = i32(smulww(cng.cng_smth_gain_q16, cng.cng_smth_gain_q16)
                           - (gain_q16 << 5))
            gain_q16 = i32(silk_sqrt_approx(gain_q16) << 8)
        gain_q10 = gain_q16 >> 6

        exc, cng.rand_seed = _cng_exc(cng.cng_exc_buf_q14, length, cng.rand_seed)
        a_q12 = nlsf2a(cng.cng_smth_nlsf_q15[: st.lpc_order], st.lpc_order)
        sig = list(cng.cng_synth_state) + exc
        for i in range(length):
            lpc_pred_q10 = st.lpc_order >> 1
            for j in range(st.lpc_order):
                lpc_pred_q10 = smlawb(lpc_pred_q10,
                                      sig[MAX_LPC_ORDER + i - 1 - j], a_q12[j])
            sig[MAX_LPC_ORDER + i] = add_sat32(sig[MAX_LPC_ORDER + i],
                                               lshift_sat32(lpc_pred_q10, 4))
            frame[i] = _add_sat16(frame[i], sat16(rshift_round(
                smulww(sig[MAX_LPC_ORDER + i], gain_q10), 8)))
        cng.cng_synth_state[:] = sig[length: length + MAX_LPC_ORDER]
    else:
        for i in range(st.lpc_order):
            cng.cng_synth_state[i] = 0
