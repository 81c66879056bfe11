"""SILK core synthesis: excitation build + LTP + LPC filtering (the decoder
hot loop — reference src/silk/decode_core.rs [HOT], SURVEY.md §2.9.5).

This is the bit-exact host reference; the batched TPU formulation
(impulse-response matmul per subframe) lives in mousiki_tpu/ops.
"""

from __future__ import annotations

from .fixed_math import (add_sat32, i16, i32, lshift_sat32, rshift_round,
                         sat16, silk_div32_varq, silk_inverse32_varq, smlawb,
                         smulwb, smulww)
from .structs import (LTP_ORDER, MAX_LPC_ORDER, TYPE_VOICED)
from . import tables as T

QUANT_LEVEL_ADJUST_Q10 = 80
RAND_MULTIPLIER = 196314165
RAND_INCREMENT = 907633515


def silk_rand(seed: int) -> int:
    return i32(RAND_INCREMENT + i32(seed * RAND_MULTIPLIER))


def lpc_analysis_filter(out, inp, off, B, length, d):
    """out[ix] = in[off+ix] - B*in[off+ix-1-..]; first d samples zeroed."""
    for ix in range(d, length):
        p = off + ix - 1
        out32_q12 = 0
        for j in range(d):
            out32_q12 = i32(out32_q12 + i16(inp[p - j]) * i16(B[j]))
        out32_q12 = i32((i32(inp[p + 1]) << 12) - out32_q12)
        out[ix] = sat16(rshift_round(out32_q12, 12))
    for ix in range(d):
        out[ix] = 0


def decode_core(st, ctrl, pulses):
    """Run the inverse NSQ; returns int16 list xq of frame_length samples."""
    ix = st.indices
    offset_q10 = T.SILK_QUANTIZATION_OFFSETS_Q10[ix.signal_type >> 1][ix.quant_offset_type]
    nlsf_interp_flag = 1 if ix.nlsf_interp_coef_q2 < 4 else 0

    # Decode excitation
    rand_seed = i32(ix.seed)
    exc = st.exc_q14
    for i in range(st.frame_length):
        rand_seed = silk_rand(rand_seed)
        v = i32(pulses[i] << 14)
        if v > 0:
            v -= QUANT_LEVEL_ADJUST_Q10 << 4
        elif v < 0:
            v += QUANT_LEVEL_ADJUST_Q10 << 4
        v = i32(v + (offset_q10 << 4))
        if rand_seed < 0:
            v = -v
        exc[i] = v
        rand_seed = i32(rand_seed + pulses[i])

    sLPC = list(st.s_lpc_q14_buf) + [0] * st.subfr_length
    sLTP = [0] * st.ltp_mem_length
    sLTP_q15 = [0] * (st.ltp_mem_length + st.frame_length)
    xq = [0] * st.frame_length
    sLTP_buf_idx = st.ltp_mem_length
    lag = 0

    for k in range(st.nb_subfr):
        A_q12 = ctrl.pred_coef_q12[k >> 1]
        B_q14 = ctrl.ltp_coef_q14[k * LTP_ORDER:(k + 1) * LTP_ORDER]
        signal_type = ix.signal_type

        gain_q10 = ctrl.gains_q16[k] >> 6
        inv_gain_q31 = silk_inverse32_varq(ctrl.gains_q16[k], 47)

        if ctrl.gains_q16[k] != st.prev_gain_q16:
            gain_adj_q16 = silk_div32_varq(st.prev_gain_q16, ctrl.gains_q16[k], 16)
            for i in range(MAX_LPC_ORDER):
                sLPC[i] = smulww(gain_adj_q16, sLPC[i])
        else:
            gain_adj_q16 = 1 << 16

        st.prev_gain_q16 = ctrl.gains_q16[k]

        # Avoid abrupt transition from voiced PLC to unvoiced decoding
        if (st.loss_cnt and st.prev_signal_type == TYPE_VOICED
                and ix.signal_type != TYPE_VOICED and k < 2):
            B_q14 = [0] * LTP_ORDER
            B_q14[LTP_ORDER // 2] = 4096  # 0.25 in Q14
            signal_type = TYPE_VOICED
            ctrl.pitch_l[k] = st.lag_prev

        if signal_type == TYPE_VOICED:
            lag = ctrl.pitch_l[k]
            if k == 0 or (k == 2 and nlsf_interp_flag):
                # Re-whiten the LTP state with the current LPC
                start_idx = st.ltp_mem_length - lag - st.lpc_order - LTP_ORDER // 2
                assert start_idx > 0
                if k == 2:
                    st.out_buf[st.ltp_mem_length: st.ltp_mem_length + 2 * st.subfr_length] = \
                        xq[: 2 * st.subfr_length]
                scratch = [0] * (st.ltp_mem_length - start_idx)
                lpc_analysis_filter(scratch, st.out_buf,
                                    start_idx + k * st.subfr_length, A_q12,
                                    st.ltp_mem_length - start_idx, st.lpc_order)
                for i2, v in enumerate(scratch):
                    sLTP[start_idx + i2] = v
                if k == 0:
                    inv_gain_q31 = i32(smulwb(inv_gain_q31, ctrl.ltp_scale_q14) << 2)
                for i in range(lag + LTP_ORDER // 2):
                    sLTP_q15[sLTP_buf_idx - i - 1] = smulwb(
                        inv_gain_q31, sLTP[st.ltp_mem_length - i - 1])
            else:
                if gain_adj_q16 != 1 << 16:
                    for i in range(lag + LTP_ORDER // 2):
                        sLTP_q15[sLTP_buf_idx - i - 1] = smulww(
                            gain_adj_q16, sLTP_q15[sLTP_buf_idx - i - 1])

        if signal_type == TYPE_VOICED:
            res_q14 = [0] * st.subfr_length
            pl = sLTP_buf_idx - lag + LTP_ORDER // 2
            for i in range(st.subfr_length):
                ltp_pred_q13 = 2
                ltp_pred_q13 = smlawb(ltp_pred_q13, sLTP_q15[pl + 0], B_q14[0])
                ltp_pred_q13 = smlawb(ltp_pred_q13, sLTP_q15[pl - 1], B_q14[1])
                ltp_pred_q13 = smlawb(ltp_pred_q13, sLTP_q15[pl - 2], B_q14[2])
                ltp_pred_q13 = smlawb(ltp_pred_q13, sLTP_q15[pl - 3], B_q14[3])
                ltp_pred_q13 = smlawb(ltp_pred_q13, sLTP_q15[pl - 4], B_q14[4])
                pl += 1
                res_q14[i] = i32(exc[k * st.subfr_length + i] + i32(ltp_pred_q13 << 1))
                sLTP_q15[sLTP_buf_idx] = i32(res_q14[i] << 1)
                sLTP_buf_idx += 1
        else:
            res_q14 = exc[k * st.subfr_length:(k + 1) * st.subfr_length]

        for i in range(st.subfr_length):
            lpc_pred_q10 = st.lpc_order >> 1
            for j in range(st.lpc_order):
                lpc_pred_q10 = smlawb(lpc_pred_q10,
                                      sLPC[MAX_LPC_ORDER + i - 1 - j], A_q12[j])
            sLPC[MAX_LPC_ORDER + i] = add_sat32(res_q14[i],
                                                lshift_sat32(lpc_pred_q10, 4))
            xq[k * st.subfr_length + i] = sat16(
                rshift_round(smulww(sLPC[MAX_LPC_ORDER + i], gain_q10), 8))

        sLPC[:MAX_LPC_ORDER] = sLPC[st.subfr_length: st.subfr_length + MAX_LPC_ORDER]

    st.s_lpc_q14_buf[:] = sLPC[:MAX_LPC_ORDER]
    return xq
