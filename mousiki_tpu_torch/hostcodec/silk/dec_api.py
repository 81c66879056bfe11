"""SILK decoder top level: set_fs, frame decode, stereo unmix, packet API.

Parity: reference src/silk/{decoder_set_fs,decode_frame,stereo_ms_to_lr,
stereo_decode_pred,dec_api}.rs (libopus silk/dec_API.c etc.), bit-exact.
"""

from __future__ import annotations

from . import tables as T
from .cng import silk_cng
from .decode_core import decode_core
from .decode_indices import decode_indices
from .decode_params import decode_parameters
from .decode_pulses import decode_pulses
from .fixed_math import i32, rshift_round, sat16, silk_div32_16, smlabb, smlawb, smulbb, smulwb
from .plc import plc_glue_frames, silk_plc
from .resampler import resampler_init, silk_resampler
from .structs import (CODE_CONDITIONALLY, CODE_INDEPENDENTLY,
                      CODE_INDEPENDENTLY_NO_LTP_SCALING, ChannelDecoderState,
                      DecControl, NLSF_CB_NB_MB, NLSF_CB_WB, SilkDecoder,
                      TYPE_NO_VOICE_ACTIVITY, TYPE_VOICED)

FLAG_DECODE_NORMAL = 0
FLAG_PACKET_LOST = 1
FLAG_DECODE_LBRR = 2

STEREO_INTERP_LEN_MS = 8


class DecCtrl:
    """Per-frame decoded parameters (silk_decoder_control)."""

    def __init__(self):
        self.pitch_l = []
        self.gains_q16 = []
        self.pred_coef_q12 = [None, None]
        self.ltp_coef_q14 = []
        self.ltp_scale_q14 = 0


def init_channel(st: ChannelDecoderState) -> None:
    st.__init__()
    st.first_frame_after_reset = 1
    st.prev_gain_q16 = 65536
    from .cng import cng_reset
    from .plc import plc_reset
    # fs not set yet; reset happens on set_fs


def decoder_set_fs(st: ChannelDecoderState, fs_khz: int, fs_api_hz: int) -> None:
    st.subfr_length = 5 * fs_khz
    frame_length = st.nb_subfr * st.subfr_length

    if st.fs_khz != fs_khz or st.fs_api_hz != fs_api_hz:
        resampler_init(st.resampler_state, fs_khz * 1000, fs_api_hz, False)
        st.fs_api_hz = fs_api_hz

    if st.fs_khz != fs_khz or frame_length != st.frame_length:
        if fs_khz == 8:
            st.pitch_contour_icdf = (T.PITCH_CONTOUR_NB_ICDF if st.nb_subfr == 4
                                     else T.PITCH_CONTOUR_10_MS_NB_ICDF)
        else:
            st.pitch_contour_icdf = (T.PITCH_CONTOUR_ICDF if st.nb_subfr == 4
                                     else T.PITCH_CONTOUR_10_MS_ICDF)
        if st.fs_khz != fs_khz:
            st.ltp_mem_length = 20 * fs_khz
            if fs_khz in (8, 12):
                st.lpc_order = 10
                st.psnlsf_cb = NLSF_CB_NB_MB
            else:
                st.lpc_order = 16
                st.psnlsf_cb = NLSF_CB_WB
            if fs_khz == 16:
                st.pitch_lag_low_bits_icdf = T.SILK_UNIFORM8_ICDF
            elif fs_khz == 12:
                st.pitch_lag_low_bits_icdf = T.SILK_UNIFORM6_ICDF
            else:
                st.pitch_lag_low_bits_icdf = T.SILK_UNIFORM4_ICDF
            st.first_frame_after_reset = 1
            st.lag_prev = 100
            st.last_gain_index = 10
            st.prev_signal_type = TYPE_NO_VOICE_ACTIVITY
            st.out_buf = [0] * len(st.out_buf)
            st.s_lpc_q14_buf = [0] * len(st.s_lpc_q14_buf)
        st.fs_khz = fs_khz
        st.frame_length = frame_length
    assert 0 < st.frame_length <= 320


def decode_frame(st: ChannelDecoderState, dec, lost_flag: int,
                 cond_coding: int) -> list:
    """Decode one 10/20ms SILK frame; returns int16 list of frame_length."""
    L = st.frame_length
    ctrl = DecCtrl()
    ctrl.ltp_scale_q14 = 0
    if (lost_flag == FLAG_DECODE_NORMAL
            or (lost_flag == FLAG_DECODE_LBRR
                and st.lbrr_flags[st.nframes_decoded] == 1)):
        decode_indices(st, dec, st.nframes_decoded,
                       lost_flag == FLAG_DECODE_LBRR, cond_coding)
        pulses = decode_pulses(dec, st.indices.signal_type,
                               st.indices.quant_offset_type, st.frame_length)
        decode_parameters(st, ctrl, cond_coding)
        pout = decode_core(st, ctrl, pulses)
        silk_plc(st, ctrl, pout, False)
        st.loss_cnt = 0
        st.prev_signal_type = st.indices.signal_type
        st.first_frame_after_reset = 0
    else:
        st.indices.signal_type = st.prev_signal_type
        pout = [0] * L
        ctrl.pitch_l = [0] * st.nb_subfr
        ctrl.gains_q16 = [65536] * st.nb_subfr
        silk_plc(st, ctrl, pout, True)

    mv_len = st.ltp_mem_length - st.frame_length
    st.out_buf[:mv_len] = st.out_buf[st.frame_length: st.ltp_mem_length]
    st.out_buf[mv_len: mv_len + L] = pout

    silk_cng(st, ctrl, pout, L)
    plc_glue_frames(st, pout, L)
    st.lag_prev = ctrl.pitch_l[st.nb_subfr - 1] if ctrl.pitch_l else 0
    return pout


def stereo_decode_pred(dec):
    n = dec.dec_icdf(T.SILK_STEREO_PRED_JOINT_ICDF, 8)
    ix = [[0, 0, 0], [0, 0, 0]]
    ix[0][2] = n // 5
    ix[1][2] = n - 5 * ix[0][2]
    for ch in range(2):
        ix[ch][0] = dec.dec_icdf(T.SILK_UNIFORM3_ICDF, 8)
        ix[ch][1] = dec.dec_icdf(T.SILK_UNIFORM5_ICDF, 8)
    pred_q13 = [0, 0]
    for ch in range(2):
        ix[ch][0] += 3 * ix[ch][2]
        low = T.SILK_STEREO_PRED_QUANT_Q13[ix[ch][0]]
        step = smulwb(T.SILK_STEREO_PRED_QUANT_Q13[ix[ch][0] + 1] - low, 6554)
        pred_q13[ch] = smlabb(low, step, 2 * ix[ch][1] + 1)
    pred_q13[0] -= pred_q13[1]
    return pred_q13


def stereo_decode_mid_only(dec) -> int:
    return dec.dec_icdf(T.SILK_STEREO_ONLY_CODE_MID_ICDF, 8)


def stereo_ms_to_lr(state, x1, x2, pred_q13, fs_khz, frame_length):
    """In-place MS->LR; x1/x2 have 2 extra leading history samples."""
    x1[0:2] = state.s_mid
    x2[0:2] = state.s_side
    state.s_mid = list(x1[frame_length: frame_length + 2])
    state.s_side = list(x2[frame_length: frame_length + 2])

    pred0 = state.pred_prev_q13[0]
    pred1 = state.pred_prev_q13[1]
    denom_q16 = silk_div32_16(1 << 16, STEREO_INTERP_LEN_MS * fs_khz)
    delta0 = rshift_round(smulbb(pred_q13[0] - state.pred_prev_q13[0], denom_q16), 16)
    delta1 = rshift_round(smulbb(pred_q13[1] - state.pred_prev_q13[1], denom_q16), 16)
    interp_len = STEREO_INTERP_LEN_MS * fs_khz
    for n in range(interp_len):
        pred0 += delta0
        pred1 += delta1
        s = i32((i32(x1[n] + x1[n + 2]) + (x1[n + 1] << 1)) << 9)
        s = smlawb(i32(x2[n + 1] << 8), s, pred0)
        s = smlawb(s, i32(x1[n + 1] << 11), pred1)
        x2[n + 1] = sat16(rshift_round(s, 8))
    pred0 = pred_q13[0]
    pred1 = pred_q13[1]
    for n in range(interp_len, frame_length):
        s = i32((i32(x1[n] + x1[n + 2]) + (x1[n + 1] << 1)) << 9)
        s = smlawb(i32(x2[n + 1] << 8), s, pred0)
        s = smlawb(s, i32(x1[n + 1] << 11), pred1)
        x2[n + 1] = sat16(rshift_round(s, 8))
    state.pred_prev_q13 = list(pred_q13)

    for n in range(frame_length):
        s = x1[n + 1] + x2[n + 1]
        d = x1[n + 1] - x2[n + 1]
        x1[n + 1] = sat16(s)
        x2[n + 1] = sat16(d)


def silk_decode(psDec: SilkDecoder, ctl: DecControl, lost_flag: int,
                new_packet: bool, dec) -> list:
    """Decode one SILK packet frame-slot; returns int16 PCM interleaved at
    API rate (list of nSamplesOut*channels). Parity silk_Decode (dec_API.c)."""
    cs = psDec.channel_state
    decode_only_middle = 0

    if new_packet:
        for n in range(ctl.n_channels_internal):
            cs[n].nframes_decoded = 0

    if ctl.n_channels_internal > psDec.n_channels_internal:
        init_channel(cs[1])

    stereo_to_mono = (ctl.n_channels_internal == 1
                      and psDec.n_channels_internal == 2
                      and ctl.internal_sample_rate == 1000 * cs[0].fs_khz)

    if cs[0].nframes_decoded == 0:
        for n in range(ctl.n_channels_internal):
            if ctl.payload_size_ms in (0, 10):
                cs[n].nframes_per_packet = 1
                cs[n].nb_subfr = 2
            elif ctl.payload_size_ms == 20:
                cs[n].nframes_per_packet = 1
                cs[n].nb_subfr = 4
            elif ctl.payload_size_ms == 40:
                cs[n].nframes_per_packet = 2
                cs[n].nb_subfr = 4
            elif ctl.payload_size_ms == 60:
                cs[n].nframes_per_packet = 3
                cs[n].nb_subfr = 4
            else:
                raise ValueError("bad payload size")
            fs_khz_dec = (ctl.internal_sample_rate >> 10) + 1
            assert fs_khz_dec in (8, 12, 16)
            decoder_set_fs(cs[n], fs_khz_dec, ctl.api_sample_rate)

    if (ctl.n_channels_api == 2 and ctl.n_channels_internal == 2
            and (psDec.n_channels_api == 1 or psDec.n_channels_internal == 1)):
        psDec.s_stereo.pred_prev_q13 = [0, 0]
        psDec.s_stereo.s_side = [0, 0]
        cs[1].resampler_state = _copy_resampler(cs[0].resampler_state)
    psDec.n_channels_api = ctl.n_channels_api
    psDec.n_channels_internal = ctl.n_channels_internal

    assert ctl.api_sample_rate in (8000, 12000, 16000, 24000, 32000, 44100, 48000)

    if lost_flag != FLAG_PACKET_LOST and cs[0].nframes_decoded == 0:
        # Decode VAD and LBRR flags
        for n in range(ctl.n_channels_internal):
            for i in range(cs[n].nframes_per_packet):
                cs[n].vad_flags[i] = dec.dec_bit_logp(1)
            cs[n].lbrr_flag = dec.dec_bit_logp(1)
        for n in range(ctl.n_channels_internal):
            cs[n].lbrr_flags = [0, 0, 0]
            if cs[n].lbrr_flag:
                if cs[n].nframes_per_packet == 1:
                    cs[n].lbrr_flags[0] = 1
                else:
                    sym = dec.dec_icdf(
                        T.SILK_LBRR_FLAGS_ICDF_PTR[cs[n].nframes_per_packet - 2], 8) + 1
                    for i in range(cs[n].nframes_per_packet):
                        cs[n].lbrr_flags[i] = (sym >> i) & 1
        if lost_flag == FLAG_DECODE_NORMAL:
            # Skip LBRR data
            for i in range(cs[0].nframes_per_packet):
                for n in range(ctl.n_channels_internal):
                    if cs[n].lbrr_flags[i]:
                        if ctl.n_channels_internal == 2 and n == 0:
                            stereo_decode_pred(dec)
                            if cs[1].lbrr_flags[i] == 0:
                                stereo_decode_mid_only(dec)
                        cond = (CODE_CONDITIONALLY if i > 0 and cs[n].lbrr_flags[i - 1]
                                else CODE_INDEPENDENTLY)
                        decode_indices(cs[n], dec, i, True, cond)
                        decode_pulses(dec, cs[n].indices.signal_type,
                                      cs[n].indices.quant_offset_type,
                                      cs[n].frame_length)

    # MS predictor index
    ms_pred_q13 = [0, 0]
    if ctl.n_channels_internal == 2:
        if (lost_flag == FLAG_DECODE_NORMAL
                or (lost_flag == FLAG_DECODE_LBRR
                    and cs[0].lbrr_flags[cs[0].nframes_decoded] == 1)):
            ms_pred_q13 = stereo_decode_pred(dec)
            if ((lost_flag == FLAG_DECODE_NORMAL
                 and cs[1].vad_flags[cs[0].nframes_decoded] == 0)
                    or (lost_flag == FLAG_DECODE_LBRR
                        and cs[1].lbrr_flags[cs[0].nframes_decoded] == 0)):
                decode_only_middle = stereo_decode_mid_only(dec)
            else:
                decode_only_middle = 0
        else:
            ms_pred_q13 = list(psDec.s_stereo.pred_prev_q13)

    if (ctl.n_channels_internal == 2 and decode_only_middle == 0
            and psDec.prev_decode_only_middle == 1):
        cs[1].out_buf = [0] * len(cs[1].out_buf)
        cs[1].s_lpc_q14_buf = [0] * len(cs[1].s_lpc_q14_buf)
        cs[1].lag_prev = 0
        cs[1].last_gain_index = 10
        cs[1].prev_signal_type = TYPE_NO_VOICE_ACTIVITY
        cs[1].first_frame_after_reset = 1

    if lost_flag == FLAG_DECODE_NORMAL:
        has_side = decode_only_middle == 0
    else:
        has_side = (not psDec.prev_decode_only_middle
                    or (ctl.n_channels_internal == 2
                        and lost_flag == FLAG_DECODE_LBRR
                        and cs[1].lbrr_flags[cs[1].nframes_decoded] == 1))

    samples_out1 = [None, None]
    for n in range(ctl.n_channels_internal):
        if n == 0 or has_side:
            frame_index = cs[0].nframes_decoded - n
            if frame_index <= 0:
                cond = CODE_INDEPENDENTLY
            elif lost_flag == FLAG_DECODE_LBRR:
                cond = (CODE_CONDITIONALLY if cs[n].lbrr_flags[frame_index - 1]
                        else CODE_INDEPENDENTLY)
            elif n > 0 and psDec.prev_decode_only_middle:
                cond = CODE_INDEPENDENTLY_NO_LTP_SCALING
            else:
                cond = CODE_CONDITIONALLY
            pout = decode_frame(cs[n], dec, lost_flag, cond)
            samples_out1[n] = [0, 0] + pout
        else:
            samples_out1[n] = [0, 0] + [0] * cs[0].frame_length
        cs[n].nframes_decoded += 1
    n_samples_dec = cs[0].frame_length

    if ctl.n_channels_api == 2 and ctl.n_channels_internal == 2:
        stereo_ms_to_lr(psDec.s_stereo, samples_out1[0], samples_out1[1],
                        ms_pred_q13, cs[0].fs_khz, n_samples_dec)
    else:
        samples_out1[0][0:2] = psDec.s_stereo.s_mid
        psDec.s_stereo.s_mid = list(
            samples_out1[0][n_samples_dec: n_samples_dec + 2])

    n_samples_out = (n_samples_dec * ctl.api_sample_rate) // (cs[0].fs_khz * 1000)
    out = [0] * (n_samples_out * ctl.n_channels_api)

    for n in range(min(ctl.n_channels_api, ctl.n_channels_internal)):
        resampled = silk_resampler(cs[n].resampler_state,
                                   samples_out1[n][1:], n_samples_dec)
        if ctl.n_channels_api == 2:
            for i in range(n_samples_out):
                out[n + 2 * i] = resampled[i]
        else:
            out[:n_samples_out] = resampled[:n_samples_out]

    if ctl.n_channels_api == 2 and ctl.n_channels_internal == 1:
        if stereo_to_mono:
            # in stereo->mono transition, the right resampler keeps running
            resampled2 = silk_resampler(cs[1].resampler_state,
                                        samples_out1[0][1:], n_samples_dec)
            for i in range(n_samples_out):
                out[1 + 2 * i] = resampled2[i]
        else:
            for i in range(n_samples_out):
                out[1 + 2 * i] = out[2 * i]

    if cs[0].prev_signal_type == TYPE_VOICED:
        mult = [6, 4, 3][cs[0].fs_khz // 8 + (1 if cs[0].fs_khz == 12 else 0) - 1] \
            if False else {8: 6, 12: 4, 16: 3}[cs[0].fs_khz]
        ctl.prev_pitch_lag = cs[0].lag_prev * mult
    else:
        ctl.prev_pitch_lag = 0

    if lost_flag == FLAG_PACKET_LOST:
        for i in range(psDec.n_channels_internal):
            cs[i].last_gain_index = 10
    else:
        psDec.prev_decode_only_middle = decode_only_middle
    return out


def _copy_resampler(src):
    import copy
    return copy.deepcopy(src)
