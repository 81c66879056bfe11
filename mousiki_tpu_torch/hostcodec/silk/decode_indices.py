"""SILK side-info decode: frame type, gains, NLSF indices, pitch, LTP, seed.

Parity: reference src/silk/decode_indices.rs (silk_decode_indices) and
decode_pitch.rs; bit-exact against libopus silk/decode_indices.c.
"""

from __future__ import annotations

from . import tables as T
from .structs import (CODE_CONDITIONALLY, ChannelDecoderState, MAX_LPC_ORDER,
                      TYPE_NO_VOICE_ACTIVITY)


def decode_indices(st: ChannelDecoderState, dec, frame_index: int,
                   decode_lbrr: bool, cond_coding: int) -> None:
    ix = st.indices

    # Signal type and quantizer offset
    if decode_lbrr or st.vad_flags[frame_index]:
        ix_val = dec.dec_icdf(T.SILK_TYPE_OFFSET_VAD_ICDF, 8) + 2
    else:
        ix_val = dec.dec_icdf(T.SILK_TYPE_OFFSET_NO_VAD_ICDF, 8)
    ix.signal_type = ix_val >> 1
    ix.quant_offset_type = ix_val & 1

    # Gains
    if cond_coding == CODE_CONDITIONALLY:
        ix.gains_indices[0] = dec.dec_icdf(T.SILK_DELTA_GAIN_ICDF, 8)
    else:
        # Independent: MSB conditioned on signal type, LSB uniform
        ix.gains_indices[0] = dec.dec_icdf(T.SILK_GAIN_ICDF[ix.signal_type], 8) << 3
        ix.gains_indices[0] += dec.dec_icdf(T.SILK_UNIFORM8_ICDF, 8)
    for i in range(1, st.nb_subfr):
        ix.gains_indices[i] = dec.dec_icdf(T.SILK_DELTA_GAIN_ICDF, 8)

    # NLSF: stage 1 index (voiced/unvoiced table halves), then stage-2
    # residuals with codebook-selected iCDFs
    cb = st.psnlsf_cb
    half = (1 if ix.signal_type == 2 else 0) * cb.n_vectors
    ix.nlsf_indices[0] = dec.dec_icdf(cb.cb1_icdf[half: half + cb.n_vectors], 8)
    ec_ix, _pred = nlsf_unpack(cb, ix.nlsf_indices[0])
    for i in range(cb.order):
        icdf = cb.ec_icdf[ec_ix[i]: ec_ix[i] + 9]
        val = dec.dec_icdf(icdf, 8)
        if val == 0:
            val -= dec.dec_icdf(T.SILK_NLSF_EXT_ICDF, 8)
        elif val == 2 * 4:  # 2 * NLSF_QUANT_MAX_AMPLITUDE
            val += dec.dec_icdf(T.SILK_NLSF_EXT_ICDF, 8)
        ix.nlsf_indices[i + 1] = val - 4

    # NLSF interpolation factor (20ms frames only)
    if st.nb_subfr == 4:
        ix.nlsf_interp_coef_q2 = dec.dec_icdf(T.SILK_NLSF_INTERPOLATION_FACTOR_ICDF, 8)
    else:
        ix.nlsf_interp_coef_q2 = 4

    if ix.signal_type == 2:  # TYPE_VOICED
        ix.lag_index = _decode_lag(st, dec, cond_coding)
        st.ec_prev_lag_index = ix.lag_index

        # Pitch contour
        ix.contour_index = dec.dec_icdf(st.pitch_contour_icdf, 8)

        # LTP gains: periodicity index + per-subframe filter indices
        ix.per_index = dec.dec_icdf(T.SILK_LTP_PER_INDEX_ICDF, 8)
        for k in range(st.nb_subfr):
            ix.ltp_index[k] = dec.dec_icdf(T.SILK_LTP_GAIN_ICDF_PTRS[ix.per_index], 8)

        # LTP scaling
        if cond_coding == 0:  # CODE_INDEPENDENTLY
            ix.ltp_scale_index = dec.dec_icdf(T.SILK_LTPSCALE_ICDF, 8)
        else:
            ix.ltp_scale_index = 0
    st.ec_prev_signal_type = ix.signal_type

    # Seed
    ix.seed = dec.dec_icdf(T.SILK_UNIFORM4_ICDF, 8)


def _decode_lag(st: ChannelDecoderState, dec, cond_coding: int) -> int:
    """Primary lag: delta-coded when conditional, else absolute (high+low)."""
    decoded = False
    lag_index = 0
    if cond_coding == CODE_CONDITIONALLY and st.ec_prev_signal_type == 2:
        delta = dec.dec_icdf(T.PITCH_DELTA_ICDF, 8)
        if delta > 0:
            lag_index = st.ec_prev_lag_index + (delta - 9)
            decoded = True
    if not decoded:
        high = dec.dec_icdf(T.PITCH_LAG_ICDF, 8)
        lag_index = high * (st.fs_khz >> 1) + dec.dec_icdf(st.pitch_lag_low_bits_icdf, 8)
    return lag_index


def nlsf_unpack(cb, ci: int):
    """Unpack entropy table indices + prediction flags for stage-1 index ci.

    Parity: silk/NLSF_unpack.c — each byte of ec_sel holds two nibbles:
    (icdf_entry<<1 | pred_flag) per coefficient.
    """
    ec_ix = [0] * cb.order
    pred_q8 = [0] * cb.order
    base = ci * cb.order // 2
    for i in range(cb.order // 2):
        entry = cb.ec_sel[base + i]
        ec_ix[2 * i] = ((entry >> 1) & 7) * (2 * 4 + 1)
        pred_q8[2 * i] = cb.pred_q8[2 * i + (entry & 1) * (cb.order - 1)]
        ec_ix[2 * i + 1] = ((entry >> 5) & 7) * (2 * 4 + 1)
        pred_q8[2 * i + 1] = cb.pred_q8[2 * i + ((entry >> 4) & 1) * (cb.order - 1) + 1]
    return ec_ix, pred_q8
