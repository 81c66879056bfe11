"""SILK fixed-point resampler (parity: reference src/silk/resampler*.rs,
libopus silk/resampler*.c) — bit-exact.

Decoder side uses: copy, 2x allpass upsampler (up2_HQ), IIR+FIR fractional
upsampler, and AR2+FIR downsamplers.
"""

from __future__ import annotations

from . import tables as T
from .fixed_math import (i16, i32, rshift_round, sat16, silk_div32, smlawb,
                         smulbb, smulwb, smulww)
from .structs import ResamplerState

RESAMPLER_MAX_BATCH_SIZE_MS = 10
RESAMPLER_ORDER_FIR_12 = 8

FUNC_COPY = 0
FUNC_UP2_HQ = 1
FUNC_IIR_FIR = 2
FUNC_DOWN_FIR = 3

_DELAY_MATRIX_DEC = [
    [4, 0, 2, 0, 0],
    [0, 9, 4, 7, 4],
    [0, 3, 12, 7, 7],
]
_DELAY_MATRIX_ENC = [
    [6, 0, 3],
    [0, 7, 3],
    [0, 1, 10],
    [0, 2, 6],
    [18, 10, 12],
]


def _rate_id(r: int) -> int:
    return (((r >> 12) - (1 if r > 16000 else 0)) >> (1 if r > 24000 else 0)) - 1


def resampler_init(S: ResamplerState, fs_hz_in: int, fs_hz_out: int,
                   for_enc: bool) -> None:
    S.s_iir = [0] * 6
    S.s_fir = [0] * 36
    S.delay_buf = [0] * 48
    if for_enc:
        assert fs_hz_in in (8000, 12000, 16000, 24000, 48000)
        assert fs_hz_out in (8000, 12000, 16000)
        S.input_delay = _DELAY_MATRIX_ENC[_rate_id(fs_hz_in)][_rate_id(fs_hz_out)]
    else:
        assert fs_hz_in in (8000, 12000, 16000)
        assert fs_hz_out in (8000, 12000, 16000, 24000, 48000)
        S.input_delay = _DELAY_MATRIX_DEC[_rate_id(fs_hz_in)][_rate_id(fs_hz_out)]

    S.fs_in_khz = fs_hz_in // 1000
    S.fs_out_khz = fs_hz_out // 1000
    S.batch_size = S.fs_in_khz * RESAMPLER_MAX_BATCH_SIZE_MS

    up2x = 0
    if fs_hz_out > fs_hz_in:
        if fs_hz_out == 2 * fs_hz_in:
            S.resampler_function = FUNC_UP2_HQ
        else:
            S.resampler_function = FUNC_IIR_FIR
            up2x = 1
    elif fs_hz_out < fs_hz_in:
        S.resampler_function = FUNC_DOWN_FIR
        if 4 * fs_hz_out == 3 * fs_hz_in:
            S.fir_fracs = 3
            S.fir_order = 18
            S.coefs = T.SILK_RESAMPLER_3_4_COEFS
        elif 3 * fs_hz_out == 2 * fs_hz_in:
            S.fir_fracs = 2
            S.fir_order = 18
            S.coefs = T.SILK_RESAMPLER_2_3_COEFS
        elif 2 * fs_hz_out == fs_hz_in:
            S.fir_fracs = 1
            S.fir_order = 24
            S.coefs = T.SILK_RESAMPLER_1_2_COEFS
        elif 3 * fs_hz_out == fs_hz_in:
            S.fir_fracs = 1
            S.fir_order = 36
            S.coefs = T.SILK_RESAMPLER_1_3_COEFS
        elif 4 * fs_hz_out == fs_hz_in:
            S.fir_fracs = 1
            S.fir_order = 36
            S.coefs = T.SILK_RESAMPLER_1_4_COEFS
        elif 6 * fs_hz_out == fs_hz_in:
            S.fir_fracs = 1
            S.fir_order = 36
            S.coefs = T.SILK_RESAMPLER_1_6_COEFS
        else:
            raise ValueError("unsupported ratio")
    else:
        S.resampler_function = FUNC_COPY

    S.inv_ratio_q16 = i32(silk_div32(i32(fs_hz_in << (14 + up2x)), fs_hz_out) << 2)
    while smulww(S.inv_ratio_q16, fs_hz_out) < i32(fs_hz_in << up2x):
        S.inv_ratio_q16 += 1


def _up2_hq(s_iir, inp, off, length):
    """2x allpass upsampler; returns 2*length int16 samples."""
    c0 = T.SILK_RESAMPLER_UP2_HQ_0
    c1 = T.SILK_RESAMPLER_UP2_HQ_1
    out = [0] * (2 * length)
    for k in range(length):
        in32 = i32(inp[off + k] << 10)
        Y = i32(in32 - s_iir[0])
        X = smulwb(Y, c0[0])
        out32_1 = i32(s_iir[0] + X)
        s_iir[0] = i32(in32 + X)
        Y = i32(out32_1 - s_iir[1])
        X = smulwb(Y, c0[1])
        out32_2 = i32(s_iir[1] + X)
        s_iir[1] = i32(out32_1 + X)
        Y = i32(out32_2 - s_iir[2])
        X = smlawb(Y, Y, c0[2])
        out32_1 = i32(s_iir[2] + X)
        s_iir[2] = i32(out32_2 + X)
        out[2 * k] = sat16(rshift_round(out32_1, 10))
        Y = i32(in32 - s_iir[3])
        X = smulwb(Y, c1[0])
        out32_1 = i32(s_iir[3] + X)
        s_iir[3] = i32(in32 + X)
        Y = i32(out32_1 - s_iir[4])
        X = smulwb(Y, c1[1])
        out32_2 = i32(s_iir[4] + X)
        s_iir[4] = i32(out32_1 + X)
        Y = i32(out32_2 - s_iir[5])
        X = smlawb(Y, Y, c1[2])
        out32_1 = i32(s_iir[5] + X)
        s_iir[5] = i32(out32_2 + X)
        out[2 * k + 1] = sat16(rshift_round(out32_1, 10))
    return out


def _iir_fir(S: ResamplerState, inp, off, in_len):
    out = []
    buf = list(S.s_fir[:RESAMPLER_ORDER_FIR_12])
    frac = T.SILK_RESAMPLER_FRAC_FIR_12
    incr = S.inv_ratio_q16
    while True:
        n = min(in_len, S.batch_size)
        up = _up2_hq(S.s_iir, inp, off, n)
        buf = buf[:RESAMPLER_ORDER_FIR_12] + up
        max_index_q16 = n << 17
        index_q16 = 0
        while index_q16 < max_index_q16:
            ti = smulwb(index_q16 & 0xFFFF, 12)
            b = index_q16 >> 16
            res = smulbb(buf[b + 0], frac[ti][0])
            res = i32(res + smulbb(buf[b + 1], frac[ti][1]))
            res = i32(res + smulbb(buf[b + 2], frac[ti][2]))
            res = i32(res + smulbb(buf[b + 3], frac[ti][3]))
            res = i32(res + smulbb(buf[b + 4], frac[11 - ti][3]))
            res = i32(res + smulbb(buf[b + 5], frac[11 - ti][2]))
            res = i32(res + smulbb(buf[b + 6], frac[11 - ti][1]))
            res = i32(res + smulbb(buf[b + 7], frac[11 - ti][0]))
            out.append(sat16(rshift_round(res, 15)))
            index_q16 += incr
        off += n
        in_len -= n
        if in_len > 0:
            buf = buf[n << 1:]
        else:
            break
    S.s_fir[:RESAMPLER_ORDER_FIR_12] = buf[n << 1: (n << 1) + RESAMPLER_ORDER_FIR_12]
    return out


def _ar2(s_iir, inp, off, a_q14, length):
    out = [0] * length
    for k in range(length):
        out32 = i32(s_iir[0] + (i32(inp[off + k]) << 8))
        out[k] = out32
        out32 = i32(out32 << 2)
        s_iir[0] = smlawb(s_iir[1], out32, a_q14[0])
        s_iir[1] = smulwb(out32, a_q14[1])
    return out


def _down_fir(S: ResamplerState, inp, off, in_len):
    out = []
    buf = list(S.s_fir[: S.fir_order])
    coefs = S.coefs
    fir = coefs[2:]
    incr = S.inv_ratio_q16
    while True:
        n = min(in_len, S.batch_size)
        buf = buf[: S.fir_order] + _ar2(S.s_iir, inp, off, coefs, n)
        max_index_q16 = n << 16
        index_q16 = 0
        while index_q16 < max_index_q16:
            b = index_q16 >> 16
            if S.fir_order == 18:
                ii = smulwb(index_q16 & 0xFFFF, S.fir_fracs)
                p = 9 * ii
                res = smulwb(buf[b + 0], fir[p + 0])
                for t in range(1, 9):
                    res = smlawb(res, buf[b + t], fir[p + t])
                p = 9 * (S.fir_fracs - 1 - ii)
                for t in range(9):
                    res = smlawb(res, buf[b + 17 - t], fir[p + t])
            elif S.fir_order == 24:
                res = smulwb(i32(buf[b + 0] + buf[b + 23]), fir[0])
                for t in range(1, 12):
                    res = smlawb(res, i32(buf[b + t] + buf[b + 23 - t]), fir[t])
            else:  # 36
                res = smulwb(i32(buf[b + 0] + buf[b + 35]), fir[0])
                for t in range(1, 18):
                    res = smlawb(res, i32(buf[b + t] + buf[b + 35 - t]), fir[t])
            out.append(sat16(rshift_round(res, 6)))
            index_q16 += incr
        off += n
        in_len -= n
        if in_len > 1:
            buf = buf[n:]
        else:
            break
    S.s_fir[: S.fir_order] = buf[n: n + S.fir_order]
    return out


def silk_resampler(S: ResamplerState, inp, in_len: int):
    """Resample int16 list inp (length in_len); returns int16 list."""
    assert in_len >= S.fs_in_khz
    assert S.input_delay <= S.fs_in_khz
    n = S.fs_in_khz - S.input_delay
    S.delay_buf[S.input_delay: S.input_delay + n] = inp[:n]

    if S.resampler_function == FUNC_UP2_HQ:
        out = _up2_hq(S.s_iir, S.delay_buf, 0, S.fs_in_khz)
        out += _up2_hq(S.s_iir, inp, n, in_len - S.fs_in_khz)
    elif S.resampler_function == FUNC_IIR_FIR:
        out = _iir_fir(S, S.delay_buf, 0, S.fs_in_khz)
        out += _iir_fir(S, inp, n, in_len - S.fs_in_khz)
    elif S.resampler_function == FUNC_DOWN_FIR:
        out = _down_fir(S, S.delay_buf, 0, S.fs_in_khz)
        out += _down_fir(S, inp, n, in_len - S.fs_in_khz)
    else:
        out = list(S.delay_buf[: S.fs_in_khz]) + list(inp[n: n + in_len - S.fs_in_khz])

    S.delay_buf[: S.input_delay] = inp[in_len - S.input_delay: in_len]
    return out
