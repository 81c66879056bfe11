"""SILK excitation decode: rate level, shell coder, LSBs, signs.

Parity: reference src/silk/{decode_pulses,shell_coder,code_signs}.rs
(libopus silk/decode_pulses.c etc.), bit-exact.
"""

from __future__ import annotations

from . import tables as T

SHELL_CODEC_FRAME_LENGTH = 16
LOG2_SHELL_CODEC_FRAME_LENGTH = 4
SILK_MAX_PULSES = 16
N_RATE_LEVELS = 10
MAX_NB_SHELL_BLOCKS = 20


def _decode_split(dec, p, shell_table):
    if p > 0:
        off = T.SILK_SHELL_CODE_TABLE_OFFSETS[p]
        child1 = dec.dec_icdf(shell_table[off: off + p + 1], 8)
        return child1, p - child1
    return 0, 0


def shell_decoder(dec, pulses4):
    """Decode one 16-sample shell block of unsigned pulse counts."""
    t0, t1, t2, t3 = T.SILK_SHELL_CODE_TABLES
    out = [0] * 16
    p3 = _decode_split(dec, pulses4, t3)
    p2_01 = _decode_split(dec, p3[0], t2)
    p1_01 = _decode_split(dec, p2_01[0], t1)
    out[0], out[1] = _decode_split(dec, p1_01[0], t0)
    out[2], out[3] = _decode_split(dec, p1_01[1], t0)
    p1_23 = _decode_split(dec, p2_01[1], t1)
    out[4], out[5] = _decode_split(dec, p1_23[0], t0)
    out[6], out[7] = _decode_split(dec, p1_23[1], t0)
    p2_23 = _decode_split(dec, p3[1], t2)
    p1_45 = _decode_split(dec, p2_23[0], t1)
    out[8], out[9] = _decode_split(dec, p1_45[0], t0)
    out[10], out[11] = _decode_split(dec, p1_45[1], t0)
    p1_67 = _decode_split(dec, p2_23[1], t1)
    out[12], out[13] = _decode_split(dec, p1_67[0], t0)
    out[14], out[15] = _decode_split(dec, p1_67[1], t0)
    return out


def decode_signs(dec, pulses, length, signal_type, quant_offset_type, sum_pulses):
    base = 7 * (quant_offset_type + (signal_type << 1))
    icdf_row = T.SILK_SIGN_ICDF[base: base + 7]
    n_blocks = (length + SHELL_CODEC_FRAME_LENGTH // 2) >> LOG2_SHELL_CODEC_FRAME_LENGTH
    for i in range(n_blocks):
        p = sum_pulses[i]
        if p > 0:
            icdf = [icdf_row[min(p & 0x1F, 6)], 0]
            q0 = i * SHELL_CODEC_FRAME_LENGTH
            for j in range(SHELL_CODEC_FRAME_LENGTH):
                if pulses[q0 + j] > 0:
                    pulses[q0 + j] *= 2 * dec.dec_icdf(icdf, 8) - 1


def decode_pulses(dec, signal_type, quant_offset_type, frame_length):
    """Returns the signed excitation pulse array (length padded to blocks)."""
    rate_level_index = dec.dec_icdf(T.SILK_RATE_LEVELS_ICDF[signal_type >> 1], 8)
    n_blocks = frame_length >> LOG2_SHELL_CODEC_FRAME_LENGTH
    if n_blocks * SHELL_CODEC_FRAME_LENGTH < frame_length:
        n_blocks += 1  # only for 10 ms @ 12 kHz (120 samples)

    sum_pulses = [0] * n_blocks
    n_lshifts = [0] * n_blocks
    for i in range(n_blocks):
        sum_pulses[i] = dec.dec_icdf(T.SILK_PULSES_PER_BLOCK_ICDF[rate_level_index], 8)
        while sum_pulses[i] == SILK_MAX_PULSES + 1:
            n_lshifts[i] += 1
            # with 10 LSB rounds, advance table to forbid another escape
            tbl = T.SILK_PULSES_PER_BLOCK_ICDF[N_RATE_LEVELS - 1]
            sum_pulses[i] = dec.dec_icdf(tbl[1:] if n_lshifts[i] == 10 else tbl, 8)

    pulses = [0] * (n_blocks * SHELL_CODEC_FRAME_LENGTH)
    for i in range(n_blocks):
        if sum_pulses[i] > 0:
            pulses[i * 16:(i + 1) * 16] = shell_decoder(dec, sum_pulses[i])

    for i in range(n_blocks):
        if n_lshifts[i] > 0:
            nls = n_lshifts[i]
            for k in range(SHELL_CODEC_FRAME_LENGTH):
                abs_q = pulses[i * 16 + k]
                for _ in range(nls):
                    abs_q = (abs_q << 1) + dec.dec_icdf(T.SILK_LSB_ICDF, 8)
                pulses[i * 16 + k] = abs_q
            sum_pulses[i] |= nls << 5

    decode_signs(dec, pulses, frame_length, signal_type, quant_offset_type,
                 sum_pulses)
    return pulses
