"""SILK fixed-point primitives (bit-exact int32/int16 semantics).

SILK is integer-deterministic in every libopus build, so our host decoder
reproduces it exactly (output int16 PCM equality is the conformance gate).
Parity: reference `src/silk/{macros,inlines,lin2log,log2lin,bwexpander,...}`.

All helpers take/return Python ints; values are kept in two's-complement
int32 range by explicit wrapping where C would wrap.
"""

from __future__ import annotations


def i32(x: int) -> int:
    """Wrap to signed 32-bit (C int32 overflow semantics)."""
    x &= 0xFFFFFFFF
    return x - 0x100000000 if x & 0x80000000 else x


def i16(x: int) -> int:
    x &= 0xFFFF
    return x - 0x10000 if x & 0x8000 else x


def sat16(x: int) -> int:
    return max(-32768, min(32767, x))


def sat32(x: int) -> int:
    return max(-0x80000000, min(0x7FFFFFFF, x))


def smulwb(a: int, b: int) -> int:
    """(a * (int16)b) >> 16."""
    return i32((a * i16(b)) >> 16)


def smlawb(a: int, b: int, c: int) -> int:
    return i32(a + ((b * i16(c)) >> 16))


def smulwt(a: int, b: int) -> int:
    """(a * (b >> 16)) + ((a * (uint16)b) >> 16)? — C: a * (b>>16) hi-part mul."""
    return i32(((a >> 16) * (b >> 16)) + (((a & 0x0000FFFF) * (b >> 16)) >> 16))


def smlawt(a: int, b: int, c: int) -> int:
    return i32(a + smulwt(b, c))


def smulbb(a: int, b: int) -> int:
    return i32(i16(a) * i16(b))


def smlabb(a: int, b: int, c: int) -> int:
    return i32(a + i16(b) * i16(c))


def smulbt(a: int, b: int) -> int:
    return i32(i16(a) * (b >> 16))


def smlabt(a: int, b: int, c: int) -> int:
    return i32(a + i16(b) * (c >> 16))


def smulww(a: int, b: int) -> int:
    """(a * b) >> 16 with 64-bit intermediate."""
    return i32((a * b) >> 16)


def smlaww(a: int, b: int, c: int) -> int:
    return i32(a + ((b * c) >> 16))


def smull(a: int, b: int) -> int:
    return a * b  # 64-bit in C; Python exact


def mla(a: int, b: int, c: int) -> int:
    return i32(a + b * c)


def add_sat32(a: int, b: int) -> int:
    return sat32(a + b)


def sub_sat32(a: int, b: int) -> int:
    return sat32(a - b)


def add_lshift32(a: int, b: int, shift: int) -> int:
    return i32(a + (b << shift))


def add_rshift32(a: int, b: int, shift: int) -> int:
    return i32(a + (b >> shift))


def rshift_round(a: int, shift: int) -> int:
    """C silk_RSHIFT_ROUND: ((a >> (shift-1)) + 1) >> 1 (arithmetic)."""
    if shift == 1:
        return (a >> 1) + (a & 1)
    return ((a >> (shift - 1)) + 1) >> 1


def rshift_round64(a: int, shift: int) -> int:
    return ((a >> (shift - 1)) + 1) >> 1


def lshift_sat32(a: int, shift: int) -> int:
    return sat32(a << shift)


def clz32(x: int) -> int:
    x &= 0xFFFFFFFF
    if x == 0:
        return 32
    return 32 - x.bit_length()


def silk_div32_16(a: int, b: int) -> int:
    """C truncating division."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def silk_div32(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def silk_div32_varq(a32: int, b32: int, qres: int) -> int:
    """silk_DIV32_varQ: a/b with qres fractional bits (bit-exact port)."""
    a_headrm = clz32(abs(a32)) - 1
    a32_nrm = i32(a32 << a_headrm)
    b_headrm = clz32(abs(b32)) - 1
    b32_nrm = i32(b32 << b_headrm)
    b32_inv = silk_div32_16(0x7FFFFFFF >> 2, b32_nrm >> 16)
    result = smulwb(a32_nrm, b32_inv)
    a32_nrm = i32(a32_nrm - i32(smmul(b32_nrm, result) << 3))
    result = smlawb(result, a32_nrm, b32_inv)
    lshift = 29 + a_headrm - b_headrm - qres
    if lshift < 0:
        return lshift_sat32(result, -lshift)
    if lshift < 32:
        return result >> lshift
    return 0


def silk_inverse32_varq(b32: int, qres: int) -> int:
    """silk_INVERSE32_varQ: (1 << qres) / b32."""
    b_headrm = clz32(abs(b32)) - 1
    b32_nrm = i32(b32 << b_headrm)
    b32_inv = silk_div32_16(0x7FFFFFFF >> 2, b32_nrm >> 16)
    result = i32(b32_inv << 16)
    err_q32 = i32((i32((1 << 29) - smulwb(b32_nrm, b32_inv))) << 3)
    result = smlaww(result, err_q32, b32_inv)
    lshift = 61 - b_headrm - qres
    if lshift <= 0:
        return lshift_sat32(result, -lshift)
    if lshift < 32:
        return result >> lshift
    return 0


def smmul(a: int, b: int) -> int:
    return i32((a * b) >> 32)


def silk_lin2log(in_lin: int) -> int:
    """Approx 128*log2(in_lin) (Q7)."""
    lz, frac_q7 = silk_clz_frac(in_lin)
    return i32(((31 - lz) << 7) + smlawb(frac_q7, smulbb(frac_q7, 128 - frac_q7), 179))


def silk_clz_frac(x: int) -> tuple[int, int]:
    lz = clz32(x)
    frac_q7 = (rotr32(x, 24 - lz) & 0x7F) if x != 0 else 0
    return lz, frac_q7


def rotr32(x: int, r: int) -> int:
    x &= 0xFFFFFFFF
    r &= 31
    return ((x >> r) | (x << (32 - r))) & 0xFFFFFFFF


def silk_log2lin(in_log_q7: int) -> int:
    """Approx 2^(in_log_q7/128)."""
    if in_log_q7 < 0:
        return 0
    if in_log_q7 >= 3967:
        return 0x7FFFFFFF
    out = i32(1 << (in_log_q7 >> 7))
    frac_q7 = in_log_q7 & 0x7F
    if in_log_q7 < 2048:
        out = i32(out + ((out * smlawb(frac_q7, smulbb(frac_q7, 128 - frac_q7), -174)) >> 7))
    else:
        out = mla(out, out >> 7, smlawb(frac_q7, smulbb(frac_q7, 128 - frac_q7), -174))
    return out


def silk_sqrt_approx(x: int) -> int:
    if x <= 0:
        return 0
    lz, frac_q7 = silk_clz_frac(x)
    y = 32768 if (lz & 1) else 46214  # 46214 = sqrt(2)*32768
    y >>= lz >> 1
    y = smlawb(y, y, smulbb(213, frac_q7))
    return i32(y)


def silk_bwexpander(ar: list, d: int, chirp_q16: int) -> None:
    """In-place bandwidth expansion of int16 AR coefficients.

    NB: plain MUL + RSHIFT_ROUND (not SMULWW twice) per libopus comment —
    SMULWB bias can destabilize filters."""
    chirp_minus_one_q16 = chirp_q16 - 65536
    for i in range(d - 1):
        ar[i] = i16(rshift_round(chirp_q16 * ar[i], 16))
        chirp_q16 += rshift_round(chirp_q16 * chirp_minus_one_q16, 16)
    ar[d - 1] = i16(rshift_round(chirp_q16 * ar[d - 1], 16))


def silk_bwexpander_32(ar: list, d: int, chirp_q16: int) -> None:
    chirp_minus_one_q16 = chirp_q16 - 65536
    for i in range(d - 1):
        ar[i] = smulww(chirp_q16, ar[i])
        chirp_q16 += rshift_round(chirp_q16 * chirp_minus_one_q16, 16)
    ar[d - 1] = smulww(chirp_q16, ar[d - 1])
