"""Laplace-distributed symbol coding (CELT coarse-energy residuals).

Behavioral parity: reference `src/celt/laplace.rs`; normative per RFC 6716.
The distribution is a two-sided geometric with per-band decay; values past
the modeled range fall into minimum-probability buckets.
"""

from __future__ import annotations

from .entcode import RangeDecoder, RangeEncoder

LAPLACE_LOG_MINP = 0
LAPLACE_MINP = 1 << LAPLACE_LOG_MINP
LAPLACE_NMIN = 16


def _freq1(fs0: int, decay: int) -> int:
    ft = 32768 - LAPLACE_MINP * (2 * LAPLACE_NMIN) - fs0
    return (ft * (16384 - decay)) >> 15


def laplace_encode(enc: RangeEncoder, value: int, fs: int, decay: int) -> int:
    """Encode `value`; returns the (possibly saturated) value actually coded."""
    val = value
    fl = 0
    if val:
        s = -1 if val < 0 else 0
        val = (val + s) ^ s
        fl = fs
        fs = _freq1(fs, decay)
        i = 1
        while fs > 0 and i < val:
            fs *= 2
            fl += fs + 2 * LAPLACE_MINP
            fs = (fs * decay) >> 15
            i += 1
        if fs == 0:
            ndi_max = (32768 - fl + LAPLACE_MINP - 1) >> LAPLACE_LOG_MINP
            ndi_max = (ndi_max - s) >> 1
            di = min(val - i, ndi_max - 1)
            fl += (2 * di + 1 + s) * LAPLACE_MINP
            fs = min(LAPLACE_MINP, 32768 - fl)
            value = (i + di + s) ^ s
        else:
            fs += LAPLACE_MINP
            if s == 0:
                fl += fs
    assert fl + fs <= 32768
    assert fs > 0
    enc.encode_bin(fl, fl + fs, 15)
    return value


def laplace_decode(dec: RangeDecoder, fs: int, decay: int) -> int:
    val = 0
    fl = 0
    fm = dec.decode_bin(15)
    if fm >= fs:
        val += 1
        fl = fs
        fs = _freq1(fs, decay) + LAPLACE_MINP
        while fs > LAPLACE_MINP and fm >= fl + 2 * fs:
            fs *= 2
            fl += fs
            fs = ((fs - 2 * LAPLACE_MINP) * decay) >> 15
            fs += LAPLACE_MINP
            val += 1
        if fs <= LAPLACE_MINP:
            di = (fm - fl) >> (LAPLACE_LOG_MINP + 1)
            val += di
            fl += 2 * di * LAPLACE_MINP
        if fm < fl + fs:
            val = -val
        else:
            fl += fs
    dec.update(fl, min(fl + fs, 32768), 32768)
    return val
