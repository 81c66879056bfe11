"""CWRS: pulse-vector <-> codeword-index combinatorics for PVQ (RFC 6716 §4.3.4.2).

Behavioral parity with reference `src/celt/cwrs.rs` (itself celt/cwrs.c).
The enumeration is defined by the function U(n, k):

    U(n, 1) = 1,  U(n, 0) = 0,  U(1, k) = 1 (k>0),  U(2, k) = 2k - 1 (k>0)
    U(n, k) = U(n-1, k) + U(n-1, k-1) + U(n, k-1)

with V(n, k) = U(n, k) + U(n, k+1) the total number of n-dim vectors with
L1 norm exactly k. We use memoized Python bigints instead of the reference's
sliding u-rows: same mapping, simpler host code (this stage is moving to a
C++ extension later; the device never sees indices, only pulse vectors).
"""

from __future__ import annotations

from functools import lru_cache


@lru_cache(maxsize=None)
def pvq_u(n: int, k: int) -> int:
    if n < k:
        n, k = k, n  # U is symmetric
    if k == 0:
        return 0
    if n == 0:
        return 0 if k == 0 else 1
    if k == 1:
        return 1
    if n == 1:
        return 1
    if n == 2:
        return 2 * k - 1
    return pvq_u(n - 1, k) + pvq_u(n - 1, k - 1) + pvq_u(n, k - 1)


def pvq_v(n: int, k: int) -> int:
    """Number of n-dim integer vectors with L1 norm exactly k."""
    if k == 0:
        return 1
    return pvq_u(n, k) + pvq_u(n, k + 1)


def icwrs(y) -> tuple[int, int]:
    """Index of pulse vector y within the V(n, k) enumeration; returns (i, k)."""
    n = len(y)
    assert n >= 2
    j = n - 1
    i = 1 if y[j] < 0 else 0
    k = abs(y[j])
    while j > 0:
        j -= 1
        i += pvq_u(n - j, k)
        k += abs(y[j])
        if y[j] < 0:
            i += pvq_u(n - j, k + 1)
    return i, k


def cwrsi(n: int, k: int, i: int) -> list[int]:
    """Inverse of icwrs: the i-th n-dim pulse vector with L1 norm k."""
    assert n >= 2 and k > 0
    y = [0] * n
    for j in range(n - 1):
        m = n - j  # dims remaining including j
        # sign half: negative-sign codewords sit above U(m, k+1)
        p = pvq_u(m, k + 1)
        s = i >= p
        if s:
            i -= p
        # count pulses placed in this dimension: largest k' with U(m,k') <= i
        k0 = k
        p = pvq_u(m, k)
        while p > i:
            k -= 1
            p = pvq_u(m, k)
        i -= p
        q = k0 - k
        y[j] = -q if s else q
    # last dimension: i in {0, 1} selects the sign, magnitude is the leftover k
    y[n - 1] = -k if i else k
    return y


def encode_pulses(enc, y) -> None:
    i, k = icwrs(y)
    enc.enc_uint(i, pvq_v(len(y), k))


def decode_pulses(dec, n: int, k: int) -> list[int]:
    return cwrsi(n, k, dec.dec_uint(pvq_v(n, k)))


def ec_ilog(v: int) -> int:
    return v.bit_length()


def log2_frac(val: int, frac: int) -> int:
    """Conservative (>= exact) log2(val) with `frac` fractional bits."""
    l = ec_ilog(val)
    if val & (val - 1):
        if l > 16:
            val = ((val - 1) >> (l - 16)) + 1
        else:
            val <<= 16 - l
        acc = (l - 1) << frac
        cur = frac
        while True:
            b = val >> 16
            acc += b << cur
            val = (val + b) >> b
            val = ((val * val) + 0x7FFF) >> 15
            if cur <= 0:
                break
            cur -= 1
        return acc + (1 if val > 0x8000 else 0)
    return (l - 1) << frac


def get_required_bits(n: int, max_k: int, frac: int) -> list[int]:
    """bits[k] = log2_frac(V(n, k)) for k in 0..max_k (frac fractional bits)."""
    bits = [0] * (max_k + 1)
    if n == 1:
        for k in range(1, max_k + 1):
            bits[k] = 1 << frac
        return bits
    for k in range(1, max_k + 1):
        bits[k] = log2_frac(pvq_v(n, k), frac)
    return bits
