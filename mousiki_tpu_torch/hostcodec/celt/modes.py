"""CELT mode: the static 48 kHz / 960-sample configuration, built at import.

Instead of baking generated tables like reference `src/celt/
static_mode_48000_960.rs`, we construct the mode programmatically (the way
libopus's custom-mode constructor does) and cache it. All derived tables
(logN, pulse cache, caps, window) are computed from first principles; the
only raw constants are the normative band layout and the psychoacoustic
allocation matrix, which every interoperable Opus implementation shares.

Parity: reference `src/celt/modes.rs`, `rate.rs` (compute_pulse_cache).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

from .cwrs import get_required_bits, log2_frac

BITRES = 3
MAX_PSEUDO = 40
LOG_MAX_PSEUDO = 6
CELT_MAX_PULSES = 128
MAX_FINE_BITS = 8
FINE_OFFSET = 21
QTHETA_OFFSET = 4
QTHETA_OFFSET_TWOPHASE = 16

# Band edges in units of (fs/400)/2-sample bins (2.5 ms MDCT at LM=0), the
# universal 21-band Bark-derived layout every Opus stream uses at 48 kHz.
EBAND5MS = [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16,
            20, 24, 28, 34, 40, 48, 60, 78, 100]

# Psychoacoustic bit-allocation matrix: 11 quality rows x 21 bands, in
# 1/32 bit/sample units. Normative for interop (both sides must agree).
BAND_ALLOCATION = [
    [0] * 21,
    [90, 80, 75, 69, 63, 56, 49, 40, 34, 29, 20, 18, 10, 0, 0, 0, 0, 0, 0, 0, 0],
    [110, 100, 90, 84, 78, 71, 65, 58, 51, 45, 39, 32, 26, 20, 12, 0, 0, 0, 0, 0, 0],
    [118, 110, 103, 93, 86, 80, 75, 70, 65, 59, 53, 47, 40, 31, 23, 15, 4, 0, 0, 0, 0],
    [126, 119, 112, 104, 95, 89, 83, 78, 72, 66, 60, 54, 47, 39, 32, 25, 17, 12, 1, 0, 0],
    [134, 127, 120, 114, 103, 97, 91, 85, 78, 72, 66, 60, 54, 47, 41, 35, 29, 23, 16, 10, 1],
    [144, 137, 130, 124, 113, 107, 101, 95, 88, 82, 76, 70, 64, 57, 51, 45, 39, 33, 26, 15, 1],
    [152, 145, 138, 132, 123, 117, 111, 105, 98, 92, 86, 80, 74, 67, 61, 55, 49, 43, 36, 20, 1],
    [162, 155, 148, 142, 133, 127, 121, 115, 108, 102, 96, 90, 84, 77, 71, 65, 59, 53, 46, 30, 1],
    [172, 165, 158, 152, 143, 137, 131, 125, 118, 112, 106, 100, 94, 87, 81, 75, 69, 63, 56, 45, 20],
    [200, 200, 200, 200, 200, 200, 200, 200, 198, 193, 188, 183, 178, 173, 168, 163, 158, 153, 148, 129, 104],
]


def get_pulses(i: int) -> int:
    """Pseudo-pulse index -> pulse count (1:1 below 8, then doubling octaves)."""
    return i if i < 8 else (8 + (i & 7)) << ((i >> 3) - 1)


def fits_in32(n: int, k: int) -> bool:
    """Whether V(n, k) fits in an unsigned 32-bit integer."""
    max_n = [32767, 32767, 32767, 1476, 283, 109, 60, 40, 29, 24, 20, 18, 16, 14, 13]
    max_k = [32767, 32767, 32767, 32767, 1172, 238, 95, 53, 36, 27, 22, 18, 16, 15, 13]
    if n >= 14:
        return False if k >= 14 else n <= max_n[k]
    return k <= max_k[n]


@dataclass(frozen=True)
class PulseCache:
    index: np.ndarray  # (maxLM+2) * nbEBands, int16, -1 = band vanishes
    bits: np.ndarray   # uint8 table rows: [K, bits(1 pulse)-1, ...]
    caps: np.ndarray   # (maxLM+1) * 2 * nbEBands, uint8


@dataclass(frozen=True)
class CeltMode:
    fs: int
    overlap: int
    num_ebands: int
    effective_ebands: int
    preemph: tuple
    ebands: np.ndarray          # int16, len num_ebands+1 (units: shortMdctSize/2.5ms bins)
    max_lm: int
    num_short_mdcts: int
    short_mdct_size: int
    log_n: np.ndarray           # int16, log2 band width in 1/8 bits at LM=0
    window: np.ndarray          # float32, len overlap
    alloc_vectors: np.ndarray   # uint8 (nbAllocVectors, num_ebands)
    cache: PulseCache

    @property
    def num_alloc_vectors(self) -> int:
        return self.alloc_vectors.shape[0]

    def frame_size(self, lm: int) -> int:
        return self.short_mdct_size << lm


def compute_pulse_cache(ebands, log_n, max_lm: int) -> PulseCache:
    """Build the PVQ bits cache + per-band bit caps (parity: rate.rs:330)."""
    nb = len(ebands) - 1
    index = np.full(nb * (max_lm + 2), -1, np.int32)
    entries = []  # (n, K, offset)
    curr = 0
    for i in range(max_lm + 2):
        for j in range(nb):
            n = int(ebands[j + 1] - ebands[j])
            n = (n << i) >> 1
            row = i * nb + j
            # Reuse an existing table for any earlier band with the same width
            found = False
            for k in range(i + 1):
                for n_idx in range(nb):
                    if k == i and n_idx >= j:
                        break
                    other = (int(ebands[n_idx + 1] - ebands[n_idx]) << k) >> 1
                    if n == other:
                        index[row] = index[k * nb + n_idx]
                        found = True
                        break
                if found:
                    break
            if index[row] == -1 and n != 0:
                k = 0
                while k < MAX_PSEUDO and fits_in32(n, get_pulses(k + 1)):
                    k += 1
                entries.append((n, k, curr))
                index[row] = curr
                curr += k + 1

    bits = np.zeros(curr, np.uint8)
    for n, k, offset in entries:
        required = get_required_bits(n, get_pulses(k), BITRES)
        bits[offset] = k
        for j in range(1, k + 1):
            bits[offset + j] = required[get_pulses(j)] - 1

    caps = np.zeros((max_lm + 1) * 2 * nb, np.uint8)
    for i in range(max_lm + 1):
        for c in (1, 2):
            for j in range(nb):
                band_width = int(ebands[j + 1] - ebands[j])
                n0 = band_width
                if (n0 << i) == 1:
                    max_bits = (c * (1 + MAX_FINE_BITS)) << BITRES
                else:
                    lm0 = 0
                    if n0 > 2:
                        n0 >>= 1
                        lm0 = -1
                    elif n0 <= 1:
                        lm0 = min(i, 1)
                        n0 <<= lm0
                    row = (lm0 + 1) * nb + j
                    cache_offset = int(index[row])
                    entry_k = int(bits[cache_offset])
                    max_bits = int(bits[cache_offset + entry_k]) + 1
                    # account for theta splitting up to the target LM
                    n = n0
                    for k_iter in range(i - lm0):
                        max_bits <<= 1
                        offset = ((int(log_n[j]) + ((lm0 + k_iter) << BITRES)) >> 1) - QTHETA_OFFSET
                        num = 459 * ((2 * n - 1) * offset + max_bits)
                        den = ((2 * n - 1) << 9) - 459
                        qb = (num + (den >> 1)) // den
                        qb = min(qb, 57)
                        max_bits += qb
                        n <<= 1
                    if c == 2:
                        max_bits <<= 1
                        offset = ((int(log_n[j]) + (i << BITRES)) >> 1) - (
                            QTHETA_OFFSET_TWOPHASE if n == 2 else QTHETA_OFFSET)
                        ndof = 2 * n - 1 - (1 if n == 2 else 0)
                        scale, qb_cap = (512, 64) if n == 2 else (487, 61)
                        num = scale * (max_bits + ndof * offset)
                        den = (ndof << 9) - scale
                        qb = min((num + (den >> 1)) // den, qb_cap)
                        max_bits += qb
                    ndof = c * n + (1 if c == 2 and n > 2 else 0)
                    offset = ((int(log_n[j]) + (i << BITRES)) >> 1) - FINE_OFFSET
                    if n == 2:
                        offset += (1 << BITRES) >> 2
                    num = max_bits + ndof * offset
                    den = (ndof - 1) << BITRES
                    qb = min((num + (den >> 1)) // den, MAX_FINE_BITS)
                    max_bits += (c * qb) << BITRES
                max_bits = (4 * max_bits // (c * (band_width << i))) - 64
                assert 0 <= max_bits < 256
                caps[i * 2 * nb + (c - 1) * nb + j] = max_bits
    return PulseCache(index=index.astype(np.int16), bits=bits, caps=caps)


# --------------------------------------------------------------- custom modes
# Bark critical-band edges used to derive band layouts for non-48k custom
# modes (normative: every interoperable custom-mode implementation derives
# the identical layout from them; reference modes.rs:53 / celt/modes.c).
BARK_FREQ = [0, 100, 200, 300, 400, 510, 630, 770, 920, 1080, 1270, 1480,
             1720, 2000, 2320, 2700, 3150, 3700, 4400, 5300, 6400, 7700,
             9500, 12000, 15500, 20000]
BARK_BANDS = 25


def _tdiv(a: int, b: int) -> int:
    """C-style integer division (truncate toward zero)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def compute_ebands(fs: int, short_mdct: int, resolution: int) -> np.ndarray:
    """Band-edge layout for a custom mode (parity: modes.rs compute_ebands).

    Returns int16 edges (num_bands+1) in short-MDCT bins. 400*short == fs
    short-circuits to the canonical EBAND5MS layout."""
    if fs == 400 * short_mdct:
        return np.array(EBAND5MS, np.int16)
    n_bark = 1
    while n_bark < BARK_BANDS and BARK_FREQ[n_bark + 1] * 2 < fs:
        n_bark += 1
    lin = 0
    while lin < n_bark and BARK_FREQ[lin + 1] - BARK_FREQ[lin] < resolution:
        lin += 1
    low = _tdiv(BARK_FREQ[lin] + resolution // 2, resolution)
    high = n_bark - lin
    num_bands = low + high
    bands = [0] * (num_bands + 2)
    for i in range(low):
        bands[i] = i
    offset = 0
    if low > 0:
        offset = bands[low - 1] * resolution - BARK_FREQ[max(lin - 1, 0)]
    for i in range(high):
        target = BARK_FREQ[lin + i]
        value = _tdiv(target + _tdiv(offset, 2) + resolution,
                      2 * resolution) * 2
        bands[low + i] = value
        offset = value * resolution - target
    for i in range(num_bands):
        bands[i] = max(bands[i], i)
    bands[num_bands] = min(_tdiv(BARK_FREQ[n_bark] + resolution,
                                 2 * resolution) * 2, short_mdct)
    if num_bands > 1:
        for i in range(1, num_bands - 1):
            if bands[i + 1] - bands[i] < bands[i] - bands[i - 1]:
                bands[i] -= _tdiv(2 * bands[i] - bands[i - 1] - bands[i + 1],
                                  2)
    j = 0
    for i in range(num_bands):
        if bands[i + 1] > bands[j]:
            j += 1
            bands[j] = bands[i + 1]
    return np.array(bands[:j + 1], np.int16)


def compute_allocation_table(fs: int, short_mdct: int,
                             ebands: np.ndarray) -> np.ndarray:
    """Interpolate the canonical 5 ms allocation curves onto a custom band
    layout (parity: modes.rs compute_allocation_table)."""
    nb = len(ebands) - 1
    if fs == 400 * short_mdct:
        flat = np.array(BAND_ALLOCATION, np.uint8).reshape(-1)
        return flat[:11 * nb].reshape(11, nb)
    max_bands = len(EBAND5MS) - 1
    flat_ref = np.array(BAND_ALLOCATION, np.int64).reshape(11, max_bands)
    out = np.zeros((11, nb), np.uint8)
    for v in range(11):
        for band in range(nb):
            target = int(ebands[band]) * fs // short_mdct
            k = 0
            while k < max_bands and 400 * EBAND5MS[k] <= target:
                k += 1
            if k >= max_bands:
                out[v, band] = flat_ref[v, max_bands - 1]
            else:
                upper = max(k, 1)
                a1 = target - 400 * EBAND5MS[upper - 1]
                a0 = 400 * EBAND5MS[upper] - target
                num = (a0 * flat_ref[v, upper - 1] + a1 * flat_ref[v, upper])
                out[v, band] = num // (a0 + a1)
    return out


def compute_preemphasis(fs: int) -> tuple:
    """Rate-dependent pre-emphasis response (parity: modes.rs
    compute_preemphasis / celt/modes.c opus_custom_mode_create)."""
    if fs < 12000:
        return (0.3500061035, -0.1799926758, 0.2719968125, 3.6765136719)
    if fs < 24000:
        return (0.6000061035, -0.1799926758, 0.4424998650, 2.2598876953)
    if fs < 40000:
        return (0.7799987793, -0.1000061035, 0.7499771125, 1.3333740234)
    return (0.85, 0.0, 1.0, 1.0)


def _mdct_window(overlap: int) -> np.ndarray:
    i = np.arange(overlap, dtype=np.float64)
    inner = np.sin(0.5 * math.pi * (i + 0.5) / overlap)
    return np.sin(0.5 * math.pi * inner * inner).astype(np.float32)


@lru_cache(maxsize=16)
def opus_custom_mode(fs: int = 48000, frame_size: int = 960) -> CeltMode:
    """Build a CELT mode: the canonical 48 kHz family or a custom mode for
    any 8-96 kHz rate and 40-1024 even frame size (parity: modes.rs
    build_custom_mode / celt/modes.c opus_custom_mode_create)."""
    if not 8000 <= fs <= 96000:
        raise ValueError("bad sample rate for a custom mode")
    if not 40 <= frame_size <= 1024 or frame_size % 2:
        raise ValueError("bad frame size for a custom mode")
    if frame_size * 1000 < fs:
        raise ValueError("frame shorter than 1 ms")
    if frame_size * 75 >= fs and frame_size % 16 == 0:
        max_lm = 3
    elif frame_size * 150 >= fs and frame_size % 8 == 0:
        max_lm = 2
    elif frame_size * 300 >= fs and frame_size % 4 == 0:
        max_lm = 1
    else:
        max_lm = 0
    short_mdct = frame_size >> max_lm
    if short_mdct * 300 > fs:
        raise ValueError("short blocks longer than 3.3 ms")
    overlap = (short_mdct >> 2) << 2
    resolution = (fs + short_mdct) // (2 * short_mdct)
    ebands = compute_ebands(fs, short_mdct, resolution)
    nb = len(ebands) - 1
    if nb < 1:
        raise ValueError("degenerate band layout")
    if (int(ebands[nb]) - int(ebands[nb - 1])) << max_lm > 208:
        raise ValueError("last band too wide")
    eff = nb
    while eff > 0 and int(ebands[eff]) > short_mdct:
        eff -= 1
    log_n = np.array(
        [log2_frac(int(ebands[i + 1] - ebands[i]), BITRES) for i in range(nb)],
        np.int16,
    )
    cache = compute_pulse_cache(ebands, log_n, max_lm)
    return CeltMode(
        fs=fs,
        overlap=overlap,
        num_ebands=nb,
        effective_ebands=eff,
        preemph=compute_preemphasis(fs),
        ebands=ebands,
        max_lm=max_lm,
        num_short_mdcts=1 << max_lm,
        short_mdct_size=short_mdct,
        log_n=log_n,
        window=_mdct_window(overlap),
        alloc_vectors=compute_allocation_table(fs, short_mdct, ebands),
        cache=cache,
    )


def bits2pulses(mode: CeltMode, band: int, lm: int, bits: int) -> int:
    """Bit budget -> pseudo-pulse index via binary search of the cache row."""
    if bits <= 0:
        return 0
    cache_index = int(mode.cache.index[(lm + 1) * mode.num_ebands + band])
    if cache_index < 0:
        return 0
    table = mode.cache.bits[cache_index:]
    lo = 0
    hi = int(table[0])
    bits -= 1
    for _ in range(LOG_MAX_PSEUDO):
        mid = (lo + hi + 1) >> 1
        if int(table[mid]) >= bits:
            hi = mid
        else:
            lo = mid
    lo_val = -1 if lo == 0 else int(table[lo])
    if bits - lo_val <= int(table[hi]) - bits:
        return lo
    return hi


def pulses2bits(mode: CeltMode, band: int, lm: int, pulses: int) -> int:
    if pulses == 0:
        return 0
    cache_index = int(mode.cache.index[(lm + 1) * mode.num_ebands + band])
    if cache_index < 0:
        return 0
    return int(mode.cache.bits[cache_index + pulses]) + 1
