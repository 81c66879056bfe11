"""CELT bit allocation: interpolated allocation curve -> per-band PVQ/fine bits.

Shared, deterministic between encoder and decoder (both run the identical
computation so no allocation info is transmitted beyond trim/dynalloc/skip).
Parity: reference `src/celt/rate.rs` (interp_bits2pulses:505,
clt_compute_allocation:1072); normative per RFC 6716 §4.3.3.
"""

from __future__ import annotations

from dataclasses import dataclass

from .modes import BITRES, CeltMode, FINE_OFFSET, MAX_FINE_BITS

ALLOC_STEPS = 6

LOG2_FRAC_TABLE = [
    0, 8, 13, 16, 19, 21, 23, 24, 26, 27, 28, 29, 30, 31, 32, 32,
    33, 34, 34, 35, 36, 36, 37, 37,
]


@dataclass
class Allocation:
    pulses: list        # per-band PVQ bit budget (1/8 bit units)
    ebits: list         # per-band fine-energy bits
    fine_priority: list
    coded_bands: int
    balance: int
    intensity: int
    dual_stereo: int


def _interp_bits2pulses(mode: CeltMode, start, end, skip_start, bits1, bits2,
                        thresh, cap, total, skip_rsv, intensity, intensity_rsv,
                        dual_stereo, dual_stereo_rsv, bits, ebits,
                        fine_priority, C, LM, ec, is_encoder,
                        prev, signal_bandwidth):
    eb = mode.ebands
    alloc_floor = C << BITRES
    stereo = 1 if C > 1 else 0
    log_m = LM << BITRES

    lo, hi = 0, 1 << ALLOC_STEPS
    for _ in range(ALLOC_STEPS):
        mid = (lo + hi) >> 1
        psum, done = 0, False
        for j in range(end - 1, start - 1, -1):
            tmp = bits1[j] + ((mid * bits2[j]) >> ALLOC_STEPS)
            if tmp >= thresh[j] or done:
                done = True
                psum += min(tmp, cap[j])
            elif tmp >= alloc_floor:
                psum += alloc_floor
        if psum > total:
            hi = mid
        else:
            lo = mid

    psum, done = 0, False
    for j in range(end - 1, start - 1, -1):
        tmp = bits1[j] + ((lo * bits2[j]) >> ALLOC_STEPS)
        if tmp < thresh[j] and not done:
            tmp = alloc_floor if tmp >= alloc_floor else 0
        else:
            done = True
        tmp = min(tmp, cap[j])
        bits[j] = tmp
        psum += tmp

    # Band-skip decisions, high band first
    coded_bands = end
    while coded_bands > start:
        j = coded_bands - 1
        if j <= skip_start:
            total += skip_rsv
            break
        band_width = int(eb[coded_bands]) - int(eb[j])
        # celt_udiv is an *unsigned* divide: when psum transiently exceeds
        # total, C wraps left to a huge uint32; emulate exactly (matters for
        # skip decisions in tight frames).
        left = (total - psum) & 0xFFFFFFFF
        denom = int(eb[coded_bands]) - int(eb[start])
        per_coeff = left // denom
        left -= denom * per_coeff
        rem = max(left - (int(eb[j]) - int(eb[start])), 0)
        band_bits = bits[j] + per_coeff * band_width + rem
        band_bits = ((band_bits & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
        if band_bits >= max(thresh[j], alloc_floor + (1 << BITRES)):
            if is_encoder:
                if coded_bands <= start + 2:
                    decision = True
                else:
                    depth_threshold = (7 if j < prev else 9) if coded_bands > 17 else 0
                    decision = (
                        band_bits > ((depth_threshold * band_width) << (LM + BITRES)) >> 4
                        and j <= signal_bandwidth
                    )
                ec.enc_bit_logp(1 if decision else 0, 1)
                if decision:
                    break
            else:
                if ec.dec_bit_logp(1):
                    break
            psum += 1 << BITRES
            band_bits -= 1 << BITRES
        psum -= bits[j] + intensity_rsv
        if intensity_rsv > 0:
            intensity_rsv = LOG2_FRAC_TABLE[j - start]
        psum += intensity_rsv
        if band_bits >= alloc_floor:
            psum += alloc_floor
            bits[j] = alloc_floor
        else:
            bits[j] = 0
        coded_bands -= 1

    assert coded_bands > start

    if intensity_rsv > 0:
        if is_encoder:
            intensity = min(intensity, coded_bands)
            ec.enc_uint(intensity - start, coded_bands + 1 - start)
        else:
            intensity = start + ec.dec_uint(coded_bands + 1 - start)
    else:
        intensity = 0

    if intensity <= start:
        total += dual_stereo_rsv
        dual_stereo_rsv = 0
    if dual_stereo_rsv > 0:
        if is_encoder:
            ec.enc_bit_logp(dual_stereo, 1)
        else:
            dual_stereo = ec.dec_bit_logp(1)
    else:
        dual_stereo = 0

    # Distribute remaining bits over coded bands proportionally to width
    denom = max(int(eb[coded_bands]) - int(eb[start]), 1)
    left = (total - psum) & 0xFFFFFFFF
    per_coeff = left // denom
    left -= denom * per_coeff
    for j in range(start, coded_bands):
        bits[j] += per_coeff * (int(eb[j + 1]) - int(eb[j]))
    for j in range(start, coded_bands):
        add = min(int(eb[j + 1]) - int(eb[j]), left)
        bits[j] += add
        left -= add

    # Split each band's budget into fine-energy bits and PVQ bits
    balance = 0
    for j in range(start, coded_bands):
        n0 = int(eb[j + 1]) - int(eb[j])
        n = n0 << LM
        bit = bits[j] + balance
        if n > 1:
            excess = max(bit - cap[j], 0)
            bits[j] = bit - excess
            den = C * n
            if C == 2 and n > 2 and dual_stereo == 0 and j < intensity:
                den += 1
            nclogn = den * (int(mode.log_n[j]) + log_m)
            offset = (nclogn >> 1) - den * FINE_OFFSET
            if n == 2:
                offset += den << (BITRES - 2)
            if bits[j] + offset < (den * 2) << BITRES:
                offset += nclogn >> 2
            elif bits[j] + offset < (den * 3) << BITRES:
                offset += nclogn >> 3
            ebv = max(0, bits[j] + offset + (den << (BITRES - 1)))
            ebv = (ebv // den) >> BITRES
            if C * ebv > (bits[j] >> BITRES):
                ebv = bits[j] >> stereo >> BITRES
            ebv = min(ebv, MAX_FINE_BITS)
            fine_priority[j] = 1 if ebv * (den << BITRES) >= bits[j] + offset else 0
            bits[j] -= (C * ebv) << BITRES
            ebits[j] = ebv
        else:
            excess = max(0, bit - (C << BITRES))
            bits[j] = bit - excess
            ebits[j] = 0
            fine_priority[j] = 1
        # Re-balancing of unusable excess into fine energy (applies to the
        # N==1 path as well — C has this outside the if/else)
        if excess > 0:
            extra_fine = min(excess >> (stereo + BITRES), MAX_FINE_BITS - ebits[j])
            ebits[j] += extra_fine
            extra_bits = (extra_fine * C) << BITRES
            fine_priority[j] = 1 if extra_bits >= excess - balance else 0
            excess -= extra_bits
        balance = excess
        assert bits[j] >= 0 and ebits[j] >= 0

    # Skipped bands: all remaining budget becomes fine energy
    for j in range(coded_bands, end):
        ebits[j] = bits[j] >> stereo >> BITRES
        assert (C * ebits[j]) << BITRES == bits[j]
        bits[j] = 0
        fine_priority[j] = 1 if ebits[j] < 1 else 0

    return coded_bands, balance, intensity, dual_stereo


def clt_compute_allocation(mode: CeltMode, start, end, offsets, cap, alloc_trim,
                           intensity, dual_stereo, total, C, LM, ec, is_encoder,
                           prev=0, signal_bandwidth=0) -> Allocation:
    eb = mode.ebands
    nb = mode.num_ebands
    total = max(total, 0)
    skip_start = start

    skip_rsv = 0
    if total >= 1 << BITRES:
        skip_rsv = 1 << BITRES
        total -= skip_rsv

    intensity_rsv = dual_stereo_rsv = 0
    if C == 2:
        cand = LOG2_FRAC_TABLE[end - start]
        if cand <= total:
            intensity_rsv = cand
            total -= cand
            if total >= 1 << BITRES:
                dual_stereo_rsv = 1 << BITRES
                total -= dual_stereo_rsv

    thresh = [0] * nb
    trim_offset = [0] * nb
    for j in range(start, end):
        n = int(eb[j + 1]) - int(eb[j])
        thresh[j] = max(C << BITRES, (3 * n) << (LM + BITRES) >> 4)
        trim_offset[j] = (C * n * (alloc_trim - 5 - LM) * (end - j - 1)
                          * (1 << (LM + BITRES))) >> 6
        if (n << LM) == 1:
            trim_offset[j] -= C << BITRES

    # Find the highest allocation curve the budget can afford
    lo, hi = 1, mode.num_alloc_vectors - 1
    while lo <= hi:
        mid = (lo + hi) >> 1
        psum, done = 0, False
        for j in range(end - 1, start - 1, -1):
            n = int(eb[j + 1]) - int(eb[j])
            bitsj = (C * n * int(mode.alloc_vectors[mid][j])) << LM >> 2
            if bitsj > 0:
                bitsj = max(0, bitsj + trim_offset[j])
            bitsj += offsets[j]
            if bitsj >= thresh[j] or done:
                done = True
                psum += min(bitsj, cap[j])
            elif bitsj >= C << BITRES:
                psum += C << BITRES
        if psum > total:
            hi = mid - 1
        else:
            lo = mid + 1
    hi = lo
    lo -= 1

    bits1 = [0] * nb
    bits2 = [0] * nb
    for j in range(start, end):
        n = int(eb[j + 1]) - int(eb[j])
        b1 = (C * n * int(mode.alloc_vectors[lo][j])) << LM >> 2
        b2 = cap[j] if hi >= mode.num_alloc_vectors else (
            (C * n * int(mode.alloc_vectors[hi][j])) << LM >> 2)
        if b1 > 0:
            b1 = max(0, b1 + trim_offset[j])
        if b2 > 0:
            b2 = max(0, b2 + trim_offset[j])
        if lo > 0:
            b1 += offsets[j]
        b2 += offsets[j]
        if offsets[j] > 0:
            skip_start = j
        bits1[j] = b1
        bits2[j] = max(0, b2 - b1)

    pulses = [0] * nb
    ebits = [0] * nb
    fine_priority = [0] * nb
    coded_bands, balance, intensity, dual_stereo = _interp_bits2pulses(
        mode, start, end, skip_start, bits1, bits2, thresh, cap, total,
        skip_rsv, intensity, intensity_rsv, dual_stereo, dual_stereo_rsv,
        pulses, ebits, fine_priority, C, LM, ec, is_encoder,
        prev, signal_bandwidth)
    return Allocation(pulses=pulses, ebits=ebits, fine_priority=fine_priority,
                      coded_bands=coded_bands, balance=balance,
                      intensity=intensity, dual_stereo=dual_stereo)
