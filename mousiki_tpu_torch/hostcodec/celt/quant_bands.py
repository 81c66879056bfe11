"""CELT band-energy coding: coarse (Laplace, 2-D prediction), fine, finalise.

Decode side of reference `src/celt/quant_bands.rs` (unquant_coarse_energy:902,
unquant_fine_energy:1850, unquant_energy_finalise:1922); float semantics
follow libopus exactly (prediction feedback `prev += q - beta*tmp`).
Energies are log2 of band amplitude ("DB" = 6.02dB units).
"""

from __future__ import annotations

import numpy as np

from ..bitstream.entcode import RangeDecoder, RangeEncoder
from ..bitstream.laplace import laplace_decode, laplace_encode
from .modes import CeltMode, MAX_FINE_BITS

# Mean log-energy per band, subtracted before coding (libopus eMeans)
E_MEANS = np.array([
    6.4375, 6.25, 5.75, 5.3125, 5.0625, 4.8125, 4.5, 4.375, 4.875, 4.6875,
    4.5625, 4.4375, 4.875, 4.625, 4.3125, 4.5, 4.375, 4.625, 4.75, 4.4375,
    3.75, 3.75, 3.75, 3.75, 3.75,
], np.float32)

# Inter-frame prediction coefficient and feedback beta, per LM (Q15-derived)
PRED_COEF = [29440 / 32768.0, 26112 / 32768.0, 21248 / 32768.0, 16384 / 32768.0]
BETA_COEF = [30147 / 32768.0, 22282 / 32768.0, 12124 / 32768.0, 6554 / 32768.0]
BETA_INTRA = 4915 / 32768.0

SMALL_ENERGY_ICDF = [2, 1, 0]

# Laplace probability model [LM][intra][2*band]: (fs>>7, decay>>6) pairs
E_PROB_MODEL = [
    [  # 120-sample frames
        [72, 127, 65, 129, 66, 128, 65, 128, 64, 128, 62, 128, 64, 128,
         64, 128, 92, 78, 92, 79, 92, 78, 90, 79, 116, 41, 115, 40,
         114, 40, 132, 26, 132, 26, 145, 17, 161, 12, 176, 10, 177, 11],
        [24, 179, 48, 138, 54, 135, 54, 132, 53, 134, 56, 133, 55, 132,
         55, 132, 61, 114, 70, 96, 74, 88, 75, 88, 87, 74, 89, 66,
         91, 67, 100, 59, 108, 50, 120, 40, 122, 37, 97, 43, 78, 50],
    ],
    [  # 240
        [83, 78, 84, 81, 88, 75, 86, 74, 87, 71, 90, 73, 93, 74,
         93, 74, 109, 40, 114, 36, 117, 34, 117, 34, 143, 17, 145, 18,
         146, 19, 162, 12, 165, 10, 178, 7, 189, 6, 190, 8, 177, 9],
        [23, 178, 54, 115, 63, 102, 66, 98, 69, 99, 74, 89, 71, 91,
         73, 91, 78, 89, 86, 80, 92, 66, 93, 64, 102, 59, 103, 60,
         104, 60, 117, 52, 123, 44, 138, 35, 133, 31, 97, 38, 77, 45],
    ],
    [  # 480
        [61, 90, 93, 60, 105, 42, 107, 41, 110, 45, 116, 38, 113, 38,
         112, 38, 124, 26, 132, 27, 136, 19, 140, 20, 155, 14, 159, 16,
         158, 18, 170, 13, 177, 10, 187, 8, 192, 6, 175, 9, 159, 10],
        [21, 178, 59, 110, 71, 86, 75, 85, 84, 83, 91, 66, 88, 73,
         87, 72, 92, 75, 98, 72, 105, 58, 107, 54, 115, 52, 114, 55,
         112, 56, 129, 51, 132, 40, 150, 33, 140, 29, 98, 35, 77, 42],
    ],
    [  # 960
        [42, 121, 96, 66, 108, 43, 111, 40, 117, 44, 123, 32, 120, 36,
         119, 33, 127, 33, 134, 34, 139, 21, 147, 23, 152, 20, 158, 25,
         154, 26, 166, 21, 173, 16, 184, 13, 184, 10, 150, 13, 139, 15],
        [22, 178, 63, 114, 74, 82, 84, 83, 92, 82, 103, 62, 96, 72,
         96, 67, 101, 73, 107, 72, 113, 55, 118, 52, 125, 52, 118, 52,
         117, 55, 135, 49, 137, 39, 157, 32, 145, 29, 97, 33, 77, 40],
    ],
]


def unquant_coarse_energy(mode: CeltMode, start: int, end: int,
                          old_ebands: np.ndarray, intra: bool,
                          dec: RangeDecoder, C: int, LM: int) -> None:
    """Decode coarse energies in place; old_ebands shape (C, nbEBands)."""
    prob_model = E_PROB_MODEL[LM][1 if intra else 0]
    prev = [0.0] * C
    coef = 0.0 if intra else PRED_COEF[LM]
    beta = BETA_INTRA if intra else BETA_COEF[LM]
    budget = dec.storage * 8

    for i in range(start, end):
        for c in range(C):
            tell = dec.tell()
            if budget - tell >= 15:
                pi = 2 * min(i, 20)
                qi = laplace_decode(dec, prob_model[pi] << 7, prob_model[pi + 1] << 6)
            elif budget - tell >= 2:
                qi = dec.dec_icdf(SMALL_ENERGY_ICDF, 2)
                qi = (qi >> 1) ^ -(qi & 1)
            elif budget - tell >= 1:
                qi = -dec.dec_bit_logp(1)
            else:
                qi = -1
            q = float(qi)
            old = max(float(old_ebands[c, i]), -9.0)
            tmp = coef * old + prev[c] + q
            old_ebands[c, i] = tmp
            # NB: beta multiplies q, not tmp (verified empirically against
            # libopus 1.3.1 output; reference quant_bands.rs:947 agrees)
            prev[c] = prev[c] + q - beta * q


def unquant_fine_energy(mode: CeltMode, start: int, end: int,
                        old_ebands: np.ndarray, fine_quant,
                        dec: RangeDecoder, C: int) -> None:
    for i in range(start, end):
        if fine_quant[i] <= 0:
            continue
        scale = 2.0 ** -fine_quant[i]
        for c in range(C):
            q2 = dec.dec_bits(fine_quant[i])
            old_ebands[c, i] += (q2 + 0.5) * scale - 0.5


def unquant_energy_finalise(mode: CeltMode, start: int, end: int,
                            old_ebands: np.ndarray, fine_quant, fine_priority,
                            bits_left: int, dec: RangeDecoder, C: int) -> None:
    for prio in range(2):
        for i in range(start, end):
            if bits_left < C:
                break
            if fine_quant[i] >= MAX_FINE_BITS or fine_priority[i] != prio:
                continue
            scale = 2.0 ** -(fine_quant[i] + 1)
            for c in range(C):
                q2 = dec.dec_bits(1)
                old_ebands[c, i] += (q2 - 0.5) * scale
                bits_left -= 1
