"""Float band helpers shared by the CELT encoder (bands.rs float parity)."""

from __future__ import annotations

import numpy as np

from .quant_bands import E_MEANS


def compute_band_energies(mode, freq, eff_end, M, C):
    """bandE[c, i] = sqrt(1e-27 + sum freq^2) per band."""
    eb = mode.ebands
    band_e = np.zeros((2, mode.num_ebands), np.float64)
    for c in range(C):
        for i in range(eff_end):
            seg = freq[c, M * int(eb[i]): M * int(eb[i + 1])]
            band_e[c, i] = math_sqrt(1e-27 + float(seg @ seg))
    return band_e


def math_sqrt(x):
    return x ** 0.5


def amp2_log2(mode, band_e, eff_end, end, C):
    band_log_e = np.zeros((2, mode.num_ebands), np.float64)
    for c in range(C):
        for i in range(eff_end):
            band_log_e[c, i] = np.log2(band_e[c, i]) - E_MEANS[i]
        band_log_e[c, eff_end:end] = -14.0
    return band_log_e


def normalise_bands(mode, freq, band_e, eff_end, M, C):
    eb = mode.ebands
    X = np.zeros_like(freq)
    for c in range(C):
        for i in range(eff_end):
            j0, j1 = M * int(eb[i]), M * int(eb[i + 1])
            X[c, j0:j1] = freq[c, j0:j1] / (1e-27 + band_e[c, i])
    return X
