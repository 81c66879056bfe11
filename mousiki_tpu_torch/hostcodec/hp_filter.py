"""Encoder input high-pass filtering.

Parity: reference `src/opus_encoder.rs` hp_cutoff/dc_reject/
update_high_pass_state (:2080-2530) and `src/silk/hp_variable_cutoff.rs`.
VOIP applications run a variable-cutoff (60-100 Hz) second-order high-pass
whose corner tracks the voiced pitch frequency via two fixed-point
log-domain smoothers; other applications run a 3 Hz DC rejection filter.
Both are cheap per-frame host-side IIRs on the raw input -- they stay out
of the batched device path by design.
"""

from __future__ import annotations

import math

import numpy as np

from .silk.fixed_math import (silk_lin2log, silk_log2lin, smlawb, smulbb,
                              smulwb, smulww)

VARIABLE_HP_MIN_CUTOFF_HZ = 60
VARIABLE_HP_MAX_CUTOFF_HZ = 100
VARIABLE_HP_SMTH_COEF1_Q16 = int(0.1 * (1 << 16) + 0.5)
VARIABLE_HP_SMTH_COEF2_Q16 = int(0.015 * (1 << 16) + 0.5)
VARIABLE_HP_MAX_DELTA_FREQ_Q7 = int(0.4 * (1 << 7) + 0.5)
HP_CUTOFF_COEF_Q19 = int(1.5 * math.pi / 1000.0 * (1 << 19) + 0.5)
HP_CUTOFF_R_COEF_Q9 = int(0.92 * (1 << 9) + 0.5)
VERY_SMALL = 1e-30


class HighPassState:
    """Per-encoder HP state: 4 filter memories + the two cutoff smoothers."""

    def __init__(self):
        self.mem = np.zeros(4, np.float64)
        init = silk_lin2log(VARIABLE_HP_MIN_CUTOFF_HZ) << 8
        self.smth1_q15 = init  # per-SILK-frame pitch tracker (smth coef 0.1)
        self.smth2_q15 = init  # per-packet follower (smth coef 0.015)

    # -- silk_HP_variable_cutoff ----------------------------------------
    def update_from_silk(self, prev_signal_type: int, prev_lag: int,
                         fs_khz: int, speech_activity_q8: int = 200,
                         quality_q15: int = 30000):
        """Track the voiced pitch frequency (hp_variable_cutoff.rs:32-72).

        speech_activity_q8/quality_q15 stand in for the reference VAD
        outputs (this encoder's VAD is simplified); defaults correspond to
        confidently-voiced speech, which is when the tracker matters.
        """
        if prev_signal_type != 2 or prev_lag <= 0:
            return
        pitch_freq_hz_q16 = ((fs_khz * 1000) << 16) // prev_lag
        pitch_freq_log_q7 = silk_lin2log(pitch_freq_hz_q16) - (16 << 7)
        min_cutoff_log_q7 = (silk_lin2log(VARIABLE_HP_MIN_CUTOFF_HZ << 16)
                             - (16 << 7))
        quality_term = smulwb(-(quality_q15 << 2), quality_q15)
        pitch_freq_log_q7 = smlawb(pitch_freq_log_q7, quality_term,
                                   pitch_freq_log_q7 - min_cutoff_log_q7)
        delta_freq_q7 = pitch_freq_log_q7 - (self.smth1_q15 >> 8)
        if delta_freq_q7 < 0:
            delta_freq_q7 *= 3
        delta_freq_q7 = max(-VARIABLE_HP_MAX_DELTA_FREQ_Q7,
                            min(VARIABLE_HP_MAX_DELTA_FREQ_Q7, delta_freq_q7))
        speech_weight = smulbb(speech_activity_q8, delta_freq_q7)
        self.smth1_q15 = smlawb(self.smth1_q15, speech_weight,
                                VARIABLE_HP_SMTH_COEF1_Q16)
        lo = silk_lin2log(VARIABLE_HP_MIN_CUTOFF_HZ) << 8
        hi = silk_lin2log(VARIABLE_HP_MAX_CUTOFF_HZ) << 8
        self.smth1_q15 = max(lo, min(hi, self.smth1_q15))

    # -- update_high_pass_state -----------------------------------------
    def cutoff_hz(self, celt_only: bool = False) -> int:
        target = (silk_lin2log(VARIABLE_HP_MIN_CUTOFF_HZ) << 8
                  if celt_only else self.smth1_q15)
        self.smth2_q15 = smlawb(self.smth2_q15, target - self.smth2_q15,
                                VARIABLE_HP_SMTH_COEF2_Q16)
        return silk_log2lin(self.smth2_q15 >> 8)


def hp_cutoff(x: np.ndarray, cutoff_hz: int, mem: np.ndarray,
              fs: int) -> np.ndarray:
    """Second-order variable high-pass (opus_encoder.rs:2100-2173).

    x: (N, C) float in [-1, 1]; filtered copy returned, mem updated."""
    fc_q19 = (HP_CUTOFF_COEF_Q19 * cutoff_hz) // (fs // 1000)
    r_q28 = (1 << 28) - HP_CUTOFF_R_COEF_Q9 * fc_q19
    b0, b1, b2 = r_q28, -2 * r_q28, r_q28
    r_q22 = r_q28 >> 6
    fc_sq_q22 = smulww(fc_q19, fc_q19)
    a0 = smulww(r_q22, fc_sq_q22 - (2 << 22))
    a1 = smulww(r_q22, r_q22)
    s = 1.0 / (1 << 28)
    return _biquad_tdf2(x, b0 * s, b1 * s, b2 * s, a0 * s, a1 * s, mem)


def _biquad_tdf2(x, b0, b1, b2, a0, a1, mem):
    out = np.empty_like(x, np.float64)
    for c in range(x.shape[1]):
        s0, s1 = float(mem[2 * c]), float(mem[2 * c + 1])
        xc = x[:, c]
        oc = out[:, c]
        for i in range(len(xc)):
            xi = float(xc[i])
            v = s0 + b0 * xi
            s0 = s1 - v * a0 + b1 * xi
            s1 = -v * a1 + b2 * xi + VERY_SMALL
            oc[i] = v
        mem[2 * c], mem[2 * c + 1] = s0, s1
    return out.astype(x.dtype, copy=False)


def dc_reject(x: np.ndarray, cutoff_hz: int, mem: np.ndarray,
              fs: int) -> np.ndarray:
    """First-order DC rejection (opus_encoder.rs:2248-2345). Vectorised:
    out[n] = x[n] - m[n], m[n+1] = coef*x[n] + (1-coef)*m[n] is a linear
    recurrence solved in closed form (coef2^k prefix products)."""
    coef = 6.3 * cutoff_hz / fs
    coef2 = 1.0 - coef
    n = x.shape[0]
    # m[k] = coef2^k * m0 + coef * sum_{j<k} coef2^(k-1-j) * x[j]
    pw = np.power(coef2, np.arange(n + 1))
    out = np.empty_like(x, np.float64)
    for c in range(x.shape[1]):
        xc = np.asarray(x[:, c], np.float64)
        acc = np.concatenate(([0.0], np.cumsum(xc / pw[1:] * coef)))
        m = pw[:-1] * (float(mem[2 * c]) + acc[:-1])
        out[:, c] = xc - m
        mem[2 * c] = coef2 ** n * float(mem[2 * c]) + coef * float(
            (pw[:-1][::-1] * xc).sum())
    return out.astype(x.dtype, copy=False)
