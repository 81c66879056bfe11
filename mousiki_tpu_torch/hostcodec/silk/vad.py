"""SILK voice activity detector (reference src/silk/vad.rs, silk/VAD.c).

Fixed-point noise-estimator VAD: the frame is split into 4 bands
(0-1/1-2/2-4/4-8 kHz) with first-order allpass analysis filter banks,
per-band noise levels are tracked with an asymmetric smoother, and the
band SNRs combine into a smoothed speech-activity probability plus an
input tilt and per-band quality metrics. These feed the noise-shaping
analysis (lambda, harmonic shaping), the pitch-search thresholds and the
quant-offset decision in silk/encoder.py.

Integer arithmetic mirrors the reference exactly (Q formats preserved)
so the noise-level trajectory matches libopus's on identical input.
"""

from __future__ import annotations

import numpy as np

from .fixed_math import i32, silk_lin2log, smulbb, smulwb

VAD_N_BANDS = 4
VAD_INTERNAL_SUBFRAMES_LOG2 = 2
VAD_INTERNAL_SUBFRAMES = 1 << VAD_INTERNAL_SUBFRAMES_LOG2
VAD_NOISE_LEVEL_SMOOTH_COEF_Q16 = 1024
VAD_NOISE_LEVELS_BIAS = 50
VAD_SNR_FACTOR_Q16 = 45000
VAD_NEGATIVE_OFFSET_Q5 = 128
VAD_SNR_SMOOTH_COEF_Q18 = 4096
TILT_WEIGHTS = (30000, 6000, -12000, -12000)

# first-order allpass pair (ana_filt_bank_1.c, Q15)
_A_FB1_20 = 5394 << 1
_A_FB1_21 = -24290

_SIGM_SLOPE_Q10 = (237, 153, 73, 30, 12, 7)
_SIGM_POS_Q15 = (16384, 23955, 28861, 31213, 32178, 32548)
_SIGM_NEG_Q15 = (16384, 8812, 3906, 1554, 589, 219)


def sigm_q15(x_q5: int) -> int:
    """silk_sigm_Q15: LUT logistic on a Q5 argument."""
    if x_q5 < 0:
        x_q5 = -x_q5
        if x_q5 >= 6 * 32:
            return 0
        i = x_q5 >> 5
        return _SIGM_NEG_Q15[i] - _SIGM_SLOPE_Q10[i] * (x_q5 & 31)
    if x_q5 >= 6 * 32:
        return 32767
    i = x_q5 >> 5
    return _SIGM_POS_Q15[i] + _SIGM_SLOPE_Q10[i] * (x_q5 & 31)


def _sqrt_approx(x: int) -> int:
    """silk_SQRT_APPROX."""
    if x <= 0:
        return 0
    lz = 32 - int(x).bit_length()
    # 7 bits right below the MSB (reference silk_CLZ_FRAC)
    frac_q7 = ((x >> (24 - lz)) if lz <= 24 else (x << (lz - 24))) & 0x7F
    y = 32768 if (lz & 1) else 46214
    y >>= lz >> 1
    return y + smulwb(y, smulbb(213, frac_q7))


def _safe_lshift(v: int, n: int) -> int:
    if n <= 0:
        return v >> (-n)
    if n >= 31:
        return 0
    return i32(v << n)


def _add_pos_sat32(a: int, b: int) -> int:
    s = a + b
    if s < 0 or s > 0x7FFFFFFF:
        return 0x7FFFFFFF
    return s


class VadState:
    """silk_VAD_state (reference VadState, encoder/state.rs)."""

    def __init__(self):
        self.ana_state = [0, 0]
        self.ana_state1 = [0, 0]
        self.ana_state2 = [0, 0]
        self.xnrg_subfr = [0] * VAD_N_BANDS
        self.nrg_ratio_smth_q8 = [100 * 256] * VAD_N_BANDS
        self.hp_state = 0
        self.noise_level_bias = [max(VAD_NOISE_LEVELS_BIAS // (b + 1), 1)
                                 for b in range(VAD_N_BANDS)]
        self.nl = [100 * b for b in self.noise_level_bias]
        self.inv_nl = [0x7FFFFFFF // nl for nl in self.nl]
        self.counter = 15
        # outputs
        self.speech_activity_q8 = 0
        self.input_tilt_q15 = 0
        self.input_quality_bands_q15 = [0] * VAD_N_BANDS


def _ana_filt_bank_1(state: list, inp: np.ndarray):
    """Split into low/high half bands (sequential allpass pair)."""
    n2 = len(inp) // 2
    lo = np.empty(n2, np.int64)
    hi = np.empty(n2, np.int64)
    s0, s1 = state[0], state[1]
    ev = inp[0::2].astype(np.int64) << 10
    od = inp[1::2].astype(np.int64) << 10
    for k in range(n2):
        in32 = int(ev[k])
        y = i32(in32 - s0)
        x = i32(y + smulwb(y, _A_FB1_21))
        out1 = i32(s0 + x)
        s0 = i32(in32 + x)
        in32 = int(od[k])
        y = i32(in32 - s1)
        x = smulwb(y, _A_FB1_20)
        out2 = i32(s1 + x)
        s1 = i32(in32 + x)
        lo[k] = out2 + out1
        hi[k] = out2 - out1
    state[0], state[1] = s0, s1
    rr = lambda v: np.clip((v + 1024) >> 11, -32768, 32767).astype(np.int64)
    return rr(lo), rr(hi)


def compute_speech_activity(st: VadState, x16, fs_khz: int):
    """silk_VAD_GetSA_Q8: returns speech activity in [0, 1] and updates
    st.input_tilt_q15 / st.input_quality_bands_q15. x16: int16-scale
    samples, one 10/20 ms frame."""
    x = np.asarray(np.round(np.asarray(x16, np.float64)), np.int64)
    x = np.clip(x, -32768, 32767)
    frame_length = len(x)

    # band split: 0-4/4-8, then 0-2/2-4, then 0-1/1-2
    lo1, b3 = _ana_filt_bank_1(st.ana_state, x)            # b3: 4-8 kHz
    lo2, b2 = _ana_filt_bank_1(st.ana_state1, lo1)         # b2: 2-4 kHz
    b0, b1 = _ana_filt_bank_1(st.ana_state2, lo2)          # 0-1 / 1-2 kHz

    # HP filter on the lowest band (differentiator)
    b0 = (b0 >> 1).astype(np.int64)
    hp_tmp = int(b0[-1])
    b0[1:] = b0[1:] - b0[:-1]
    b0[0] -= st.hp_state
    st.hp_state = hp_tmp

    bands = [b0, b1, b2, b3]
    xnrg = [0] * VAD_N_BANDS
    for b in range(VAD_N_BANDS):
        shift = min(VAD_N_BANDS - b, VAD_N_BANDS - 1)
        dec_len = frame_length >> shift
        band = bands[b][:dec_len]
        sub = max(dec_len >> VAD_INTERNAL_SUBFRAMES_LOG2, 1)
        total = st.xnrg_subfr[b]
        last = 0
        off = 0
        for s in range(VAD_INTERNAL_SUBFRAMES):
            if off >= len(band):
                break
            chunk = band[off: off + sub]
            r = chunk >> 3
            acc = int((r * r).sum()) & 0xFFFFFFFF
            if acc >= 0x80000000:
                acc -= 0x100000000
            if s < VAD_INTERNAL_SUBFRAMES - 1:
                total = _add_pos_sat32(total, acc)
            else:
                total = _add_pos_sat32(total, acc >> 1)
            last = acc
            off += len(chunk)
        st.xnrg_subfr[b] = last
        xnrg[b] = total

    # noise level estimation
    min_coef = 0
    if st.counter < 1000:
        min_coef = 32767 // ((st.counter >> 4) + 1)
        st.counter += 1
    for b in range(VAD_N_BANDS):
        nrg = _add_pos_sat32(xnrg[b], st.noise_level_bias[b])
        if nrg <= 0:
            nrg = 1
        inv_nrg = 0x7FFFFFFF // nrg
        nl = st.nl[b]
        if nrg > _safe_lshift(nl, 3):
            coef = VAD_NOISE_LEVEL_SMOOTH_COEF_Q16 >> 3
        elif nrg < nl:
            coef = VAD_NOISE_LEVEL_SMOOTH_COEF_Q16
        else:
            coef = smulwb(i32((inv_nrg * nl) >> 16),
                          VAD_NOISE_LEVEL_SMOOTH_COEF_Q16 << 1)
        coef = max(coef, min_coef)
        st.inv_nl[b] = i32(st.inv_nl[b]
                           + ((inv_nrg - st.inv_nl[b]) * coef >> 16))
        nl_new = 0x7FFFFFFF // st.inv_nl[b] if st.inv_nl[b] > 0 else 0
        st.nl[b] = min(nl_new, 0x00FFFFFF)

    # band SNRs -> activity + tilt
    ratios_q8 = [256] * VAD_N_BANDS
    sum_sq = 0
    tilt = 0
    for b in range(VAD_N_BANDS):
        speech_nrg = xnrg[b] - st.nl[b]
        if speech_nrg > 0:
            if (xnrg[b] & 0xFF800000) == 0:
                ratios_q8[b] = (_safe_lshift(xnrg[b], 8)
                                // (st.nl[b] + 1))
            else:
                ratios_q8[b] = xnrg[b] // ((st.nl[b] >> 8) + 1)
            snr_q7 = silk_lin2log(ratios_q8[b]) - 8 * 128
            sum_sq = i32(sum_sq + snr_q7 * snr_q7)
            if speech_nrg < (1 << 20):
                snr_q7 = smulwb(_safe_lshift(_sqrt_approx(speech_nrg), 6),
                                snr_q7)
            tilt = i32(tilt + ((TILT_WEIGHTS[b] * snr_q7) >> 16))

    sum_sq //= VAD_N_BANDS
    snr_db_q7 = 3 * _sqrt_approx(sum_sq)
    sa_q15 = sigm_q15(smulwb(VAD_SNR_FACTOR_Q16, snr_db_q7)
                      - VAD_NEGATIVE_OFFSET_Q5)
    st.input_tilt_q15 = _safe_lshift(sigm_q15(tilt) - 16384, 1)

    speech_nrg_w = 0
    for b in range(VAD_N_BANDS):
        speech_nrg_w += (b + 1) * ((xnrg[b] - st.nl[b]) >> 4)
    if frame_length == 20 * fs_khz:
        speech_nrg_w >>= 1
    if speech_nrg_w <= 0:
        sa_q15 >>= 1
    elif speech_nrg_w < 16384:
        sa_q15 = smulwb(32768 + _sqrt_approx(
            _safe_lshift(int(speech_nrg_w), 16)), sa_q15)
    st.speech_activity_q8 = max(0, min(sa_q15 >> 7, 255))

    # per-band smoothed quality
    smooth_q16 = smulwb(VAD_SNR_SMOOTH_COEF_Q18, smulwb(sa_q15, sa_q15))
    if frame_length == 10 * fs_khz:
        smooth_q16 >>= 1
    for b in range(VAD_N_BANDS):
        st.nrg_ratio_smth_q8[b] = i32(
            st.nrg_ratio_smth_q8[b]
            + ((ratios_q8[b] - st.nrg_ratio_smth_q8[b]) * smooth_q16 >> 16))
        snr_q7 = 3 * (silk_lin2log(st.nrg_ratio_smth_q8[b]) - 8 * 128)
        st.input_quality_bands_q15[b] = sigm_q15((snr_q7 - 16 * 128) >> 4)

    return st.speech_activity_q8 / 256.0
