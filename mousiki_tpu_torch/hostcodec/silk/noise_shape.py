"""SILK encoder noise-shaping stack (float).

Behavioral port of the reference's quality pipeline
(`noise_shape_analysis_flp.rs`, `process_gains_flp.rs`, `control_snr.rs`,
`nsq.rs`): bitrate -> SNR target, per-subframe shaping-LPC analysis,
harmonic/tilt/low-frequency shaping controls, SNR-driven quantization
gains, and a float noise-shaping quantizer whose per-sample decision and
state recursions mirror silk_NSQ (Q formats translated to plain float —
the bitstream carries only pulse integers, so conformance is unaffected;
the mirror decoder advances with exact decoder arithmetic afterwards).
"""

from __future__ import annotations

import math

import numpy as np

import os as _os
_NSQ_DEBUG = bool(_os.environ.get("NSQ_DEBUG"))

# -- tuning constants (reference silk/tuning_parameters.rs) ---------------
BG_SNR_DECR_DB = 2.0
HARM_SNR_INCR_DB = 2.0
ENERGY_VARIATION_THRESHOLD_QNT_OFFSET = 0.6
SHAPE_WHITE_NOISE_FRACTION = 3e-5
BANDWIDTH_EXPANSION = 0.94
HARMONIC_SHAPING = 0.3
HIGH_RATE_OR_LOW_QUALITY_HARMONIC_SHAPING = 0.2
HP_NOISE_COEF = 0.25
HARM_HP_NOISE_COEF = 0.35
LOW_FREQ_SHAPING = 4.0
LOW_QUALITY_LOW_FREQ_SHAPING_DECR = 0.5
SUBFR_SMTH_COEF = 0.4
LAMBDA_OFFSET = 1.2
LAMBDA_SPEECH_ACT = -0.2
LAMBDA_DELAYED_DECISIONS = -0.05
LAMBDA_INPUT_QUALITY = -0.1
LAMBDA_CODING_QUALITY = -0.2
LAMBDA_QUANT_OFFSET = 0.8
FIND_PITCH_WHITE_NOISE_FRACTION = 1e-3
MIN_QGAIN_DB = 2.0
QUANT_LEVEL_ADJUST = 80.0 / 1024.0        # QUANT_LEVEL_ADJUST_Q10
LTP_ORDER = 5
HARM_SHAPE_FIR_TAPS = 3

# Quantization offsets (reference tables_other.rs, /1024):
# rows: [unvoiced, voiced], cols: [low, high]
_QUANT_OFFSETS = ((100.0 / 1024.0, 240.0 / 1024.0),
                  (32.0 / 1024.0, 100.0 / 1024.0))

# -- control_snr tables (reference control_snr.rs; values * 21 are
#    SNR_dB_Q7, i.e. dB = v * 21 / 128) ------------------------------------
_RATE_NB_DIV21 = (
    0, 15, 39, 52, 61, 68, 74, 79, 84, 88, 92, 95, 99, 102, 105, 108, 111,
    114, 117, 119, 122, 124, 126, 129, 131, 133, 135, 137, 139, 142, 143,
    145, 147, 149, 151, 153, 155, 157, 158, 160, 162, 163, 165, 167, 168,
    170, 171, 173, 174, 176, 177, 179, 180, 182, 183, 185, 186, 187, 189,
    190, 192, 193, 194, 196, 197, 199, 200, 201, 203, 204, 205, 207, 208,
    209, 211, 212, 213, 215, 216, 217, 219, 220, 221, 223, 224, 225, 227,
    228, 230, 231, 232, 234, 235, 236, 238, 239, 241, 242, 243, 245, 246,
    248, 249, 250, 252, 253, 255)
_RATE_MB_DIV21 = (
    0, 0, 28, 43, 52, 59, 65, 70, 74, 78, 81, 85, 87, 90, 93, 95, 98, 100,
    102, 105, 107, 109, 111, 113, 115, 116, 118, 120, 122, 123, 125, 127,
    128, 130, 131, 133, 134, 136, 137, 138, 140, 141, 143, 144, 145, 147,
    148, 149, 151, 152, 153, 154, 156, 157, 158, 159, 160, 162, 163, 164,
    165, 166, 167, 168, 169, 171, 172, 173, 174, 175, 176, 177, 178, 179,
    180, 181, 182, 183, 184, 185, 186, 187, 188, 188, 189, 190, 191, 192,
    193, 194, 195, 196, 197, 198, 199, 200, 201, 202, 203, 203, 204, 205,
    206, 207, 208, 209, 210, 211, 212, 213, 214, 214, 215, 216, 217, 218,
    219, 220, 221, 222, 223, 224, 224, 225, 226, 227, 228, 229, 230, 231,
    232, 233, 234, 235, 236, 236, 237, 238, 239, 240, 241, 242, 243, 244,
    245, 246, 247, 248, 249, 250, 251, 252, 253, 254, 255)
_RATE_WB_DIV21 = (
    0, 0, 0, 8, 29, 41, 49, 56, 62, 66, 70, 74, 77, 80, 83, 86, 88, 91, 93,
    95, 97, 99, 101, 103, 105, 107, 108, 110, 112, 113, 115, 116, 118, 119,
    121, 122, 123, 125, 126, 127, 129, 130, 131, 132, 134, 135, 136, 137,
    138, 140, 141, 142, 143, 144, 145, 146, 147, 148, 149, 150, 151, 152,
    153, 154, 156, 157, 158, 159, 159, 160, 161, 162, 163, 164, 165, 166,
    167, 168, 169, 170, 171, 171, 172, 173, 174, 175, 176, 177, 177, 178,
    179, 180, 181, 181, 182, 183, 184, 185, 185, 186, 187, 188, 189, 189,
    190, 191, 192, 192, 193, 194, 195, 195, 196, 197, 198, 198, 199, 200,
    200, 201, 202, 203, 203, 204, 205, 206, 206, 207, 208, 209, 209, 210,
    211, 211, 212, 213, 214, 214, 215, 216, 216, 217, 218, 219, 219, 220,
    221, 221, 222, 223, 224, 224, 225, 226, 226, 227, 228, 229, 229, 230,
    231, 232, 232, 233, 234, 234, 235, 236, 237, 237, 238, 239, 240, 240,
    241, 242, 243, 243, 244, 245, 246, 246, 247, 248, 249, 249, 250, 251,
    252, 253, 255)


def control_snr(fs_khz: int, nb_subfr: int, target_rate_bps: int) -> float:
    """Bitrate -> SNR_dB tuning target (reference control_snr.rs)."""
    rate = target_rate_bps
    if nb_subfr == 2:
        rate -= 2000 + fs_khz // 16
    table = (_RATE_NB_DIV21 if fs_khz == 8
             else _RATE_MB_DIV21 if fs_khz == 12 else _RATE_WB_DIV21)
    idx = (rate + 200) // 400
    idx = min(idx - 10, len(table) - 1)
    if idx <= 0:
        return 0.0
    return table[idx] * 21.0 / 128.0


def _sigmoid(x: float) -> float:
    return 1.0 / (1.0 + math.exp(-x))


def _autocorr(x: np.ndarray, order: int) -> np.ndarray:
    n = len(x)
    return np.array([float(x[: n - i] @ x[i:]) for i in range(order + 1)])


def _schur(c: np.ndarray, order: int):
    """Schur recursion: reflection coefficients + residual energy
    (silk_schur_flp semantics: rc denominator is the updated backward
    error c[0][1], which is also the returned residual)."""
    c = np.asarray(c, np.float64)
    C = np.stack([c[: order + 1].copy(), c[: order + 1].copy()])
    rc = np.zeros(order)
    for k in range(order):
        rck = -C[0, k + 1] / max(C[1, 0], 1e-9)
        rc[k] = rck
        c1 = C[0, k + 1: order + 1].copy()
        c2 = C[1, : order - k].copy()
        C[0, k + 1: order + 1] = c1 + c2 * rck
        C[1, : order - k] = c2 + c1 * rck
    return rc, float(C[1, 0])


def _k2a(rc: np.ndarray) -> np.ndarray:
    """Reflection coefficients -> AR prediction coefficients."""
    order = len(rc)
    a = np.zeros(order)
    for k in range(order):
        a[: k] = a[: k] + rc[k] * a[k - 1:: -1][: k]
        a[k] = rc[k]
    return -a  # sign convention: pred = sum a[j] * x[n-1-j]


def _bwexpander(a: np.ndarray, chirp: float) -> None:
    f = chirp
    for i in range(len(a)):
        a[i] *= f
        f *= chirp


def _limit_coefs(a: np.ndarray, limit: float) -> None:
    for it in range(10):
        ind = int(np.argmax(np.abs(a)))
        maxabs = abs(a[ind])
        if maxabs <= limit:
            return
        chirp = 0.99 - (0.8 + 0.1 * it) * (maxabs - limit) / (
            maxabs * (ind + 1.0))
        _bwexpander(a, chirp)
    np.clip(a, -limit, limit, out=a)


def _sine_window(n: int, half: int) -> np.ndarray:
    """apply_sine_window_flp windows (half 1 = rising, 2 = falling)."""
    k = np.arange(n)
    if half == 1:
        return np.sin(0.5 * np.pi * (k + 0.5) / n)
    return np.sin(0.5 * np.pi * (n - k - 0.5) / n)


def _warped_autocorr(x: np.ndarray, warping: float,
                     order: int) -> np.ndarray:
    """Warped autocorrelation via the two-stage allpass chain
    (reference warped_autocorrelation_flp.rs)."""
    state = np.zeros(order + 1)
    acc = np.zeros(order + 1)
    w = float(warping)
    for sample in np.asarray(x, np.float64):
        tmp1 = sample
        for sec in range(0, order, 2):
            tmp2 = state[sec] + w * state[sec + 1] - w * tmp1
            state[sec] = tmp1
            acc[sec] += state[0] * tmp1
            tmp1 = state[sec + 1] + w * state[sec + 2] - w * tmp2
            state[sec + 1] = tmp2
            acc[sec + 1] += state[0] * tmp2
        state[order] = tmp1
        acc[order] += state[0] * tmp1
    return acc


def _warped_gain(coefs: np.ndarray, lam: float) -> float:
    """Gain compensation for warped->linear prediction
    (noise_shape_analysis_flp.rs warped_gain)."""
    lam = -lam
    gain = coefs[-1]
    for c in coefs[-2::-1]:
        gain = lam * gain + c
    return 1.0 / (1.0 - lam * gain)


def _warped_true2monic(coefs: np.ndarray, lam: float, limit: float) -> None:
    """Convert warped coefs to monic + magnitude-limit, in place.

    NB deviation from the reference: noise_shape_analysis_flp.rs:54
    negates lambda before the Horner passes (copied from warped_gain,
    where libopus does negate) — that flips the conversion direction and
    yields a noise-feedback loop that is NOT minimum-phase for strongly
    tonal input (measured: the warped NSQ diverges on a 140 Hz tone).
    With lam kept positive, the converted chain satisfies exactly
    1 - H_chain(z) = (1 - sum a_j A(z)^{j+1}) / lag0  (A = the warped
    allpass), which is minimum-phase whenever the warped schur filter is
    — verified to machine precision in tests/test_nsq_del_dec.py.
    """
    order = len(coefs)
    for i in range(order - 1, 0, -1):
        coefs[i - 1] -= lam * coefs[i]
    gain = (1.0 - lam * lam) / (1.0 + lam * coefs[0])
    coefs *= gain
    for it in range(10):
        ind = int(np.argmax(np.abs(coefs)))
        maxabs = abs(coefs[ind])
        if maxabs <= limit:
            return
        # back to true warped domain, chirp, forward again
        for i in range(1, order):
            coefs[i - 1] += lam * coefs[i]
        coefs *= 1.0 / gain
        chirp = 0.99 - (0.8 + 0.1 * it) * (maxabs - limit) / (
            maxabs * (ind + 1.0))
        _bwexpander(coefs, chirp)
        for i in range(order - 1, 0, -1):
            coefs[i - 1] -= lam * coefs[i]
        gain = (1.0 - lam * lam) / (1.0 + lam * coefs[0])
        coefs *= gain
    np.clip(coefs, -limit, limit, out=coefs)


class ShapeState:
    """Cross-frame smoothers (reference shape_state)."""

    def __init__(self):
        self.harm_shape_gain_smth = 0.0
        self.tilt_smth = 0.0


class ShapeControl:
    """Per-frame shaping controls consumed by nsq_shaped."""

    def __init__(self, nb_subfr: int, order: int):
        self.ar = np.zeros((nb_subfr, order))
        self.gains = np.zeros(nb_subfr)
        self.harm_shape_gain = np.zeros(nb_subfr)
        self.tilt = np.zeros(nb_subfr)
        self.lf_ma = np.zeros(nb_subfr)
        self.lf_ar = np.zeros(nb_subfr)
        self.lambda_ = 0.1
        self.coding_quality = 0.0
        self.input_quality = 1.0
        self.quant_offset_type = 0


def noise_shape_analysis(xfull: np.ndarray, frame_length: int, nb_subfr: int,
                         fs_khz: int, snr_db: float, *, voiced: bool,
                         ltp_corr: float, pred_gain: float,
                         pitch_l, pitch_res: np.ndarray,
                         speech_activity: float, shape: ShapeState,
                         vbr: bool = True,
                         input_quality: float = 1.0,
                         warping_q16: int = 0) -> ShapeControl:
    """Per-subframe shaping filters/controls (noise_shape_analysis_flp.rs).

    xfull is [history | frame] at the internal rate (int16 scale floats);
    windows that would need lookahead are shifted back by the 5 ms slope
    (this encoder runs without the reference's LA_SHAPE delay buffer).

    warping_q16 > 0 selects the default-complexity warped analysis
    (noise_shape_analysis_flp.rs:246-281): shaping order 24, warped
    autocorrelation, warped-gain compensation and true->monic limiting,
    paired with the warped-feedback delayed-decision NSQ.
    """
    if warping_q16 > 0:
        order = 24
    else:
        order = 16 if fs_khz >= 16 else 12
    ctl = ShapeControl(nb_subfr, order)
    sub = frame_length // nb_subfr
    H = len(xfull) - frame_length

    snr_adj = snr_db
    ctl.input_quality = input_quality
    ctl.coding_quality = _sigmoid(0.25 * (snr_adj - 20.0))
    if vbr:
        b = 1.0 - speech_activity
        snr_adj -= (BG_SNR_DECR_DB * ctl.coding_quality
                    * (0.5 + 0.5 * ctl.input_quality) * b * b)

    if voiced:
        snr_adj += HARM_SNR_INCR_DB * ltp_corr
        ctl.quant_offset_type = 0
    else:
        # energy variation of the pitch residual decides the offset type
        n_samples = 2 * fs_khz                    # 2 ms segments
        n_segs = min(5 * nb_subfr // 2, len(pitch_res) // n_samples)
        var = 0.0
        prev = None
        for k in range(n_segs):
            seg = pitch_res[k * n_samples:(k + 1) * n_samples]
            log_e = math.log2(n_samples + float(seg @ seg))
            if prev is not None:
                var += abs(log_e - prev)
            prev = log_e
        ctl.quant_offset_type = (
            0 if var > ENERGY_VARIATION_THRESHOLD_QNT_OFFSET * (n_segs - 1)
            else 1)

    strength = FIND_PITCH_WHITE_NOISE_FRACTION * pred_gain
    bwexp = BANDWIDTH_EXPANSION / (1.0 + strength * strength)
    warping = (warping_q16 / 65536.0 + 0.01 * ctl.coding_quality
               if warping_q16 > 0 else 0.0)

    shape_win = 15 * fs_khz             # SHAPE_LPC_WIN_MS = 15
    flat_part = fs_khz * 3
    slope_part = (shape_win - flat_part) // 2
    win = np.concatenate([_sine_window(slope_part, 1),
                          np.ones(flat_part),
                          _sine_window(slope_part, 2)])

    for k in range(nb_subfr):
        # window [subframe start - slope, + flat + slope], clamped into xfull
        start = H + k * sub - slope_part
        start = max(0, min(start, len(xfull) - shape_win))
        xw = xfull[start: start + shape_win] * win
        if warping_q16 > 0:
            ac = _warped_autocorr(xw, warping, order)
        else:
            ac = _autocorr(xw, order)
        ac[0] += ac[0] * SHAPE_WHITE_NOISE_FRACTION + 1.0
        rc, nrg = _schur(ac, order)
        ctl.gains[k] = math.sqrt(max(nrg, 0.0))
        a = _k2a(rc)
        if warping_q16 > 0:
            ctl.gains[k] *= _warped_gain(a, warping)
        _bwexpander(a, bwexp)
        if warping_q16 > 0:
            _warped_true2monic(a, warping, 3.999)
        else:
            _limit_coefs(a, 3.999)
        ctl.ar[k] = a

    gain_mult = 2.0 ** (-0.16 * snr_adj)
    gain_add = 2.0 ** (0.16 * MIN_QGAIN_DB)
    ctl.gains[:] = ctl.gains * gain_mult + gain_add
    # Zero-lookahead safety: on sharp onsets the windowed schur residual
    # can report near-perfect predictability (synthetic/deterministic
    # attacks especially), quoting a quantization gain far below what the
    # closed-loop NSQ can realize from a silent decoder state -- the loop
    # then chases its own feedback and bits explode. Anchor each
    # subframe's gain to its actual input energy at the target SNR.
    for k in range(nb_subfr):
        seg = xfull[H + k * sub: H + (k + 1) * sub]
        rms = math.sqrt(float(seg @ seg) / max(1, len(seg)))
        ctl.gains[k] = max(ctl.gains[k], 0.7 * rms * gain_mult)

    lf_strength = LOW_FREQ_SHAPING * (
        1.0 + LOW_QUALITY_LOW_FREQ_SHAPING_DECR * (input_quality - 1.0))
    lf_strength *= speech_activity

    if voiced:
        for k in range(nb_subfr):
            b = 0.2 / fs_khz + 3.0 / max(1, int(pitch_l[k]))
            ctl.lf_ma[k] = -1.0 + b
            ctl.lf_ar[k] = 1.0 - b - b * lf_strength
        tilt = -HP_NOISE_COEF - (1.0 - HP_NOISE_COEF) * HARM_HP_NOISE_COEF \
            * speech_activity
    else:
        b = 1.3 / fs_khz
        ctl.lf_ma[:] = -1.0 + b
        ctl.lf_ar[:] = 1.0 - b - b * lf_strength * 0.6
        tilt = -HP_NOISE_COEF

    if voiced:
        harm = HARMONIC_SHAPING + HIGH_RATE_OR_LOW_QUALITY_HARMONIC_SHAPING \
            * (1.0 - (1.0 - ctl.coding_quality) * ctl.input_quality)
        harm *= math.sqrt(max(0.0, ltp_corr))
    else:
        harm = 0.0

    for k in range(nb_subfr):
        shape.harm_shape_gain_smth += SUBFR_SMTH_COEF * (
            harm - shape.harm_shape_gain_smth)
        ctl.harm_shape_gain[k] = shape.harm_shape_gain_smth
        shape.tilt_smth += SUBFR_SMTH_COEF * (tilt - shape.tilt_smth)
        ctl.tilt[k] = shape.tilt_smth

    return ctl


def process_gains(ctl: ShapeControl, nb_subfr: int, subfr_length: int,
                  snr_db: float, *, voiced: bool, lt_pred_cod_gain: float,
                  res_nrg, speech_activity: float,
                  input_tilt: float = 0.0) -> None:
    """LTP gain reduction + residual-energy floor + lambda
    (process_gains_flp.rs). Mutates ctl.gains (still unquantized float,
    int16 units) and ctl.lambda_/quant_offset_type."""
    if voiced:
        red = 1.0 - 0.5 * _sigmoid(0.25 * (lt_pred_cod_gain - 12.0))
        ctl.gains[:nb_subfr] *= red

    inv_max_sqr = 2.0 ** (0.33 * (21.0 - snr_db)) / subfr_length
    for k in range(nb_subfr):
        ctl.gains[k] = min(
            math.sqrt(ctl.gains[k] ** 2 + float(res_nrg[k]) * inv_max_sqr),
            32767.0)

    if voiced:
        ctl.quant_offset_type = 0 if lt_pred_cod_gain + input_tilt > 1.0 \
            else 1

    sig_row = 1 if voiced else 0
    q_off = _QUANT_OFFSETS[sig_row][ctl.quant_offset_type]
    ctl.lambda_ = (LAMBDA_OFFSET
                   + LAMBDA_SPEECH_ACT * speech_activity
                   + LAMBDA_INPUT_QUALITY * ctl.input_quality
                   + LAMBDA_CODING_QUALITY * ctl.coding_quality
                   + LAMBDA_QUANT_OFFSET * q_off)


class NsqState:
    """Cross-frame float NSQ state (reference NoiseShapingQuantizerState)."""

    def __init__(self, ltp_mem_length: int, order: int = 16):
        self.xq = np.zeros(2 * ltp_mem_length)   # unscaled quantized output
        self.s_ltp_shp = np.zeros(2 * ltp_mem_length)
        self.s_lpc = np.zeros(32)                # scaled domain
        self.s_ar2 = np.zeros(24)
        self.s_lf_ar = 0.0
        self.s_diff = 0.0
        self.lag_prev = 0
        self.prev_gain = 1.0
        self.rand_seed = 0


def nsq_shaped(x: np.ndarray, st_nsq: NsqState, ctl: ShapeControl, *,
               signal_type: int, seed: int, nb_subfr: int,
               frame_length: int, ltp_mem_length: int, lpc_order: int,
               pred_coef_q12, ltp_coef_q14, gains_q16, pitch_l,
               ltp_scale_q14: int, nlsf_interp_flag: bool = False):
    """Float noise-shaping quantizer (reference nsq.rs silk_NSQ, Q formats
    translated to plain float). Returns the pulse integers.

    x: current frame at int16 scale. State buffers live in the gain-scaled
    domain exactly like the reference; the unscaled xq history is kept for
    LTP re-whitening. pred_coef_q12: [half0, half1] LPC Q12 vectors.
    """
    from .decode_core import silk_rand
    from .fixed_math import i32
    sub = frame_length // nb_subfr
    voiced = signal_type == 2
    order = ctl.ar.shape[1]
    pulses = [0] * frame_length

    offset = _QUANT_OFFSETS[1 if voiced else 0][ctl.quant_offset_type]
    lam = ctl.lambda_
    rand_seed = i32(seed)
    s_ltp = np.zeros(ltp_mem_length + frame_length)       # whitened, unscaled
    s_ltp_sc = np.zeros(ltp_mem_length + frame_length)    # scaled
    shp_buf_idx = ltp_mem_length
    ltp_buf_idx = ltp_mem_length
    lag = st_nsq.lag_prev
    xq_all = st_nsq.xq
    shp = st_nsq.s_ltp_shp
    NSQ_LPC_BUF = 32

    def level_val(q0):
        """Dequantized excitation for pulse q0 (x_sc units)."""
        if q0 > 0:
            return q0 - QUANT_LEVEL_ADJUST + offset
        if q0 == 0:
            return offset
        if q0 == -1:
            return offset - (1.0 - QUANT_LEVEL_ADJUST)
        return q0 + QUANT_LEVEL_ADJUST + offset

    for k in range(nb_subfr):
        fo = k * sub
        half = (k >> 1) if nlsf_interp_flag else 1
        a = np.asarray(pred_coef_q12[half], np.float64)[:lpc_order] / 4096.0
        ar = a[::-1].copy()            # for vector dot against time order
        b = np.asarray(ltp_coef_q14[k * LTP_ORDER:(k + 1) * LTP_ORDER],
                       np.float64) / 16384.0
        ar_shp = ctl.ar[k]
        gain = max(1, int(gains_q16[k])) / 65536.0
        inv_gain = 1.0 / gain

        rewhite = False
        if voiced:
            lag = int(pitch_l[k])
            if (k & (1 if nlsf_interp_flag else 3)) == 0:
                start = ltp_mem_length - lag - lpc_order - LTP_ORDER // 2
                start = max(1, start)
                # whiten the unscaled xq history with this half's LPC
                seg = xq_all[start + fo: ltp_mem_length + fo]
                res = seg.copy()
                for j in range(lpc_order):
                    res[j + 1:] -= a[j] * seg[: len(seg) - j - 1]
                res[: lpc_order] = 0.0
                s_ltp[start: ltp_mem_length] = res
                rewhite = True
                ltp_buf_idx = ltp_mem_length

        # ---- scale_states (nsq.rs nsq_scale_states) ----------------------
        x_sc = x[fo: fo + sub] * inv_gain
        if rewhite:
            ig = inv_gain
            if k == 0:
                ig *= ltp_scale_q14 / 16384.0
            lo = ltp_buf_idx - lag - LTP_ORDER // 2
            s_ltp_sc[lo: ltp_buf_idx] = s_ltp[lo: ltp_buf_idx] * ig
        if gain != st_nsq.prev_gain:
            adj = st_nsq.prev_gain / gain
            shp[shp_buf_idx - ltp_mem_length: shp_buf_idx] *= adj
            if voiced and not rewhite:
                lo = ltp_buf_idx - lag - LTP_ORDER // 2
                s_ltp_sc[lo: ltp_buf_idx] *= adj
            st_nsq.s_lf_ar *= adj
            st_nsq.s_diff *= adj
            st_nsq.s_lpc *= adj
            st_nsq.s_ar2 *= adj
            st_nsq.prev_gain = gain

        # ---- per-sample quantizer (silk_noise_shape_quantizer) -----------
        _dbg_acc = ([], [], [], [], [], [])
        shp_lag = shp_buf_idx - lag + HARM_SHAPE_FIR_TAPS // 2
        pred_lag = ltp_buf_idx - lag + LTP_ORDER // 2
        s_lpc = np.concatenate([st_nsq.s_lpc, np.zeros(sub)])
        lpc_off = NSQ_LPC_BUF - 1
        harm = ctl.harm_shape_gain[k]
        tilt = ctl.tilt[k]
        lf_ma = ctl.lf_ma[k]
        lf_ar = ctl.lf_ar[k]
        s_ar2 = st_nsq.s_ar2

        for i in range(sub):
            rand_seed = silk_rand(rand_seed)
            lpc_pred = float(
                ar @ s_lpc[lpc_off - lpc_order + 1: lpc_off + 1])
            if voiced:
                ltp_pred = float(
                    b @ s_ltp_sc[pred_lag: pred_lag - 5: -1])
                pred_lag += 1
            else:
                ltp_pred = 0.0

            # noise-shape feedback: FIR over past s_diff + tilt on s_lf_ar
            n_ar = float(ar_shp @ s_ar2[:order]) + tilt * st_nsq.s_lf_ar
            n_lf = lf_ma * shp[shp_buf_idx - 1] + lf_ar * st_nsq.s_lf_ar
            if lag > 0:
                n_ltp = harm * (0.25 * (shp[shp_lag] + shp[shp_lag - 2])
                                + 0.5 * shp[shp_lag - 1])
                shp_lag += 1
            else:
                n_ltp = 0.0

            r = x_sc[i] - (lpc_pred + ltp_pred - n_ar - n_lf - n_ltp)
            if _NSQ_DEBUG:
                for v, acc in zip((lpc_pred, ltp_pred, n_ar, n_lf, n_ltp, r),
                                  _dbg_acc):
                    acc.append(v)
            if rand_seed < 0:
                r = -r
            r = min(max(r, -31.0), 30.0)

            # two-candidate rate-distortion decision; at lambda > 2 the
            # reference adds a dead zone (rdo_offset) that prices small
            # pulses out entirely -- this is what makes bits collapse
            # monotonically when the byte-budget retry escalates lambda
            q_ideal = r - offset
            if lam > 2.0:
                rdo = 0.5 * lam - 0.5
                if q_ideal > rdo:
                    q0 = math.floor(q_ideal - rdo)
                elif q_ideal < -rdo:
                    q0 = math.floor(q_ideal + rdo)
                elif q_ideal < 0.0:
                    q0 = -1
                else:
                    q0 = 0
            else:
                q0 = math.floor(q_ideal)
            v1 = level_val(q0)
            v2 = level_val(q0 + 1)
            rd1 = lam * abs(v1) + (r - v1) ** 2
            rd2 = lam * abs(v2) + (r - v2) ** 2
            if rd2 < rd1:
                q0, v1 = q0 + 1, v2
            q0 = max(-1000, min(1000, q0))
            pulses[fo + i] = q0

            exc = -v1 if rand_seed < 0 else v1
            lpc_exc = exc + ltp_pred
            xq_v = lpc_exc + lpc_pred
            xq_all[ltp_mem_length + fo + i] = xq_v * gain
            lpc_off += 1
            s_lpc[lpc_off] = xq_v
            st_nsq.s_diff = xq_v - x_sc[i]
            # shift in the new s_diff (most recent first, matches the
            # reference feedback loop's effective delay line)
            s_ar2[1:] = s_ar2[:-1]
            s_ar2[0] = st_nsq.s_diff
            st_nsq.s_lf_ar = st_nsq.s_diff - n_ar
            shp[shp_buf_idx] = st_nsq.s_lf_ar - n_lf
            s_ltp_sc[ltp_buf_idx] = lpc_exc
            shp_buf_idx += 1
            ltp_buf_idx += 1
            rand_seed = i32(rand_seed + q0)

        st_nsq.s_lpc = s_lpc[sub: sub + NSQ_LPC_BUF].copy()
        if _NSQ_DEBUG:
            import os
            pk = np.array(pulses[fo: fo + sub])
            print(f"  sub{k}: gain={gain:.0f} x_sc={np.sqrt(np.mean(x_sc**2)):.2f}"
                  f" dbg(lpc,ltp,nar,nlf,nltp,r)="
                  f"{[round(float(np.sqrt(np.mean(np.array(v)**2))), 3) for v in _dbg_acc]}"
                  f" nz={int((pk != 0).sum())} max|p|={int(np.abs(pk).max())}")

    st_nsq.lag_prev = int(pitch_l[nb_subfr - 1]) if voiced else 0
    # roll the frame out of the persistent buffers
    xq_all[: ltp_mem_length] = xq_all[frame_length:
                                      frame_length + ltp_mem_length]
    shp[: ltp_mem_length] = shp[frame_length: frame_length + ltp_mem_length]
    return pulses
