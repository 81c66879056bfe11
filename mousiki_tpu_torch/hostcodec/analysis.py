"""Music/speech tonality analysis driving encoder mode decisions.

Port of the reference analyzer (src/analysis.rs: tonality_analysis:604,
run_analysis:1124; src/mlp.rs: analysis_compute_dense/gru:171,206): 20 ms
hops at an internal 24 kHz rate, 480-point FFT, per-bin tonality from
phase second derivatives, 18 Bark-ish band energies, BFCC features with
fixed delta kernels, and the trained 25->32 dense + 24-unit GRU + 2-unit
sigmoid MLP (weights from mlp_data) producing music probability and
activity; plus noise-floor-based bandwidth detection and leak boosts.

`tonality_get_info` here returns the most recent valid frame with light
smoothing (the reference's full DETECT_SIZE vote/hysteresis pipeline is
approximated; music_prob_min/max come from the recent window).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import analysis_tables as T

NB_FRAMES = 8
NB_TBANDS = 18
ANALYSIS_BUF_SIZE = 720
DETECT_SIZE = 100
NB_TONAL_SKIP_BANDS = 9
SCALE_ENER = 1.0 / (32768.0 * 32768.0)
INITIAL_MEM_FILL = 240
LEAKAGE_OFFSET = 2.5
LEAKAGE_SLOPE = 2.0
LOG2_E = 1.4426950408889634
WEIGHTS_SCALE = 1.0 / 128.0
ANALYSIS_COUNT_MAX = 10000

_WIN = np.asarray(T.ANALYSIS_WINDOW, np.float64)
_TB = [int(v) for v in T.TBANDS]
_DCT = np.asarray(T.DCT_TABLE, np.float64).reshape(8, 16)
_STD_BIAS = np.asarray(T.STD_FEATURE_BIAS, np.float64)

_L0W = np.asarray(T.LAYER0_WEIGHTS, np.float64).reshape(25, 32)   # col-major
_L0B = np.asarray(T.LAYER0_BIAS, np.float64)
_L1W = np.asarray(T.LAYER1_WEIGHTS, np.float64).reshape(32, 72)
_L1R = np.asarray(T.LAYER1_RECUR_WEIGHTS, np.float64).reshape(24, 72)
_L1B = np.asarray(T.LAYER1_BIAS, np.float64)
_L2W = np.asarray(T.LAYER2_WEIGHTS, np.float64).reshape(24, 2)
_L2B = np.asarray(T.LAYER2_BIAS, np.float64)


def tansig_approx(x):
    n = (0.60863042 * x * x + 96.39235687) * x * x + 952.52801514
    d = (11.88600922 * x * x + 413.36801147) * x * x + 952.72399902
    return np.clip(n * x / d, -1.0, 1.0)


def sigmoid_approx(x):
    return 0.5 + 0.5 * tansig_approx(0.5 * x)


def _dense(inp, w, b, sigmoid=False):
    v = (b + inp @ w) * WEIGHTS_SCALE
    return sigmoid_approx(v) if sigmoid else tansig_approx(v)


def _gru(inp, state):
    n = 24
    zrw = _L1B + inp @ _L1W
    z = sigmoid_approx((zrw[:n] + state @ _L1R[:, :n]) * WEIGHTS_SCALE)
    r = sigmoid_approx((zrw[n:2 * n] + state @ _L1R[:, n:2 * n]) * WEIGHTS_SCALE)
    h = tansig_approx((zrw[2 * n:] + (r * state) @ _L1R[:, 2 * n:])
                      * WEIGHTS_SCALE)
    return z * state + (1 - z) * h


@dataclass
class AnalysisInfo:
    valid: bool = False
    tonality: float = 0.0
    tonality_slope: float = 0.0
    noisiness: float = 0.0
    activity: float = 0.0
    music_prob: float = 0.0
    music_prob_min: float = 0.0
    music_prob_max: float = 0.0
    bandwidth: int = 0
    activity_probability: float = 0.0
    max_pitch_ratio: float = 1.0
    leak_boost: np.ndarray = field(
        default_factory=lambda: np.zeros(NB_TBANDS + 1, np.uint8))


@dataclass
class TonalityAnalysisState:
    fs: int = 48000
    angle: np.ndarray = field(default_factory=lambda: np.zeros(240))
    d_angle: np.ndarray = field(default_factory=lambda: np.zeros(240))
    d2_angle: np.ndarray = field(default_factory=lambda: np.zeros(240))
    inmem: np.ndarray = field(default_factory=lambda: np.zeros(ANALYSIS_BUF_SIZE))
    mem_fill: int = 0
    e: np.ndarray = field(default_factory=lambda: np.zeros((NB_FRAMES, NB_TBANDS)))
    log_e: np.ndarray = field(default_factory=lambda: np.zeros((NB_FRAMES, NB_TBANDS)))
    low_e: np.ndarray = field(default_factory=lambda: np.zeros(NB_TBANDS))
    high_e: np.ndarray = field(default_factory=lambda: np.zeros(NB_TBANDS))
    mean_e: np.ndarray = field(default_factory=lambda: np.zeros(NB_TBANDS + 1))
    prev_band_tonality: np.ndarray = field(default_factory=lambda: np.zeros(NB_TBANDS))
    prev_tonality: float = 0.0
    prev_bandwidth: int = 0
    e_tracker: float = 0.0
    low_e_count: float = 0.0
    mem: np.ndarray = field(default_factory=lambda: np.zeros(32))
    cmean: np.ndarray = field(default_factory=lambda: np.zeros(8))
    std: np.ndarray = field(default_factory=lambda: np.zeros(9))
    rnn_state: np.ndarray = field(default_factory=lambda: np.zeros(24))
    downmix_state: np.ndarray = field(default_factory=lambda: np.zeros(2))
    hp_ener_accum: float = 0.0
    count: int = 0
    e_count: int = 0
    write_pos: int = 0
    initialized: bool = False
    info: list = field(default_factory=lambda: [AnalysisInfo()
                                                for _ in range(DETECT_SIZE)])


def _down2_hp(state, x):
    """2:1 decimation (SILK down2 allpass pair) returning HP energy."""
    n = len(x) // 2
    out = np.empty(n)
    hp_ener = 0.0
    s0, s1 = state[0], state[1]
    for k in range(n):
        in0 = x[2 * k]
        y = in0 - s0
        xv = 0.6074371 * y
        o0 = s0 + xv
        s0 = in0 + xv
        in1 = x[2 * k + 1]
        y = in1 - s1
        xv = 0.15063 * y
        o1 = s1 + xv
        s1 = in1 + xv
        out[k] = 0.5 * (o0 + o1)
        hp = 0.5 * (o0 - o1)
        hp_ener += hp * hp
    state[0], state[1] = s0, s1
    return out, hp_ener


def _downmix(state, pcm, n, offset, channels):
    """Downmix to mono (int16 scale) + resample to 24 kHz; returns hp_ener."""
    if channels == 2:
        seg = 0.5 * (pcm[offset:offset + n, 0] + pcm[offset:offset + n, 1])
    else:
        seg = pcm[offset:offset + n, 0]
    return seg * 32768.0


def tonality_analysis(tonal: TonalityAnalysisState, pcm: np.ndarray,
                      length: int, offset: int, channels: int,
                      lsb_depth: int = 16) -> None:
    if not tonal.initialized:
        tonal.mem_fill = INITIAL_MEM_FILL
        tonal.initialized = True
    alpha = 1.0 / min(10, 1 + tonal.count)
    alpha_e = 1.0 / min(25, 1 + tonal.count)
    alpha_e2 = 1.0 / min(100, 1 + tonal.count)
    if tonal.count <= 1:
        alpha_e2 = 1.0

    # at 48 kHz the analyzer runs on a 24 kHz downmix
    length //= 2

    avail = min(length, ANALYSIS_BUF_SIZE - tonal.mem_fill)
    mono = _downmix(tonal.downmix_state, pcm, 2 * avail, offset, channels)
    ds, hp = _down2_hp(tonal.downmix_state, mono)
    tonal.inmem[tonal.mem_fill: tonal.mem_fill + avail] = ds
    tonal.hp_ener_accum += hp
    hp_ener = tonal.hp_ener_accum

    if tonal.mem_fill + length < ANALYSIS_BUF_SIZE:
        tonal.mem_fill += length
        return

    info_slot = tonal.write_pos
    tonal.write_pos = (tonal.write_pos + 1) % DETECT_SIZE

    buf = tonal.inmem.copy()
    inr = np.empty(480)
    ini = np.empty(480)
    i = np.arange(240)
    inr[i] = _WIN[i] * buf[i]
    ini[i] = _WIN[i] * buf[240 + i]
    inr[479 - i] = _WIN[i] * buf[479 - i]
    ini[479 - i] = _WIN[i] * buf[719 - i]

    tonal.inmem[:240] = tonal.inmem[ANALYSIS_BUF_SIZE - 240:]
    remaining = length - (ANALYSIS_BUF_SIZE - tonal.mem_fill)
    mono2 = _downmix(tonal.downmix_state, pcm,
                     2 * remaining,
                     offset + 2 * (ANALYSIS_BUF_SIZE - tonal.mem_fill),
                     channels)
    ds2, hp2 = _down2_hp(tonal.downmix_state, mono2)
    tonal.inmem[240: 240 + remaining] = ds2
    tonal.hp_ener_accum = hp2
    tonal.mem_fill = 240 + remaining

    if float(np.abs(buf).max()) < 1.0 / (1 << max(0, lsb_depth - 1)):
        prev = (tonal.write_pos + DETECT_SIZE - 2) % DETECT_SIZE
        tonal.info[info_slot] = tonal.info[prev]
        return

    out = np.fft.fft(inr + 1j * ini)

    info = AnalysisInfo()
    # per-bin tonality from the phase second derivative
    idx = np.arange(1, 240)
    x1r = out.real[idx] + out.real[480 - idx]
    x1i = out.imag[idx] - out.imag[480 - idx]
    x2r = out.imag[idx] + out.imag[480 - idx]
    x2i = out.real[480 - idx] - out.real[idx]
    angle = 0.5 / np.pi * np.arctan2(x1i, x1r)
    d_angle = angle - tonal.angle[idx]
    d2_angle = d_angle - tonal.d_angle[idx]
    angle2 = 0.5 / np.pi * np.arctan2(x2i, x2r)
    d_angle2 = angle2 - angle
    d2_angle2 = d_angle2 - d_angle

    mod1 = d2_angle - np.rint(d2_angle)
    noisiness = np.zeros(240)
    noisiness[idx] = np.abs(mod1)
    mod1 = mod1 ** 4
    mod2 = d2_angle2 - np.rint(d2_angle2)
    noisiness[idx] += np.abs(mod2)
    mod2 = mod2 ** 4
    avg_mod = 0.25 * (tonal.d2_angle[idx] + mod1 + 2.0 * mod2)
    scale = 40.0 * 16.0 * (np.pi ** 4)
    tonality = np.zeros(240)
    tonality[idx] = 1.0 / (1.0 + scale * avg_mod) - 0.015
    tonality2 = np.zeros(240)
    tonality2[idx] = 1.0 / (1.0 + scale * mod2) - 0.015
    tonal.angle[idx] = angle2
    tonal.d_angle[idx] = d_angle2
    tonal.d2_angle[idx] = mod2

    t2 = tonality.copy()
    for i in range(2, 239):
        tt = min(tonality2[i], max(tonality2[i - 1], tonality2[i + 1]))
        t2[i] = 0.9 * max(tonality[i], tt - 0.1)
    tonality = t2

    if tonal.count == 0:
        tonal.low_e[:] = 1e10
        tonal.high_e[:] = -1e10

    def bin_e(i):
        if i == 0:
            return (2 * out.real[0]) ** 2 + (2 * out.imag[0]) ** 2
        return (out.real[i] ** 2 + out.imag[i] ** 2
                + out.real[480 - i] ** 2 + out.imag[480 - i] ** 2)

    band_log2 = np.zeros(NB_TBANDS + 1)
    e0 = sum(bin_e(i) for i in range(4)) * SCALE_ENER
    band_log2[0] = 0.5 * LOG2_E * np.log(e0 + 1e-10)

    log_e = np.zeros(NB_TBANDS)
    band_tonality = np.zeros(NB_TBANDS)
    frame_noisiness = frame_stationarity = frame_tonality = 0.0
    max_frame_tonality = slope = relative_e = frame_loudness = 0.0
    for b in range(NB_TBANDS):
        lo, hi = _TB[b], _TB[b + 1]
        be = np.array([bin_e(i) for i in range(lo, hi)]) * SCALE_ENER
        band_e = float(be.sum())
        t_e = float((be * np.maximum(tonality[lo:hi], 0.0)).sum())
        n_e = float((2.0 * be * (0.5 - noisiness[lo:hi])).sum())
        tonal.e[tonal.e_count, b] = band_e
        frame_noisiness += n_e / (1e-15 + band_e)
        frame_loudness += np.sqrt(band_e + 1e-10)
        log_e[b] = np.log(band_e + 1e-10)
        band_log2[b + 1] = 0.5 * LOG2_E * log_e[b]
        tonal.log_e[tonal.e_count, b] = log_e[b]
        if tonal.count == 0:
            tonal.high_e[b] = tonal.low_e[b] = log_e[b]
        if tonal.high_e[b] > tonal.low_e[b] + 7.5:
            if tonal.high_e[b] - log_e[b] > log_e[b] - tonal.low_e[b]:
                tonal.high_e[b] -= 0.01
            else:
                tonal.low_e[b] += 0.01
        if log_e[b] > tonal.high_e[b]:
            tonal.high_e[b] = log_e[b]
            tonal.low_e[b] = max(tonal.high_e[b] - 15.0, tonal.low_e[b])
        elif log_e[b] < tonal.low_e[b]:
            tonal.low_e[b] = log_e[b]
            tonal.high_e[b] = min(tonal.low_e[b] + 15.0, tonal.high_e[b])
        relative_e += (log_e[b] - tonal.low_e[b]) / (
            1e-5 + tonal.high_e[b] - tonal.low_e[b])
        l1 = float(np.sqrt(tonal.e[:, b]).sum())
        l2 = float(tonal.e[:, b].sum())
        stationarity = min(0.99, l1 / np.sqrt(1e-15 + NB_FRAMES * l2))
        stationarity = stationarity ** 4
        frame_stationarity += stationarity
        band_tonality[b] = max(t_e / (1e-15 + band_e),
                               stationarity * tonal.prev_band_tonality[b])
        frame_tonality += band_tonality[b]
        if b >= NB_TBANDS - NB_TONAL_SKIP_BANDS:
            frame_tonality -= band_tonality[b + NB_TONAL_SKIP_BANDS - NB_TBANDS]
        max_frame_tonality = max(
            max_frame_tonality, (1.0 + 0.03 * (b - NB_TBANDS)) * frame_tonality)
        slope += band_tonality[b] * (b - 8)
        tonal.prev_band_tonality[b] = band_tonality[b]

    # leakage boosts
    leak_from = np.zeros(NB_TBANDS + 1)
    leak_to = np.zeros(NB_TBANDS + 1)
    leak_from[0] = band_log2[0]
    leak_to[0] = band_log2[0] - LEAKAGE_OFFSET
    for b in range(1, NB_TBANDS + 1):
        sl = LEAKAGE_SLOPE * (_TB[b] - _TB[b - 1]) / 4.0
        leak_from[b] = min(leak_from[b - 1] + sl, band_log2[b])
        leak_to[b] = max(leak_to[b - 1] - sl, band_log2[b] - LEAKAGE_OFFSET)
    for b in range(NB_TBANDS - 1, -1, -1):
        sl = LEAKAGE_SLOPE * (_TB[b + 1] - _TB[b]) / 4.0
        leak_from[b] = min(leak_from[b + 1] + sl, leak_from[b])
        leak_to[b] = max(leak_to[b + 1] - sl, leak_to[b])
    boost = (np.maximum(leak_to - band_log2, 0.0)
             + np.maximum(band_log2 - (leak_from + LEAKAGE_OFFSET), 0.0))
    info.leak_boost = np.minimum(np.floor(64.0 * boost + 0.5), 255).astype(np.uint8)

    # spectral variability
    spec_var = 0.0
    for i in range(NB_FRAMES):
        dists = [float(((tonal.log_e[i] - tonal.log_e[j]) ** 2).sum())
                 for j in range(NB_FRAMES) if j != i]
        spec_var += min(dists)
    spec_var = np.sqrt(spec_var / (NB_FRAMES * NB_TBANDS))

    # bandwidth detection
    bandwidth_mask = 0.0
    bandwidth = 0
    max_e = 0.0
    noise_floor = (5.7e-4 / (1 << max(0, lsb_depth - 8))) ** 2
    below = above = 0.0
    is_masked = np.zeros(NB_TBANDS + 1, bool)
    for b in range(NB_TBANDS):
        lo, hi = _TB[b], _TB[b + 1]
        band_e = sum(bin_e(i) for i in range(lo, hi)) * SCALE_ENER
        max_e = max(max_e, band_e)
        if lo < 64:
            below += band_e
        else:
            above += band_e
        tonal.mean_e[b] = max((1.0 - alpha_e2) * tonal.mean_e[b], band_e)
        em = max(tonal.mean_e[b], band_e)
        if band_e * 1e9 > max_e and (em > 3.0 * noise_floor * (hi - lo)
                                     or band_e > noise_floor * (hi - lo)):
            bandwidth = b + 1
        thr = (0.01 if tonal.prev_bandwidth >= b + 1 else 0.05) * bandwidth_mask
        is_masked[b] = band_e < thr
        bandwidth_mask = max(0.05 * bandwidth_mask, band_e)
    # >12 kHz energy in band units (N * mean(window^2) Parseval factor),
    # then the reference's /3600 damping so halfband leakage from loud
    # low-frequency content stays under the masking thresholds
    e_high = max(0.0, hp_ener * SCALE_ENER * 480.0
                 * float((_WIN ** 2).mean()) / 3600.0)
    noise_ratio = 10.0 if tonal.prev_bandwidth == 20 else 30.0
    above += e_high
    tonal.mean_e[NB_TBANDS] = max((1.0 - alpha_e2) * tonal.mean_e[NB_TBANDS],
                                  e_high)
    em = max(tonal.mean_e[NB_TBANDS], e_high)
    if (em > 3.0 * noise_ratio * noise_floor * 160.0
            or e_high > noise_ratio * noise_floor * 160.0):
        bandwidth = 20
    thr = (0.01 if tonal.prev_bandwidth == 20 else 0.05) * bandwidth_mask
    is_masked[NB_TBANDS] = e_high < thr

    info.max_pitch_ratio = below / above if above > below else 1.0
    if bandwidth == 20 and is_masked[NB_TBANDS]:
        bandwidth -= 2
    elif 0 < bandwidth <= NB_TBANDS and is_masked[bandwidth - 1]:
        bandwidth -= 1
    if tonal.count <= 2:
        bandwidth = 20

    frame_loudness = 20.0 * np.log10(frame_loudness + 1e-15)
    tonal.e_tracker = max(tonal.e_tracker - 0.003, frame_loudness)
    tonal.low_e_count *= 1.0 - alpha_e
    if frame_loudness < tonal.e_tracker - 30.0:
        tonal.low_e_count += alpha_e

    bfcc = _DCT[:, :16] @ log_e[:16]
    mid = 0.5 * (tonal.high_e[:16] + tonal.low_e[:16])
    mid_e = _DCT[:, :16] @ mid

    frame_stationarity /= NB_TBANDS
    relative_e /= NB_TBANDS
    if tonal.count < 10:
        relative_e = 0.5
    frame_noisiness /= NB_TBANDS
    info.activity = frame_noisiness + (1.0 - frame_noisiness) * relative_e
    frame_tonality = max_frame_tonality / (NB_TBANDS - NB_TONAL_SKIP_BANDS)
    frame_tonality = max(frame_tonality, tonal.prev_tonality * 0.8)
    tonal.prev_tonality = frame_tonality
    slope /= 64.0
    info.tonality_slope = slope
    tonal.e_count = (tonal.e_count + 1) % NB_FRAMES
    tonal.count = min(tonal.count + 1, ANALYSIS_COUNT_MAX)
    info.tonality = frame_tonality

    feats = np.zeros(25)
    m = tonal.mem
    for i in range(4):
        feats[i] = (-0.12299 * (bfcc[i] + m[i + 24])
                    + 0.49195 * (m[i] + m[i + 16])
                    + 0.69693 * m[i + 8] - 1.4349 * tonal.cmean[i])
    tonal.cmean[:4] = (1.0 - alpha) * tonal.cmean[:4] + alpha * bfcc[:4]
    tonal.cmean[4:] = (1.0 - alpha) * tonal.cmean[4:] + alpha * bfcc[4:]
    for i in range(4):
        feats[4 + i] = (0.63246 * (bfcc[i] - m[i + 24])
                        + 0.31623 * (m[i] - m[i + 16]))
    for i in range(3):
        feats[8 + i] = (0.53452 * (bfcc[i] + m[i + 24])
                        - 0.26726 * (m[i] + m[i + 16]) - 0.53452 * m[i + 8])
    if tonal.count > 5:
        tonal.std[:9] = (1.0 - alpha) * tonal.std[:9] + alpha * feats[:9] ** 2
    for i in range(4):
        feats[i] = bfcc[i] - mid_e[i]
    m[24:32] = m[16:24]
    m[16:24] = m[8:16]
    m[8:16] = m[:8]
    m[:8] = bfcc
    feats[11:20] = np.sqrt(tonal.std[:9]) - _STD_BIAS
    feats[18] = spec_var - 0.78
    feats[20] = info.tonality - 0.154723
    feats[21] = info.activity - 0.724643
    feats[22] = frame_stationarity - 0.743717
    feats[23] = info.tonality_slope + 0.069216
    feats[24] = tonal.low_e_count - 0.067930

    layer_out = _dense(feats, _L0W, _L0B)
    tonal.rnn_state = _gru(layer_out, tonal.rnn_state)
    probs = _dense(tonal.rnn_state, _L2W, _L2B, sigmoid=True)
    info.activity_probability = float(probs[1])
    info.music_prob = float(probs[0])
    info.bandwidth = bandwidth
    tonal.prev_bandwidth = bandwidth
    info.noisiness = frame_noisiness
    info.valid = True
    tonal.info[info_slot] = info


def tonality_get_info(tonal: TonalityAnalysisState) -> AnalysisInfo:
    """Most recent valid frame with a min/max over the recent window."""
    recent = [tonal.info[(tonal.write_pos - 1 - k) % DETECT_SIZE]
              for k in range(10)]
    valid = [i for i in recent if i.valid]
    if not valid:
        return AnalysisInfo()
    out = valid[0]
    probs = [i.music_prob for i in valid]
    out.music_prob_min = min(probs)
    out.music_prob_max = max(probs)
    return out


def run_analysis(tonal: TonalityAnalysisState, pcm: np.ndarray,
                 frame_size: int, channels: int) -> AnalysisInfo:
    """Feed one frame (48 kHz float (N, C) in [-1, 1]) through the analyzer."""
    offset = 0
    remaining = frame_size
    while remaining >= 960:
        tonality_analysis(tonal, pcm, 960, offset, channels)
        offset += 960
        remaining -= 960
    return tonality_get_info(tonal)
