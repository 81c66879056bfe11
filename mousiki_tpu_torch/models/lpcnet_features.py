"""LPCNet-style feature extraction feeding DRED / Deep PLC.

Reference lpcnet_enc.rs:134 (lpcnet_compute_single_frame_features): per
10 ms 16 kHz frame, 18 Bark-ish cepstral coefficients plus pitch period
and voicing correlation -> the 20-dim DRED feature vector. This is a
float reimplementation of the same feature recipe (windowed FFT, Bark
band energies, DCT cepstrum, autocorrelation pitch)."""

from __future__ import annotations

import numpy as np

FRAME_SIZE = 160        # 10 ms at 16 kHz
WINDOW_SIZE = 320
NB_BANDS = 18
NB_FEATURES = 20
PITCH_MIN = 32          # 500 Hz
PITCH_MAX = 256         # 62.5 Hz

# Bark-scale band edges over the 161-bin half spectrum (opus_fft 320)
_BAND_EDGES = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 17, 20, 24,
                        28, 34, 48, 80, 161])


class FeatureExtractor:
    """Stateful per-frame feature computation (10 ms hop, 20 ms window)."""

    def __init__(self):
        self.mem = np.zeros(FRAME_SIZE)
        self.pitch_mem = np.zeros(PITCH_MAX + FRAME_SIZE)
        self.window = np.sin(
            0.5 * np.pi * np.sin(
                0.5 * np.pi * (np.arange(WINDOW_SIZE) + 0.5) / WINDOW_SIZE) ** 2)

    def compute(self, frame: np.ndarray) -> np.ndarray:
        """frame: 160 samples at 16 kHz in [-1, 1]; returns 20 features."""
        assert len(frame) == FRAME_SIZE
        buf = np.concatenate([self.mem, frame])
        self.mem = frame.copy()
        spec = np.fft.rfft(buf * self.window)
        power = np.abs(spec) ** 2 + 1e-9
        bands = np.array([power[_BAND_EDGES[i]:_BAND_EDGES[i + 1]].sum()
                          for i in range(NB_BANDS)])
        log_e = np.log10(bands + 1e-7)
        # DCT-II cepstrum of the log band energies
        k = np.arange(NB_BANDS)
        dct = np.cos(np.pi / NB_BANDS * (k[:, None] + 0.5) * k[None, :])
        cepstrum = (log_e @ dct) / np.sqrt(NB_BANDS)
        cepstrum[0] -= 4.0  # mean removal like the reference

        # pitch: normalized autocorrelation over the recent 26 ms
        self.pitch_mem = np.concatenate([self.pitch_mem[FRAME_SIZE:], frame])
        x = self.pitch_mem
        cur = x[-FRAME_SIZE:]
        e0 = float(cur @ cur) + 1e-9
        best_p, best_c = PITCH_MIN, 0.0
        for lag in range(PITCH_MIN, PITCH_MAX, 2):
            past = x[-FRAME_SIZE - lag: -lag]
            c = float(cur @ past)
            if c > 0:
                nc = c / np.sqrt(e0 * (float(past @ past) + 1e-9))
                # small short-lag bias breaks octave ties
                if nc - 0.0003 * lag > best_c - 0.0003 * best_p:
                    best_c, best_p = nc, lag
        feats = np.zeros(NB_FEATURES)
        feats[:NB_BANDS] = cepstrum
        feats[NB_BANDS] = 0.01 * (best_p - 200)     # period encoding
        feats[NB_BANDS + 1] = best_c - 0.5          # voicing correlation
        return feats
