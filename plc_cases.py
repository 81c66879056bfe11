"""Seeded rows for the CELT concealment's row work (the port's
ops/plc.plc_rows): decode histories, loss flags, pitches and carried LPCs
that cover the kernel's cases beyond what the golden streams reach, and an
independent float64 LPC fit to hold a float32 fit to. Shared by the
port's tests and chip_smoke.py; it is not part of any installed package.
"""

from __future__ import annotations

import numpy as np

from mousiki_tpu_torch.ops.plc import HIST, ORDER

# stream -> (name, history, pitch, lost, first, carried LPC); a carried
# LPC (a second loss: fade 0.8) is (its first taps), the rest zero
ROWS = (
    ("white_noise_p100", "noise", 100, True, True, None),
    ("ar2_p720", "ar2", 720, True, True, None),        # 2 * pitch > HIST
    ("zeros_p300", "zeros", 300, True, True, None),
    ("saturating_history_p256", "loud", 256, True, True, None),
    ("ar2_p512_second_loss", "ar2", 512, True, False, (1.3, -0.6)),
    ("noise_not_lost", "noise", 200, False, False, None),
    ("saturating_synthesis_p100", "noise", 100, True, False, (-1.05,)),
    ("zeros_not_lost", "zeros", 400, False, False, None),
)


def ar2(rng, shape, radius: float = 0.77, scale: float = 300.0):
    """A seeded AR(2) process with poles at `radius` (a well-conditioned
    autocorrelation), at the decoder's int16-scale amplitude."""
    e = rng.standard_normal((*shape, HIST + 200))
    x = np.zeros_like(e)
    c1, c2 = 2 * radius * np.cos(0.9), -radius * radius
    for i in range(2, e.shape[-1]):
        x[..., i] = c1 * x[..., i - 1] + c2 * x[..., i - 2] + e[..., i]
    return (x[..., 200:] * scale).astype(np.float32)


def plc_rows(rng, channels: int = 2) -> dict:
    """The inputs of plc_rows for the streams of ROWS: "hist" (S, C, HIST)
    float32, "first" / "lost" (S,) bool, "pitch" (S,) int32, "fade" (S,)
    float32 (0.8 on a second loss), "lpc_prev" (S, C, ORDER) float32, and
    "names"."""
    S, C = len(ROWS), channels
    hist = np.zeros((S, C, HIST), np.float32)
    lpc_prev = np.zeros((S, C, ORDER), np.float32)
    for s, (_, kind, _, _, _, taps) in enumerate(ROWS):
        if kind == "noise":
            hist[s] = rng.standard_normal((C, HIST)) * 1000
        elif kind == "ar2":
            hist[s] = ar2(rng, (C,))
        elif kind == "loud":
            # near full scale, clipped as the decoder's output is
            hist[s] = np.clip(rng.standard_normal((C, HIST)) * 40000,
                              -65536, 65536)
        if taps is not None:
            lpc_prev[s, :, :len(taps)] = taps
    first = np.array([r[4] for r in ROWS])
    return {
        "names": [r[0] for r in ROWS],
        "hist": hist,
        "pitch": np.array([r[2] for r in ROWS], np.int32),
        "lost": np.array([r[3] for r in ROWS]),
        "first": first,
        "fade": np.where(first, 1.0, 0.8).astype(np.float32),
        "lpc_prev": lpc_prev,
    }


def lpc_fit_f64(han, lagw, hist):
    """plc_jax._lpc_fit in float64 numpy: windowed autocorrelation with
    the noise floor and lag window, Levinson with the +-0.98 clamp, then
    the 0.99 bandwidth expansion."""
    xw = np.asarray(hist, np.float64) * np.asarray(han, np.float64)
    n = xw.shape[-1]
    ac = np.stack([np.sum(xw[..., :n - i] * xw[..., i:], -1)
                   for i in range(ORDER + 1)], -1)
    ac[..., 0] = ac[..., 0] * 1.0001 + 1e-9 * n
    ac[..., 1:] *= np.asarray(lagw, np.float64)
    a = np.zeros(ac.shape[:-1] + (ORDER,))
    err = ac[..., 0].copy()
    for i in range(ORDER):
        # acc = ac[i+1] - sum_{j<i} a[j] * ac[i-j]
        acc = ac[..., i + 1] - np.sum(a[..., :i] * ac[..., i:0:-1], -1)
        k = np.clip(acc / np.maximum(err, 1e-12), -0.98, 0.98)
        a[..., :i] = a[..., :i] - k[..., None] * a[..., i - 1::-1][..., :i]
        a[..., i] = k
        err = err * (1 - k * k)
    return a * 0.99 ** np.arange(1, ORDER + 1)
