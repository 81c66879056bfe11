"""Seeded frames for the device SILK synthesis (the port's
ops/silk_synthesis.silk_synthesis_step): parameters at any SILK rate that
cover the kernel's cases beyond what the golden streams reach (they hold
no 12 kHz stream and few voiced frames). Shared by the port's tests and
chip_smoke.py; it is not part of any installed package.

Each stream of a batch plays one role of ROLES, every frame: voiced at the
lowest lag the mixed decoder's lane passes (18) and at the rate's largest
(18 ms), lags that change at every subframe (at 12 kHz a chunk of 8
straddles subframes 0-1 and 2-3 and takes the earlier one's lag), lags
that read inside the chunk being written or far before the plane (every
index clamped to 0), unvoiced lanes with a lag of 0, and interpolated
halves on, off and alternating. The LPC is stable (reflection
coefficients that shrink with the order, as speech's do) and the LTP
taps sum below 0.9, so the output stays at the decoder's int16 scale
over many carried frames.
"""

from __future__ import annotations

import numpy as np
import torch

from mousiki_tpu_torch.ops.silk_synthesis import SilkFrameParams

NB_SUBFR = 4
# stream role -> (voiced each frame, interp each frame, lags of frame f)
ROLES = (
    "voiced_lag18", "voiced_lag_max_interp", "voiced_lags_per_subframe",
    "unvoiced_interp", "unvoiced", "voiced_random", "voiced_every_other",
    "voiced_lag4_or_far",
)


def step_kwargs(khz: int) -> dict:
    """silk_synthesis_step's keywords at `khz` (20 ms frames)."""
    return {"nb_subfr": NB_SUBFR, "subfr_len": 5 * khz}


def _lpc(rng, n: int) -> np.ndarray:
    """n stable order-16 predictors a (y[n] = x[n] + sum a_j y[n-1-j]) from
    reflection coefficients below 0.9 * 0.75^i in magnitude, quantized to
    Q12."""
    out = np.zeros((n, 16), np.float64)
    for i in range(n):
        c = np.zeros(0)
        for k in rng.uniform(-0.9, 0.9, 16) * 0.75 ** np.arange(16):
            c = np.concatenate([c + k * c[::-1], [k]])
        out[i] = -c
    return (np.round(out * 4096) / 4096).astype(np.float32)


def _lags(role: str, f: int, khz: int, rng) -> list:
    top = 18 * khz
    if role == "voiced_lag18":
        return [18] * NB_SUBFR
    if role == "voiced_lag_max_interp":
        return [top] * NB_SUBFR
    if role == "voiced_lags_per_subframe":
        lags = [18 + (top - 18) * k // 3 for k in range(NB_SUBFR)]
        return lags if f % 2 == 0 else lags[::-1]
    if role == "voiced_lag4_or_far":
        return [4] * NB_SUBFR if f % 2 == 0 else [50 * top] * NB_SUBFR
    if role.startswith("unvoiced"):
        return [0] * NB_SUBFR
    return list(rng.integers(18, top + 1, NB_SUBFR))


def frames(rng, khz: int, n_frames: int, n_streams: int = len(ROLES)
           ) -> list:
    """n_frames frames of n_streams streams (stream s plays ROLES[s %
    len(ROLES)]): a list of dicts of numpy arrays, the fields of
    SilkFrameParams."""
    L = 20 * khz
    out = []
    for f in range(n_frames):
        roles = [ROLES[s % len(ROLES)] for s in range(n_streams)]
        voiced = np.array([not r.startswith("unvoiced")
                           and (r != "voiced_every_other" or f % 2 == 0)
                           for r in roles])
        interp = np.array([
            {"voiced_lag_max_interp": True, "unvoiced_interp": True,
             "voiced_lag18": False, "unvoiced": False}.get(r, f % 2 == 1)
            if r != "voiced_random" else bool(rng.random() < 0.5)
            for r in roles])
        taps = rng.uniform(0.0, 1.0, (n_streams, NB_SUBFR, 5))
        taps *= rng.uniform(0.2, 0.9, (n_streams, NB_SUBFR, 1)) \
            / taps.sum(-1, keepdims=True)
        out.append({
            "exc": (np.round(rng.standard_normal((n_streams, L)) * 0.6
                             * 16384) / 16384).astype(np.float32),
            "a": _lpc(rng, 2 * n_streams).reshape(n_streams, 2, 16),
            "b": (np.round(taps * 16384) / 16384).astype(np.float32),
            "pitch_l": np.array([_lags(r, f, khz, rng) for r in roles],
                                np.int32),
            "gains": np.round(rng.uniform(100, 2000, (n_streams, NB_SUBFR))
                              ).astype(np.float32),
            "voiced": voiced,
            "ltp_scale": rng.choice(np.array([1.0, 0.95, 0.5], np.float32),
                                    n_streams),
            "interp": interp,
        })
    return out


def params(frame: dict, device="cpu") -> SilkFrameParams:
    """The port's SilkFrameParams of one frame of `frames`."""
    return SilkFrameParams(**{k: torch.as_tensor(v, device=device)
                              for k, v in frame.items()})
