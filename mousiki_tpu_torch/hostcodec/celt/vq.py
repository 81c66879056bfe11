"""PVQ shape decode: pulse decode -> spreading rotation -> normalisation.

Decode side of reference `src/celt/vq.rs` (alg_unquant:1013, exp_rotation:157,
renormalise_vector:1073, extract_collapse_mask:1164). Float semantics.
"""

from __future__ import annotations

import math

import numpy as np

from .cwrs import decode_pulses, encode_pulses

SPREAD_NONE = 0
SPREAD_LIGHT = 1
SPREAD_NORMAL = 2
SPREAD_AGGRESSIVE = 3

_SPREAD_FACTOR = [15, 10, 5]


def _exp_rotation1(X: np.ndarray, length: int, stride: int, c: float, s: float) -> None:
    ms = -s
    for i in range(length - stride):
        x1 = X[i]
        x2 = X[i + stride]
        X[i + stride] = c * x2 + s * x1
        X[i] = c * x1 + ms * x2
    for i in range(length - 2 * stride - 1, -1, -1):
        x1 = X[i]
        x2 = X[i + stride]
        X[i + stride] = c * x2 + s * x1
        X[i] = c * x1 + ms * x2


def exp_rotation(X: np.ndarray, length: int, direction: int, stride: int,
                 K: int, spread: int) -> None:
    if 2 * K >= length or spread == SPREAD_NONE:
        return
    factor = _SPREAD_FACTOR[spread - 1]
    gain = length / (length + factor * K)
    theta = 0.5 * gain * gain
    c = math.cos(0.5 * math.pi * theta)
    s = math.cos(0.5 * math.pi * (1 - theta))
    stride2 = 0
    if length >= 8 * stride:
        stride2 = 1
        while (stride2 * stride2 + stride2) * stride + (stride >> 2) < length:
            stride2 += 1
    length //= stride
    for i in range(stride):
        seg = X[i * length:(i + 1) * length]
        if direction < 0:
            if stride2:
                _exp_rotation1(seg, length, stride2, s, c)
            _exp_rotation1(seg, length, 1, c, s)
        else:
            _exp_rotation1(seg, length, 1, c, -s)
            if stride2:
                _exp_rotation1(seg, length, stride2, s, -c)


def extract_collapse_mask(iy, N: int, B: int) -> int:
    if B <= 1:
        return 1
    N0 = N // B
    mask = 0
    for i in range(B):
        tmp = 0
        for j in range(N0):
            tmp |= iy[i * N0 + j]
        mask |= (tmp != 0) << i
    return mask


def renormalise_vector(X: np.ndarray, N: int, gain: float) -> None:
    E = 1e-15 + float(np.dot(X[:N], X[:N]))
    g = gain / math.sqrt(E)
    X[:N] *= g


def alg_unquant_from_iy(X: np.ndarray, iy, N: int, K: int, spread: int,
                        B: int, gain: float) -> int:
    """Signal half of alg_unquant: pulse vector -> rotated unit-norm shape.

    Pure function of (iy, N, K, spread, B, gain) — no entropy coder. This is
    the piece the TPU band-plan executor runs on device; kept host-side here
    for the reference decoder and the plan recorder.
    """
    ryy = float(sum(v * v for v in iy))
    g = gain / math.sqrt(ryy)
    X[:N] = np.asarray(iy, np.float64) * g
    exp_rotation(X, N, -1, B, K, spread)
    return extract_collapse_mask(iy, N, B)


def alg_unquant(X: np.ndarray, N: int, K: int, spread: int, B: int,
                dec, gain: float) -> int:
    """Decode the unit-norm band shape into X[:N]; returns the collapse mask."""
    assert K > 0 and N > 1
    iy = decode_pulses(dec, N, K)
    return alg_unquant_from_iy(X, iy, N, K, spread, B, gain)


def alg_quant(X: np.ndarray, N: int, K: int, spread: int, B: int,
              enc, gain: float, resynth: bool) -> int:
    """Encode the band shape (PVQ search + pulse encode); mirrors alg_unquant."""
    assert K > 0 and N > 1
    x = X[:N].copy()
    exp_rotation(x, N, 1, B, K, spread)
    iy = op_pvq_search(x, N, K)
    encode_pulses(enc, iy)
    if resynth:
        ryy = float(sum(v * v for v in iy))
        g = gain / math.sqrt(ryy)
        X[:N] = np.asarray(iy, np.float64) * g
        exp_rotation(X, N, -1, B, K, spread)
    return extract_collapse_mask(iy, N, B)


def op_pvq_search(x: np.ndarray, N: int, K: int) -> list:
    """Greedy PVQ search (parity with vq.rs op_pvq_search:393 float path)."""
    X = np.abs(x[:N])
    signs = np.where(x[:N] < 0, -1, 1)
    y = np.zeros(N, np.int64)
    pulses_left = K
    xy = 0.0
    yy = 0.0
    # Pre-projection when K is large enough to make it worthwhile
    if K > (N >> 1):
        sum_x = float(np.sum(X))
        if sum_x > 1e-15:
            rcp = (K + 0.8) / sum_x
            y = np.floor(rcp * X).astype(np.int64)
            pulses_left = K - int(np.sum(y))
            xy = float(np.dot(X, y))
            yy = float(np.dot(y.astype(np.float64), y.astype(np.float64)))
    if pulses_left > N + 3:
        y[0] += pulses_left
        xy = float(np.dot(X, y))
        yy = float(np.dot(y.astype(np.float64), y.astype(np.float64)))
        pulses_left = 0
    for _ in range(pulses_left):
        # choose j maximizing (xy + X[j])^2 / (yy + 2*y[j] + 1)
        num = (xy + X) ** 2
        den = yy + 2.0 * y + 1.0
        j = int(np.argmax(num / den))
        xy += X[j]
        yy += 2.0 * y[j] + 1.0
        y[j] += 1
    return [int(s * v) for s, v in zip(signs, y)]
