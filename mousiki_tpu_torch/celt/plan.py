"""The quant_band pre/post transforms behind the band executor's combo
operators (ops/_tables.combo_mats), and the plan tier layout.

Copies, checked equal by tests/test_torch_tables.py:

  * `_pre_transforms`, `_post_transforms`   <- mousiki_tpu/celt/plan.py
  * `haar1`, `_interleave_hadamard`,
    `_deinterleave_hadamard`, `_ORDERY`     <- mousiki_tpu/celt/bands.py
  * `TIERS`, `combos_for_m`                 <- mousiki_tpu/celt/plan_pack.py
"""

from __future__ import annotations

import numpy as np

# tier capacities: (max leaf n, number of slots); sized so even 510 kbps
# stereo frames (max splits, ~270 leaves) pack without direct fallback
TIERS = ((16, 224), (48, 48), (176, 16))


def combos_for_m(M: int):
    """Transform combos (b0, tf_change); id 0 = identity (b0 == 1,
    tf == 0). B at a quant_band call is always 1 (long blocks) or M
    (short blocks)."""
    out = [(1, 0)]
    for b0 in dict.fromkeys((1, M)):
        for tf in (-3, -2, -1, 0, 1, 2, 3):
            if (b0, tf) != (1, 0):
                out.append((b0, tf))
    return out


_ORDERY = {2: [1, 0],
           4: [3, 0, 2, 1],
           8: [7, 0, 4, 3, 6, 1, 5, 2],
           16: [15, 0, 8, 7, 12, 3, 11, 4, 14, 1, 9, 6, 13, 2, 10, 5]}


def haar1(X: np.ndarray, n0: int, stride: int) -> None:
    n0 >>= 1
    s = 0.70710678
    for i in range(stride):
        idx1 = i + stride * 2 * np.arange(n0)
        idx2 = idx1 + stride
        t1 = s * X[idx1]
        t2 = s * X[idx2]
        X[idx1] = t1 + t2
        X[idx2] = t1 - t2


def _interleave_hadamard(X: np.ndarray, n0: int, stride: int,
                         hadamard: bool) -> None:
    N = n0 * stride
    V = X[:N]
    tmp = np.empty(N, X.dtype)
    if hadamard:
        ordery = _ORDERY[stride]
        for i in range(stride):
            tmp[i::stride] = V[ordery[i] * n0: (ordery[i] + 1) * n0]
    else:
        for i in range(stride):
            tmp[i::stride] = V[i * n0: (i + 1) * n0]
    X[:N] = tmp


def _deinterleave_hadamard(X: np.ndarray, n0: int, stride: int,
                           hadamard: bool) -> None:
    N = n0 * stride
    V = X[:N]
    tmp = np.empty(N, X.dtype)
    if hadamard:
        ordery = _ORDERY[stride]
        for i in range(stride):
            tmp[ordery[i] * n0: (ordery[i] + 1) * n0] = V[i::stride]
    else:
        for i in range(stride):
            tmp[i * n0: (i + 1) * n0] = V[i::stride]
    X[:N] = tmp


def _pre_transforms(lb: np.ndarray, N: int, B: int, tf_change: int) -> None:
    """Replay quant_band's lowband pre-transform (haar + deinterleave)."""
    N_B = N // B
    B0 = B
    long_blocks = B0 == 1
    recombine = tf_change if tf_change > 0 else 0
    for k in range(recombine):
        haar1(lb, N >> k, 1 << k)
    B >>= recombine
    N_B <<= recombine
    tf = tf_change
    while (N_B & 1) == 0 and tf < 0:
        haar1(lb, N_B, B)
        B <<= 1
        N_B >>= 1
        tf += 1
    if B > 1:
        _deinterleave_hadamard(lb, N_B >> recombine, B << recombine,
                               long_blocks)


def _post_transforms(X: np.ndarray, N: int, B_entry: int,
                     tf_change: int) -> None:
    """Replay quant_band's resynthesis transform (interleave + haar)."""
    N_B = N // B_entry
    long_blocks = B_entry == 1
    recombine = tf_change if tf_change > 0 else 0
    B = B_entry >> recombine
    N_B <<= recombine
    time_divide = 0
    tf = tf_change
    while (N_B & 1) == 0 and tf < 0:
        B <<= 1
        N_B >>= 1
        time_divide += 1
        tf += 1
    B0 = B
    N_B0 = N_B
    if B0 > 1:
        _interleave_hadamard(X, N_B >> recombine, B0 << recombine, long_blocks)
    N_B = N_B0
    B = B0
    for _ in range(time_divide):
        B >>= 1
        N_B <<= 1
        haar1(X, N_B, B)
    for k in range(recombine):
        haar1(X, N >> k, 1 << k)
