"""Numpy constants of the device half, copied from the JAX modules.

The port imports nothing of the JAX package, so these are exact copies
of its numpy helpers (tests/test_torch_tables.py checks each against its
original):

  * `u_table`, `lcg_jump`            <- band_exec_jax._u_table, _lcg_jump
  * `combo_mats`, `plan_combo_mats_np`
                                     <- band_exec_jax._combo_mats,
                                        _plan_combo_mats_np
  * `bin_band_map`, `COMB_GAINS`     <- synthesis_jax._bin_band_map,
                                        _COMB_GAINS
  * `fold_operator`                  <- encode_front_jax._fold_operator
                                        (returns numpy arrays here)
  * `TRANSIENT_INV_TABLE`            <- celt/encoder._TRANSIENT_INV_TABLE

and the executor's torch helpers over the LCG jump tables (`lcg_tensors`,
`lcg_at`, `as_i32`), used by the band assembly, the anti-collapse and the
lockstep plan emission.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..celt.modes import MODE
from ..celt.plan import _post_transforms, _pre_transforms, combos_for_m

SPREAD_FACTOR = np.array([44, 15, 10, 5], np.float32)  # [unused, light, normal, aggr]

U_N = 210
U_K = 160

LCG_A = 1664525
LCG_C = 1013904223
LCG_MAX = 2048

COMB_GAINS = np.array([
    [0.3066406250, 0.2170410156, 0.1296386719],
    [0.4638671875, 0.2680664062, 0.0],
    [0.7998046875, 0.1000976562, 0.0],
], np.float32)

# inverse masking ratio table of the encoder's transient analysis
TRANSIENT_INV_TABLE = np.array([
    255, 255, 156, 110, 86, 70, 59, 51, 45, 40, 37, 33, 31, 28, 26, 25, 23,
    22, 21, 20, 19, 18, 17, 16, 16, 15, 15, 14, 13, 13, 12, 12, 12, 12, 11,
    11, 11, 10, 10, 10, 9, 9, 9, 9, 9, 9, 8, 8, 8, 8, 8, 7, 7, 7, 7, 7, 7,
    6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 5, 5, 5, 5, 5, 5, 5, 5,
    5, 5, 5, 5, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4,
    4, 4, 4, 4, 4, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 2,
], np.float32)


@lru_cache(maxsize=1)
def u_table() -> np.ndarray:
    """Saturated u32 U(n,k) table, (U_N, U_K); same build as native host."""
    tab = np.zeros((U_K, U_N), np.uint64)
    for k in range(1, U_K):
        tab[k, 1] = 1
        if U_N > 2:
            tab[k, 2] = 2 * k - 1
        for n in range(3, U_N):
            if k == 1:
                tab[k, n] = 1
            else:
                v = tab[k - 1, n] + tab[k - 1, n - 1] + tab[k, n - 1]
                tab[k, n] = min(v, np.uint64(0x1FFFFFFFF))
    full = np.empty((U_N, U_K), np.uint32)
    for n in range(U_N):
        for k in range(U_K):
            v = tab[min(n, k), max(n, k)] if min(n, k) < U_K else 0x1FFFFFFFF
            full[n, k] = min(int(v), 0xFFFFFFFF)
    full[:, 0] = 0
    return full


@lru_cache(maxsize=1)
def lcg_jump() -> tuple[np.ndarray, np.ndarray]:
    """A[j], C[j] with lcg^j(s) = A[j]*s + C[j]  (mod 2^32)."""
    A = np.empty(LCG_MAX, np.uint32)
    Cc = np.empty(LCG_MAX, np.uint32)
    a, c = 1, 0
    for j in range(LCG_MAX):
        A[j] = a
        Cc[j] = c
        a = (a * LCG_A) & 0xFFFFFFFF
        c = (c * LCG_A + LCG_C) & 0xFFFFFFFF
    return A, Cc


@lru_cache(maxsize=None)
def lcg_tensors(device: torch.device):
    """lcg_jump()'s A and C as int64 tensors on `device`."""
    A, Cc = lcg_jump()
    return (torch.as_tensor(A.astype(np.int64), device=device),
            torch.as_tensor(Cc.astype(np.int64), device=device))


def lcg_at(A_J, C_J, d, seed):
    """lcg^d(seed) mod 2^32 for u32 `seed` (int64 tensors). The 32x32-bit
    product is split on seed's 16-bit halves so no product reaches 2^48."""
    a = A_J[d]
    lo = seed & 0xFFFF
    hi = seed >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16) + C_J[d]) & 0xFFFFFFFF


def as_i32(u):
    """Signed reinterpretation of u32 values held in int64."""
    return u - ((u >> 31) << 32)


@lru_cache(maxsize=None)
def combo_mats(n_band: int, M: int):
    """(pre, post) stacks of (n_combos, N, N) f32 linear operators."""
    combos = combos_for_m(M)
    pre = np.zeros((len(combos), n_band, n_band), np.float32)
    post = np.zeros_like(pre)
    for ci, (b0, tf) in enumerate(combos):
        eye = np.eye(n_band, dtype=np.float64)
        try:
            pm = np.empty((n_band, n_band))
            qm = np.empty((n_band, n_band))
            for col in range(n_band):
                v = eye[:, col].copy()
                _pre_transforms(v, n_band, b0, tf)
                pm[:, col] = v
                v = eye[:, col].copy()
                _post_transforms(v, n_band, b0, tf)
                qm[:, col] = v
            pre[ci] = pm
            post[ci] = qm
        except Exception:
            # a combo the transforms reject stays the identity, as in the
            # reference (such combos never occur in a valid plan)
            pre[ci] = np.eye(n_band)
            post[ci] = np.eye(n_band)
    return pre, post


@lru_cache(maxsize=None)
def plan_combo_mats_np(frame: int):
    """(21, NC, NBMAX, NBMAX) f32 pre/post combo stacks, identity-padded."""
    eb = [int(v) for v in MODE.ebands]
    M = frame // MODE.short_mdct_size
    nbmax = 22 * M
    nc = len(combos_for_m(M))
    pre_all = np.zeros((21, nc, nbmax, nbmax), np.float32)
    post_all = np.zeros_like(pre_all)
    eye = np.eye(nbmax, dtype=np.float32)
    for i in range(21):
        n_b = M * (eb[i + 1] - eb[i])
        pre_all[i] = eye
        post_all[i] = eye
        if n_b > 1:
            pre, post = combo_mats(n_b, M)
            pre_all[i, :, :n_b, :n_b] = pre
            post_all[i, :, :n_b, :n_b] = post
    return pre_all, post_all


def bin_band_map(mode, M):
    """bin index -> band index (int32, len M*shortMdctSize; 21 past end)."""
    nbins = M * mode.short_mdct_size
    out = np.full(nbins, mode.num_ebands, np.int32)
    for b in range(mode.num_ebands):
        out[M * mode.ebands[b]: M * mode.ebands[b + 1]] = b
    return out


def fold_operator(n2: int, window: np.ndarray):
    """The TDAC fold (ops/mdct.mdct_fold) as gather indices + two gain
    vectors: out = g1 * x[i1] + g2 * x[i2]."""
    overlap = len(window)
    n4 = n2 // 2
    quarter = (overlap + 3) >> 2
    half = overlap >> 1
    i1 = np.zeros(n2, np.int32)
    i2 = np.zeros(n2, np.int32)
    g1 = np.zeros(n2, np.float32)
    g2 = np.zeros(n2, np.float32)
    yp, xp1, xp2, wp1, wp2 = 0, half, half + n2 - 1, half, half - 1
    for _ in range(quarter):
        # out[yp] = x[xp1+n2]*w2 + x[xp2]*w1 ; out[yp+1] = x[xp1]*w1 - x[xp2-n2]*w2
        i1[yp], g1[yp] = xp1 + n2, window[wp2]
        i2[yp], g2[yp] = xp2, window[wp1]
        i1[yp + 1], g1[yp + 1] = xp1, window[wp1]
        i2[yp + 1], g2[yp + 1] = xp2 - n2, -window[wp2]
        yp += 2
        xp1 += 2
        xp2 -= 2
        wp1 += 2
        wp2 -= 2
    for _ in range(quarter, n4 - quarter):
        i1[yp], g1[yp] = xp2, 1.0
        i2[yp], g2[yp] = 0, 0.0
        i1[yp + 1], g1[yp + 1] = xp1, 1.0
        i2[yp + 1], g2[yp + 1] = 0, 0.0
        yp += 2
        xp1 += 2
        xp2 -= 2
    wp1, wp2 = 0, overlap - 1
    for _ in range(n4 - quarter, n4):
        i1[yp], g1[yp] = xp1 - n2, -window[wp1]
        i2[yp], g2[yp] = xp2, window[wp2]
        i1[yp + 1], g1[yp + 1] = xp1, window[wp2]
        i2[yp + 1], g2[yp + 1] = xp2 + n2, window[wp1]
        yp += 2
        xp1 += 2
        xp2 -= 2
        wp1 += 2
        wp2 -= 2
    return i1, i2, g1, g2
