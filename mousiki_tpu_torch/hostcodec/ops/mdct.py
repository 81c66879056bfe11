"""CELT MDCT as dense matrices — the TPU-native formulation.

libopus implements the (I)MDCT as pre-rotate -> N/4 complex FFT ->
post-rotate (+ TDAC window mirror).  All of that is linear, so on TPU we
precompute the equivalent (n2 x n2) basis matrix once per shift and run the
hot path as a *batched matmul on the MXU* over (streams x channels x
blocks).  The TDAC mirror/overlap is a separate vectorized combine (see
`celt_overlap_add`), derived from the block recurrence in reference
`src/celt/mdct.rs:362` (clt_mdct_backward) so that all B sub-blocks can be
computed in parallel instead of sequentially sharing an output buffer.

Conventions (matching libopus float build):
  * mode FFT length N = 2*n2, twiddles t0[i]=cos(2*pi*(i+1/8)/N),
    t1[i]=sin(...), i < n4.
  * forward includes the 1/n4 FFT scale; backward has no scale.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def _twiddles(n2: int) -> tuple[np.ndarray, np.ndarray]:
    n = 2 * n2
    n4 = n2 // 2
    i = np.arange(n4)
    ang = 2.0 * np.pi * (i + 0.125) / n
    # libopus mdct_init: trig[i] = cos(ang), trig[N4+i] = -sin(ang)
    return np.cos(ang), -np.sin(ang)


@lru_cache(maxsize=8)
def imdct_matrix(n2: int) -> np.ndarray:
    """Matrix M (n2 x n2): raw = X @ M.T gives the pre-mirror IMDCT output.

    raw[m] corresponds to the FFT-area sample at local offset overlap/2 + m
    of clt_mdct_backward's output buffer.
    """
    n4 = n2 // 2
    c, s = _twiddles(n2)
    X = np.eye(n2)
    # pre-rotate: p_i = (X[n2-1-2i]*c_i + X[2i]*s_i) + 1j*(X[2i]*c_i - X[n2-1-2i]*s_i)
    x_even = X[:, 0::2]            # X[2i], columns i
    x_odd = X[:, ::-1][:, 0::2]    # X[n2-1-2i]
    pre = (x_odd * c + x_even * s) + 1j * (x_even * c - x_odd * s)
    # inverse FFT without the 1/n4 normalisation
    f = np.fft.ifft(pre, axis=1) * n4
    yr = f.real * c + f.imag * s
    yi = f.real * s - f.imag * c
    raw = np.empty((n2, n2))
    raw[:, 0::2] = yr
    raw[:, 1::2] = yi[:, ::-1]
    return raw.T.copy()  # (n2_out, n2_in); apply as M @ X or X @ M.T


@lru_cache(maxsize=8)
def mdct_matrix(n2: int) -> np.ndarray:
    """Forward MDCT matrix F (n2 x 2*n2) on the *unwindowed, unfolded* input.

    clt_mdct_forward folds a (n2 + overlap)-sample windowed input into n2
    values, then rotates/FFTs.  Folding depends on overlap; we expose the
    pure 2*n2-point transform here and do the windowed fold separately
    (see `mdct_fold`), keeping both as matmul-friendly linear ops.
    Composition: out = F_core @ fold(input) where F_core is (n2 x n2).
    """
    n4 = n2 // 2
    c, s = _twiddles(n2)
    E = np.eye(n2)
    # pre-rotate forward on folded input f: for i: re = f[2i], im = f[2i+1]
    # yr = re*c - im*s ; yi = im*c + re*s ; scaled by 1/n4
    re = E[:, 0::2]
    im = E[:, 1::2]
    pre = ((re * c - im * s) + 1j * (im * c + re * s)) / n4
    F = np.fft.fft(pre, axis=1)
    # post-rotate: yr_i = f_i.im*s_i - f_i.re*c_i ; yi_i = f_i.re*s_i + f_i.im*c_i
    yr = F.imag * s - F.real * c
    yi = F.real * s + F.imag * c
    out = np.empty((n2, n2))
    out[:, 0::2] = yr          # out[2i*stride] = yr_i
    out[:, ::-1][:, 0::2] = yi  # out[(n2-1-2i)*stride] = yi_i
    return out.T.copy()


def mdct_fold(x: np.ndarray, window: np.ndarray, n2: int) -> np.ndarray:
    """Windowed TDAC fold: (..., n2 + overlap) -> (..., n2) (forward MDCT input).

    Mirrors fold_input in reference src/celt/mdct.rs:10. `x` spans the
    2*n2-sample MDCT frame whose flat centre is implicit: callers pass the
    n2+overlap window of which [overlap/2, n2+overlap/2) is the frame body.
    """
    overlap = len(window)
    n4 = n2 // 2
    quarter = (overlap + 3) >> 2
    half = overlap >> 1
    out = np.zeros(x.shape[:-1] + (n2,), x.dtype)
    yp = 0
    xp1 = half
    xp2 = half + n2 - 1
    wp1 = half
    wp2 = half - 1
    for _ in range(quarter):
        a = x[..., xp1 + n2]
        b = x[..., xp2]
        cc = x[..., xp1]
        d = x[..., xp2 - n2]
        w1 = window[wp1]
        w2 = window[wp2]
        out[..., yp] = a * w2 + b * w1
        out[..., yp + 1] = cc * w1 - d * w2
        yp += 2
        xp1 += 2
        xp2 -= 2
        wp1 += 2
        wp2 -= 2
    for _ in range(quarter, n4 - quarter):
        out[..., yp] = x[..., xp2]
        out[..., yp + 1] = x[..., xp1]
        yp += 2
        xp1 += 2
        xp2 -= 2
    wp1 = 0
    wp2 = overlap - 1
    for _ in range(n4 - quarter, n4):
        a = x[..., xp1 - n2]
        b = x[..., xp2]
        cc = x[..., xp1]
        d = x[..., xp2 + n2]
        w1 = window[wp1]
        w2 = window[wp2]
        out[..., yp] = -a * w1 + b * w2
        out[..., yp + 1] = cc * w2 + d * w1
        yp += 2
        xp1 += 2
        xp2 -= 2
        wp1 += 2
        wp2 -= 2
    return out


def celt_overlap_add(raw: np.ndarray, prev_tail: np.ndarray,
                     window: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Combine per-block raw IMDCT outputs into the frame's PCM.

    raw: (..., B, n2) per-block pre-mirror outputs.
    prev_tail: (..., overlap//2) raw tail stored from the previous frame.
    Returns (out (..., N), new_tail (..., overlap//2)) with N = B*n2.

    Derivation: block b's buffer locally holds prev raw content in
    [0, ov/2) and fresh raw in [ov/2, ov/2+n2); the TDAC mirror combines
    out[r] = w[ov-1-r]*T[abs] - w[r]*T[mirror] for r < ov/2 and
    out[r] = w[r]*T[abs] + w[ov-1-r]*T[mirror] for ov/2 <= r < ov,
    where T is the concatenated raw stream offset by ov/2.
    """
    ov = window.shape[-1]
    half = ov // 2
    B, n2 = raw.shape[-2], raw.shape[-1]
    N = B * n2
    lead = raw.shape[:-2]
    T = np.concatenate([prev_tail, raw.reshape(lead + (N,))], axis=-1)
    # T[j] is the raw value at absolute output position j - half + half = j;
    # i.e. absolute position p maps to T index p (prev_tail covers [0, half)).
    out = T[..., :N].copy()
    # window region of each block
    for b in range(B):
        g = b * n2
        r = np.arange(half)
        j = g + r
        i2 = ov - 1 - r
        out[..., j] = window[i2] * T[..., j] - window[r] * T[..., g + i2]
        q = np.arange(half, ov)
        jq = g + q
        iq = ov - 1 - q
        out[..., jq] = window[q] * T[..., jq] + window[iq] * T[..., g + iq]
    new_tail = T[..., N: N + half].copy()
    return out, new_tail
