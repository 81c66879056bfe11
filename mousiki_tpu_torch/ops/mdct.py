"""CELT MDCT as dense matrices: copies of `_twiddles`, `imdct_matrix` and
`mdct_matrix` from mousiki_tpu/ops/mdct.py (tests/test_torch_tables.py
checks them equal).

libopus implements the (I)MDCT as pre-rotate -> N/4 complex FFT ->
post-rotate; all of that is linear, so the (n2 x n2) basis is built once
per size and the hot path is a batched f32 matrix product.

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
    """Forward MDCT matrix F (n2 x n2) on the windowed, folded input
    (ops/_tables.fold_operator does the fold)."""
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
