"""Batched SILK 8/12/16 kHz -> 48 kHz up-resampler in PyTorch: port of
mousiki_tpu/ops/silk_resampler_jax.py.

Float formulation of the fixed-point IIR_FIR resampler. The whole step
(up2_HQ allpass chains, fractional FIR, state update) is linear in (input
frame, IIR state, FIR tail), so it is ONE matrix product against a probed
(L+14, M+14) operator, see Up48Plan.wmat. The operator is built once per
(frame length, rate) in float64 numpy by running the exact sequential
filter on basis vectors (`make_up48_plan`, copied as it is); at run time
there are no scans and no gathers.

The product runs in strict fp32 (TF32 is off, `_device.py`): the inputs
are at int16 scale, where TF32's 10-bit mantissa would cost tens of units.

State (S, 6+8+delay) mirrors the host resampler state (s_iir, s_fir tail,
delay_buf).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _device
from ..silk import tables as T

_FIR_ORDER = 8
# per internal rate (kHz): host inv_ratio_q16 (resampler_init arithmetic,
# up2x = 1 since 48k is not 2x the input) and the DEC delay-matrix entry
_RATE_PARAMS = {8: (21846, 0), 12: (32768, 4), 16: (43691, 7)}
_IN_KHZ = 16                    # default rate (back-compat)


def _i16(v):
    v = int(v) & 0xFFFF
    return v - 0x10000 if v & 0x8000 else v


# allpass coefficients as float (smulwb semantics: int16 coef / 2^16)
_C0 = [_i16(c) / 65536.0 for c in T.SILK_RESAMPLER_UP2_HQ_0]
_C1 = [_i16(c) / 65536.0 for c in T.SILK_RESAMPLER_UP2_HQ_1]
_FRAC = np.asarray(T.SILK_RESAMPLER_FRAC_FIR_12, np.float64) / 32768.0


class Up48Plan(NamedTuple):
    wmat: torch.Tensor     # (L+14, M+14) fused affine operator:
                           # [x | s_iir | s_fir] @ wmat -> [out | s_iir' |
                           # s_fir']
    n_out: int
    in_khz: int = 16       # internal rate (8/12/16 kHz -> 48 kHz)
    delay: int = 7         # host input_delay for this rate pair


def _allpass_np(u, s0, A, B, C, D):
    """Sequential reference of one allpass section (float64, batched)."""
    out = np.empty_like(u)
    t = s0.copy()
    for n in range(u.shape[1]):
        out[:, n] = C * t + D * u[:, n]
        t = A * t + B * u[:, n]
    return out, t


def _up2_np(x, s_iir):
    """x: (P, L) -> (P, 2L) via the two 3-section allpass chains (the
    exact sequential form, used only at plan-build time to probe the
    linear operator)."""
    new_s = [None] * 6
    outs = []
    for chain, coefs in enumerate((_C0, _C1)):
        u = x
        for sec in range(2):
            c = coefs[sec]
            u, last = _allpass_np(u, s_iir[:, chain * 3 + sec],
                                  -c, 1.0 + c, 1.0 - c, c)
            new_s[chain * 3 + sec] = last
        c2 = coefs[2]
        u, last = _allpass_np(u, s_iir[:, chain * 3 + 2],
                              -(1.0 + c2), 2.0 + c2, -c2, 1.0 + c2)
        new_s[chain * 3 + 2] = last
        outs.append(u)
    up = np.stack(outs, axis=2).reshape(x.shape[0], -1)
    return up, np.stack(new_s, axis=1)


def up48_operator(in_len: int, in_khz: int = 16):
    """The fused affine operator of `make_up48_plan` as float32 numpy:
    (W (L+14, M+14), n_out M, delay)."""
    inv_ratio, delay = _RATE_PARAMS[in_khz]
    batch = in_khz * 10  # RESAMPLER_MAX_BATCH_SIZE_MS * fs_in_khz
    segments = [min(in_khz, in_len)]
    rest = in_len - segments[0]
    while rest > 0:
        segments.append(min(rest, batch))
        rest -= segments[-1]
    bases, weights = [], []
    up_off = 0  # index of this batch's first upsampled sample in `prefixed`
    for n in segments:
        index_q16 = 0
        max_index = n << 17
        while index_q16 < max_index:
            ti = ((index_q16 & 0xFFFF) * 12) >> 16
            b = index_q16 >> 16
            bases.append(up_off + b)
            w = np.concatenate([_FRAC[ti], _FRAC[11 - ti][::-1]])
            weights.append(w)
            index_q16 += inv_ratio
        up_off += 2 * n
    n_up = _FIR_ORDER + 2 * in_len
    M = len(bases)
    G = np.zeros((n_up, M), np.float64)
    for m, (b, w) in enumerate(zip(bases, weights)):
        G[b:b + _FIR_ORDER, m] = w
    # probe the linear map (x, s_iir, s_fir) -> (out, s_iir', s_fir')
    L, P = in_len, in_len + 14
    X = np.zeros((P, L))
    X[:L] = np.eye(L)
    S_iir = np.zeros((P, 6))
    S_iir[L:L + 6] = np.eye(6)
    S_fir = np.zeros((P, _FIR_ORDER))
    S_fir[L + 6:] = np.eye(_FIR_ORDER)
    up, new_iir = _up2_np(X, S_iir)
    prefixed = np.concatenate([S_fir, up], axis=1)
    out = prefixed @ G
    W = np.concatenate([out, new_iir, prefixed[:, -_FIR_ORDER:]], axis=1)
    return W.astype(np.float32), M, delay


def make_up48_plan(in_len: int, in_khz: int, device) -> Up48Plan:
    """Build the fused affine operator for a fixed frame length at internal
    rate in_khz (8/12/16 kHz -> 48 kHz, host FUNC_IIR_FIR), on `device`.

    The host processes [delay_buf(in_khz) | input(in_len - delay)] as
    segments of at most 10 ms, resetting the Q16 phase accumulator per
    batch; source indices/phases are therefore static per frame length.
    The fractional-FIR gather matrix G is composed with the (linear) up2_HQ
    IIR chains by probing the sequential filter on L+14 basis vectors."""
    W, M, delay = up48_operator(in_len, in_khz)
    return Up48Plan(torch.as_tensor(W, device=_device.as_device(device)), M,
                    in_khz, delay)


class Up48State(NamedTuple):
    s_iir: torch.Tensor     # (S, 6)
    s_fir: torch.Tensor     # (S, 8) last upsampled samples
    delay: torch.Tensor     # (S, 16) host delay_buf (only first 16 used)


def init_up48_state(n_streams: int, device) -> Up48State:
    dev = _device.as_device(device)

    def z(n):
        return torch.zeros((n_streams, n), dtype=torch.float32, device=dev)

    return Up48State(z(6), z(8), z(_IN_KHZ))


def up48_step(x, state: Up48State, plan: Up48Plan):
    """x: (S, L) float input at plan.in_khz; returns the 48 kHz output
    (S, 48L/in_khz) and the new state.

    One matrix product against the probed affine operator (see
    Up48Plan.wmat). Mirrors the host resampler's delay handling: the first
    fs_in_khz samples come from [delay_buf | head of x]."""
    S, L = x.shape
    d = plan.delay
    x_delayed = torch.cat([state.delay[:, :d], x[:, :L - d]], dim=1)
    inp = torch.cat([x_delayed, state.s_iir, state.s_fir], dim=1)
    res = torch.matmul(inp, plan.wmat)
    M = plan.n_out
    new_delay = torch.zeros_like(state.delay)
    new_delay[:, :d] = x[:, L - d:]
    return res[:, :M], Up48State(res[:, M:M + 6], res[:, M + 6:], new_delay)
