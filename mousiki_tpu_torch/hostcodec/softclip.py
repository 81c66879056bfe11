"""opus_pcm_soft_clip: cubic soft clipping with per-channel declick memory.

Parity: reference src/opus.rs (opus_pcm_soft_clip_impl:144; libopus float
semantics): per clipped region between zero crossings, apply
x + a*x^2 with `a` fitted so the region peak maps to ±1; carry `a` across
frames for continuity and ramp the special leading-edge case.
"""

from __future__ import annotations

import numpy as np


def opus_pcm_soft_clip(pcm: np.ndarray, declip_mem: np.ndarray) -> np.ndarray:
    """pcm: (N, C) float in any range; declip_mem: (C,) state (updated)."""
    x = np.clip(pcm, -2.0, 2.0).copy()
    N, C = x.shape
    for c in range(C):
        a = declip_mem[c]
        ch = x[:, c]
        # continue the previous frame's non-linearity up to the sign change
        for i in range(N):
            if ch[i] * a >= 0:
                break
            ch[i] = ch[i] + a * ch[i] * ch[i]
        curr = 0
        x0 = ch[0]
        while True:
            i = curr
            while i < N and -1.0 <= ch[i] <= 1.0:
                i += 1
            if i == N:
                a = 0.0
                break
            peak_pos = i
            start = end = i
            maxval = abs(ch[i])
            while start > 0 and ch[i] * ch[start - 1] >= 0:
                start -= 1
            while end < N and ch[i] * ch[end] >= 0:
                if abs(ch[end]) > maxval:
                    maxval = abs(ch[end])
                    peak_pos = end
                end += 1
            special = start == 0 and ch[i] * ch[0] >= 0
            a = (maxval - 1.0) / (maxval * maxval)
            a += a * 2.4e-7
            if ch[i] > 0:
                a = -a
            for j in range(start, end):
                ch[j] = ch[j] + a * ch[j] * ch[j]
            if special and peak_pos >= 2:
                offset = x0 - ch[0]
                delta = offset / peak_pos
                for j in range(curr, peak_pos):
                    offset -= delta
                    ch[j] = max(-1.0, min(1.0, ch[j] + offset))
            curr = end
            if curr == N:
                break
        declip_mem[c] = a
    return x
