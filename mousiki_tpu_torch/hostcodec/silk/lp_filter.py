"""Variable cut-off low-pass for bandwidth transitions (silk_LP_state).

Parity: reference `src/silk/lp_variable_cutoff.rs` and
`src/silk/biquad_alt.rs` — an elliptic biquad whose normalized cut-off
interpolates between five precomputed Q28 coefficient sets (0.95 down to
0.35) over a 5.12 s ramp, smoothing NB/MB/WB switches. The encoder runs
it on the internal-rate input while a down-switch ramp is in progress
(encode_frame.rs:242); mode > 0 widens (after an up-switch), mode < 0
narrows (preparing a down-switch).
"""

from __future__ import annotations

import numpy as np

from .fixed_math import i32, sat16, smlawb, smulwb

TRANSITION_INT_NUM = 5
TRANSITION_FRAMES = 5120 // 20
_STEPS = TRANSITION_FRAMES // (TRANSITION_INT_NUM - 1)

TRANSITION_LP_B_Q28 = [
    [250767114, 501534038, 250767114],
    [209867381, 419732057, 209867381],
    [170987846, 341967853, 170987846],
    [131531482, 263046905, 131531482],
    [89306658, 178584282, 89306658],
]
TRANSITION_LP_A_Q28 = [
    [506393414, 239854379],
    [411067935, 169683996],
    [306733530, 116694253],
    [185807084, 77959395],
    [35497197, 57401098],
]


def _rshift_round(a: int, shift: int) -> int:
    return i32((a >> (shift - 1)) + 1) >> 1


class LpState:
    """silk_LP_state: biquad state + ramp position + direction."""

    def __init__(self):
        self.in_lp_state = [0, 0]
        self.transition_frame_no = 0
        self.mode = 0
        self.saved_fs_khz = 0

    def _interp_taps(self):
        fac_q16 = ((TRANSITION_FRAMES - self.transition_frame_no) << 16) \
            // _STEPS
        ind = fac_q16 >> 16
        fac_q16 -= ind << 16
        if ind >= TRANSITION_INT_NUM - 1:
            return (list(TRANSITION_LP_B_Q28[-1]),
                    list(TRANSITION_LP_A_Q28[-1]))
        if fac_q16 == 0:
            return (list(TRANSITION_LP_B_Q28[ind]),
                    list(TRANSITION_LP_A_Q28[ind]))
        b0, b1 = TRANSITION_LP_B_Q28[ind], TRANSITION_LP_B_Q28[ind + 1]
        a0, a1 = TRANSITION_LP_A_Q28[ind], TRANSITION_LP_A_Q28[ind + 1]
        if fac_q16 < 32768:
            b = [smlawb(b0[k], i32(b1[k] - b0[k]), fac_q16) for k in range(3)]
            a = [smlawb(a0[k], i32(a1[k] - a0[k]), fac_q16) for k in range(2)]
        else:
            f = fac_q16 - (1 << 16)
            b = [smlawb(b1[k], i32(b1[k] - b0[k]), f) for k in range(3)]
            a = [smlawb(a1[k], i32(a1[k] - a0[k]), f) for k in range(2)]
        return b, a

    def lp_variable_cutoff(self, frame):
        """Filter one frame of int16 samples in place; advances the ramp.

        frame: mutable sequence (list or int16 ndarray) at the internal
        rate. No-op when mode == 0."""
        if self.mode == 0:
            return
        b, a = self._interp_taps()
        self.transition_frame_no = max(
            0, min(TRANSITION_FRAMES, self.transition_frame_no + self.mode))
        # biquad_alt transposed form II (biquad_alt.rs:20-66)
        s0, s1 = self.in_lp_state
        a0l = i32(-a[0]) & 0x3FFF
        a0u = i32(-a[0]) >> 14
        a1l = i32(-a[1]) & 0x3FFF
        a1u = i32(-a[1]) >> 14
        for n in range(len(frame)):
            xv = int(frame[n])
            out32_q14 = i32(smlawb(s0, b[0], xv) << 2)
            s0 = i32(s1 + _rshift_round(smulwb(out32_q14, a0l), 14))
            s0 = smlawb(s0, out32_q14, a0u)
            s0 = smlawb(s0, b[1], xv)
            s1 = _rshift_round(smulwb(out32_q14, a1l), 14)
            s1 = smlawb(s1, out32_q14, a1u)
            s1 = smlawb(s1, b[2], xv)
            frame[n] = sat16((i32(out32_q14 + ((1 << 14) - 1))) >> 14)
        self.in_lp_state = [s0, s1]
