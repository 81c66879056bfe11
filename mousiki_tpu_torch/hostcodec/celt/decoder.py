"""CELT decoder: host-side frame parse + (for now) NumPy synthesis.

Parity: reference `src/celt/celt_decoder.rs` (celt_decode_with_ec:4140,
prepare_frame:2751, celt_synthesis:573, deemphasis:2198) following libopus
float semantics. The symbol stage stays host-side by design (SURVEY.md §7);
the synthesis path here is the reference implementation for the batched JAX
kernels in `mousiki_tpu.ops` and is written as pure array math so the
device port is mechanical.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..bitstream.entcode import RangeDecoder
from ..ops.mdct import celt_overlap_add, imdct_matrix
from .bands import anti_collapse, quant_all_bands
from .modes import BITRES, CeltMode, opus_custom_mode
from .quant_bands import (E_MEANS, unquant_coarse_energy, unquant_energy_finalise,
                          unquant_fine_energy)
from .rate import clt_compute_allocation
from .vq import SPREAD_NORMAL

DECODE_BUFFER_SIZE = 2048
COMBFILTER_MINPERIOD = 15
COMBFILTER_MAXPERIOD = 1024
CELT_LPC_ORDER = 24
PLC_PITCH_LAG_MAX = 720
PLC_PITCH_LAG_MIN = 100

TRIM_ICDF = [126, 124, 119, 109, 87, 41, 19, 9, 4, 2, 0]
SPREAD_ICDF = [25, 23, 2, 0]
TAPSET_ICDF = [2, 1, 0]

TF_SELECT_TABLE = [
    [0, -1, 0, -1, 0, -1, 0, -1],   # 2.5 ms
    [0, -1, 0, -2, 1, 0, 1, -1],    # 5 ms
    [0, -2, 0, -3, 2, 0, 1, -1],    # 10 ms
    [0, -2, 0, -3, 3, 0, 1, -1],    # 20 ms
]

_COMB_GAINS = [
    [0.3066406250, 0.2170410156, 0.1296386719],
    [0.4638671875, 0.2680664062, 0.0],
    [0.7998046875, 0.1000976562, 0.0],
]


def tf_decode(start: int, end: int, is_transient: bool, tf_res: list,
              LM: int, dec: RangeDecoder) -> None:
    budget = dec.storage * 8
    tell = dec.tell()
    logp = 2 if is_transient else 4
    tf_select_rsv = 1 if (LM > 0 and tell + logp + 1 <= budget) else 0
    budget -= tf_select_rsv
    tf_changed = curr = 0
    for i in range(start, end):
        if tell + logp <= budget:
            curr ^= dec.dec_bit_logp(logp)
            tell = dec.tell()
            tf_changed |= curr
        tf_res[i] = curr
        logp = 4 if is_transient else 5
    tf_select = 0
    ti = 1 if is_transient else 0
    if tf_select_rsv and (TF_SELECT_TABLE[LM][4 * ti + 0 + tf_changed]
                          != TF_SELECT_TABLE[LM][4 * ti + 2 + tf_changed]):
        tf_select = dec.dec_bit_logp(1)
    for i in range(start, end):
        tf_res[i] = TF_SELECT_TABLE[LM][4 * ti + 2 * tf_select + tf_res[i]]


def init_caps(mode: CeltMode, LM: int, C: int) -> list:
    caps = []
    for i in range(mode.num_ebands):
        N = (int(mode.ebands[i + 1]) - int(mode.ebands[i])) << LM
        caps.append((int(mode.cache.caps[mode.num_ebands * (2 * LM + C - 1) + i])
                     + 64) * C * N >> 2)
    return caps


def denormalise_bands(mode: CeltMode, X: np.ndarray, band_log_e: np.ndarray,
                      start: int, end: int, M: int, downsample: int,
                      silence: bool) -> np.ndarray:
    """Scale unit-norm shapes by band energy; returns freq (len N)."""
    N = M * mode.short_mdct_size
    freq = np.zeros(N, np.float64)
    bound = M * int(mode.ebands[end])
    if downsample != 1:
        bound = min(bound, N // downsample)
    if silence:
        return freq
    eb = mode.ebands
    for i in range(start, end):
        j0 = M * int(eb[i])
        j1 = M * int(eb[i + 1])
        lg = float(band_log_e[i]) + float(E_MEANS[i])
        g = 2.0 ** min(32.0, lg)
        freq[j0:j1] = X[j0:j1] * g
    freq[bound:] = 0.0
    return freq


def comb_filter(buf: np.ndarray, pos: int, T0: int, T1: int, N: int,
                g0: float, g1: float, tapset0: int, tapset1: int,
                window: np.ndarray, overlap: int) -> None:
    """In-place pitch postfilter on buf[pos:pos+N] (reads up to T+2 back)."""
    if g0 == 0.0 and g1 == 0.0:
        return
    T0 = max(T0, COMBFILTER_MINPERIOD)
    T1 = max(T1, COMBFILTER_MINPERIOD)
    g00 = g0 * _COMB_GAINS[tapset0][0]
    g01 = g0 * _COMB_GAINS[tapset0][1]
    g02 = g0 * _COMB_GAINS[tapset0][2]
    g10 = g1 * _COMB_GAINS[tapset1][0]
    g11 = g1 * _COMB_GAINS[tapset1][1]
    g12 = g1 * _COMB_GAINS[tapset1][2]
    x1 = buf[pos - T1 + 1]
    x2 = buf[pos - T1]
    x3 = buf[pos - T1 - 1]
    x4 = buf[pos - T1 - 2]
    if g0 == g1 and T0 == T1 and tapset0 == tapset1:
        ov = 0
    else:
        ov = overlap
    for i in range(ov):
        x0 = buf[pos + i - T1 + 2]
        f = window[i] * window[i]
        buf[pos + i] = (buf[pos + i]
                        + (1 - f) * g00 * buf[pos + i - T0]
                        + (1 - f) * g01 * (buf[pos + i - T0 + 1] + buf[pos + i - T0 - 1])
                        + (1 - f) * g02 * (buf[pos + i - T0 + 2] + buf[pos + i - T0 - 2])
                        + f * g10 * x2
                        + f * g11 * (x1 + x3)
                        + f * g12 * (x0 + x4))
        x4 = x3
        x3 = x2
        x2 = x1
        x1 = x0
    if g1 == 0.0:
        return
    # constant-filter tail — chunked so earlier outputs feed later reads
    i = ov
    while i < N:
        step = min(T1 - 2, N - i)
        idx = pos + np.arange(i, i + step)
        buf[idx] = (buf[idx]
                    + g10 * buf[idx - T1]
                    + g11 * (buf[idx - T1 + 1] + buf[idx - T1 - 1])
                    + g12 * (buf[idx - T1 + 2] + buf[idx - T1 - 2]))
        i += step


@dataclass
class CeltDecoder:
    """Stateful CELT decoder for one stream (numpy reference path).

    State layout mirrors reference OpusCustomDecoder (celt_decoder.rs:2515):
    decode_mem ring (per channel), energy memories, postfilter params, rng.
    """
    mode: CeltMode = None
    channels: int = 2          # CC: output channels
    stream_channels: int = 2   # C: coded channels
    downsample: int = 1
    start: int = 0
    end: int = 21
    signalling: int = 1
    disable_inv: bool = False  # set per stream_channels (mono default) by opus layer

    def __post_init__(self):
        if self.mode is None:
            self.mode = opus_custom_mode()
        self.overlap = self.mode.overlap
        self.rng = 0
        self.error = 0
        self.loss_count = 0
        self.loss_duration = 0
        self.skip_plc = False
        self.postfilter_period = 0
        self.postfilter_period_old = 0
        self.postfilter_gain = 0.0
        self.postfilter_gain_old = 0.0
        self.postfilter_tapset = 0
        self.postfilter_tapset_old = 0
        self.prefilter_and_fold = False
        nb = self.mode.num_ebands
        self.decode_mem = np.zeros((self.channels,
                                    DECODE_BUFFER_SIZE + self.overlap), np.float64)
        self.lpc = np.zeros((self.channels, CELT_LPC_ORDER), np.float64)
        self.old_ebands = np.zeros((2, nb), np.float64)
        self.old_log_e = np.full((2, nb), -28.0, np.float64)
        self.old_log_e2 = np.full((2, nb), -28.0, np.float64)
        self.background_log_e = np.full((2, nb), -28.0, np.float64)
        self.preemph_mem = np.zeros(self.channels, np.float64)
        self.plc_pitch = PLC_PITCH_LAG_MAX
        self.last_pitch_index = 0

    def reset(self):
        self.__post_init__()

    # ------------------------------------------------------------------
    def decode_with_ec(self, data: bytes | None, frame_size: int,
                       dec: RangeDecoder | None = None,
                       accum_pcm: np.ndarray | None = None,
                       return_desc: bool = False,
                       record_plan: bool = False,
                       trace: dict | None = None):
        """Decode one CELT frame; returns float PCM (frame_size/downsample, CC).

        If accum_pcm is given, decoded samples are added into it (used by the
        hybrid SILK+CELT path).
        """
        mode = self.mode
        C = self.stream_channels
        CC = self.channels
        nb = mode.num_ebands
        overlap = self.overlap
        frame_size *= self.downsample

        LM = None
        for lm in range(mode.max_lm + 1):
            if mode.short_mdct_size << lm == frame_size:
                LM = lm
                break
        if LM is None:
            raise ValueError("bad frame size")
        M = 1 << LM
        N = M * mode.short_mdct_size

        if data is None or len(data) <= 1:
            return self._decode_lost(N, LM, accum_pcm)

        if dec is None:
            dec = RangeDecoder(data)
        length = dec.storage

        eff_end = min(self.end, mode.effective_ebands)
        old_band_e = self.old_ebands

        if C == 1:
            old_band_e[0] = np.maximum(old_band_e[0], old_band_e[1])

        total_bits = length * 8
        tell = dec.tell()

        if tell >= total_bits:
            silence = 1
        elif tell == 1:
            silence = dec.dec_bit_logp(15)
        else:
            silence = 0
        if silence:
            tell = length * 8
            dec.nbits_total += tell - dec.tell()

        postfilter_gain = 0.0
        postfilter_pitch = 0
        postfilter_tapset = 0
        if self.start == 0 and tell + 16 <= total_bits:
            if dec.dec_bit_logp(1):
                octave = dec.dec_uint(6)
                postfilter_pitch = (16 << octave) + dec.dec_bits(4 + octave) - 1
                qg = dec.dec_bits(3)
                if dec.tell() + 2 <= total_bits:
                    postfilter_tapset = dec.dec_icdf(TAPSET_ICDF, 2)
                postfilter_gain = 0.09375 * (qg + 1)
            tell = dec.tell()

        if LM > 0 and tell + 3 <= total_bits:
            is_transient = dec.dec_bit_logp(3)
            tell = dec.tell()
        else:
            is_transient = 0
        short_blocks = bool(is_transient)

        intra_ener = dec.dec_bit_logp(3) if tell + 3 <= total_bits else 0
        unquant_coarse_energy(mode, self.start, self.end, old_band_e,
                              bool(intra_ener), dec, C, LM)

        tf_res = [0] * nb
        tf_decode(self.start, self.end, bool(is_transient), tf_res, LM, dec)

        tell = dec.tell()
        spread_decision = SPREAD_NORMAL
        if tell + 4 <= total_bits:
            spread_decision = dec.dec_icdf(SPREAD_ICDF, 5)

        cap = init_caps(mode, LM, C)
        offsets = [0] * nb
        dynalloc_logp = 6
        total_bits <<= BITRES
        tell = dec.tell_frac()
        for i in range(self.start, self.end):
            width = C * (int(mode.ebands[i + 1]) - int(mode.ebands[i])) << LM
            quanta = min(width << BITRES, max(6 << BITRES, width))
            dynalloc_loop_logp = dynalloc_logp
            boost = 0
            while (tell + (dynalloc_loop_logp << BITRES) < total_bits
                   and boost < cap[i]):
                flag = dec.dec_bit_logp(dynalloc_loop_logp)
                tell = dec.tell_frac()
                if not flag:
                    break
                boost += quanta
                total_bits -= quanta
                dynalloc_loop_logp = 1
            offsets[i] = boost
            if boost > 0:
                dynalloc_logp = max(2, dynalloc_logp - 1)

        alloc_trim = (dec.dec_icdf(TRIM_ICDF, 7)
                      if tell + (6 << BITRES) <= total_bits else 5)

        bits = ((length * 8) << BITRES) - dec.tell_frac() - 1
        anti_collapse_rsv = (1 << BITRES) if (
            is_transient and LM >= 2 and bits >= (LM + 2) << BITRES) else 0
        bits -= anti_collapse_rsv

        alloc = clt_compute_allocation(
            mode, self.start, self.end, offsets, cap, alloc_trim,
            0, 0, bits, C, LM, dec, is_encoder=False)
        coded_bands = alloc.coded_bands
        balance = alloc.balance

        if trace is not None:
            # Differential-test hook for the lockstep device decoder
            # (ops/celt_lockstep.py): capture every symbol-stage output.
            trace.update({
                "silence": int(silence), "pf_pitch": postfilter_pitch,
                "pf_gain": postfilter_gain, "pf_tapset": postfilter_tapset,
                "transient": int(is_transient), "intra": int(intra_ener),
                "coarse": old_band_e.copy(), "tf_res": list(tf_res),
                "spread": spread_decision, "offsets": list(offsets),
                "trim": alloc_trim, "anti_collapse_rsv": anti_collapse_rsv,
                "alloc_bits_in": bits, "alloc": alloc,
                "tell_pre_fine": dec.tell(), "tell_frac_pre_alloc": None,
            })

        unquant_fine_energy(mode, self.start, self.end, old_band_e,
                            alloc.ebits, dec, C)
        if trace is not None:
            trace["fine"] = old_band_e.copy()
            trace["tell_post_fine"] = dec.tell()
            trace["rng_post_fine"] = dec.rng
            trace["val_post_fine"] = dec.val

        for c in range(CC):
            self.decode_mem[c, : DECODE_BUFFER_SIZE - N + overlap // 2] = \
                self.decode_mem[c, N: DECODE_BUFFER_SIZE + overlap // 2]

        collapse_masks = np.zeros(C * nb, np.uint8)
        X = np.zeros((C, N), np.float64)
        X_flat = X.reshape(-1)
        plan = None
        if record_plan:
            from .plan import FramePlan
            plan = FramePlan(channels=C, frame=N, lm=LM, start=self.start,
                             end=self.end, norm_offset=0, norm_len=0,
                             short_blocks=bool(short_blocks))
        self.rng = quant_all_bands(
            False, mode, self.start, self.end, X_flat[:N],
            X_flat[N:] if C == 2 else None, collapse_masks, None,
            alloc.pulses, short_blocks, spread_decision, alloc.dual_stereo,
            alloc.intensity, tf_res,
            length * (8 << BITRES) - anti_collapse_rsv, balance, dec, LM,
            coded_bands, self.rng, 0, self.disable_inv, plan=plan)

        anti_collapse_on = 0
        if anti_collapse_rsv > 0:
            anti_collapse_on = dec.dec_bits(1)

        if trace is not None:
            trace["collapse_masks"] = collapse_masks.copy()
            trace["seed_post_bands"] = int(self.rng)
            trace["anti_collapse_on"] = int(anti_collapse_on)
            trace["tell_post_bands"] = dec.tell()

        unquant_energy_finalise(mode, self.start, self.end, old_band_e,
                                alloc.ebits, alloc.fine_priority,
                                length * 8 - dec.tell(), dec, C)
        if trace is not None:
            trace["final_energy"] = old_band_e.copy()
            trace["final_tell"] = dec.tell()
            trace["final_rng"] = dec.rng & 0xFFFFFFFF

        if anti_collapse_on:
            if plan is not None:
                plan.ac = {
                    "masks": collapse_masks.copy(),
                    "logE": old_band_e.copy(),
                    "prev1": self.old_log_e.copy(),
                    "prev2": self.old_log_e2.copy(),
                    "pulses": list(alloc.pulses),
                    "seed": int(self.rng),
                }
            anti_collapse(mode, X_flat, collapse_masks, LM, C, N,
                          self.start, self.end, old_band_e, self.old_log_e,
                          self.old_log_e2, alloc.pulses, self.rng)

        if silence:
            old_band_e[:, :] = -28.0

        if C == 1:
            old_band_e[1] = old_band_e[0]

        desc = None
        if return_desc:
            # Host/device split: hand the frame descriptor to the batched
            # device synthesis instead of synthesizing here. Energy state
            # bookkeeping below still runs on the host.
            desc = {
                "x": X.copy() if C == CC else np.repeat(X, CC, axis=0)[:CC],
                "band_log_e": old_band_e[:CC].copy(),
                "transient": bool(is_transient),
                "silence": bool(silence),
                "pf_pitch": postfilter_pitch,
                "pf_gain": postfilter_gain,
                "pf_tapset": postfilter_tapset,
            }
            if plan is not None:
                desc["plan"] = plan
        else:
            self._synthesis(X, old_band_e, self.start, eff_end, C, CC,
                            bool(is_transient), LM, silence)

        # postfilter
        for c in range(CC if not return_desc else 0):
            self.postfilter_period = max(self.postfilter_period, COMBFILTER_MINPERIOD)
            self.postfilter_period_old = max(self.postfilter_period_old,
                                             COMBFILTER_MINPERIOD)
            pos = DECODE_BUFFER_SIZE - N
            comb_filter(self.decode_mem[c], pos, self.postfilter_period_old,
                        self.postfilter_period, mode.short_mdct_size,
                        self.postfilter_gain_old, self.postfilter_gain,
                        self.postfilter_tapset_old, self.postfilter_tapset,
                        mode.window, overlap)
            if LM != 0:
                comb_filter(self.decode_mem[c], pos + mode.short_mdct_size,
                            self.postfilter_period, postfilter_pitch,
                            N - mode.short_mdct_size,
                            self.postfilter_gain, postfilter_gain,
                            self.postfilter_tapset, postfilter_tapset,
                            mode.window, overlap)
        self.postfilter_period_old = self.postfilter_period
        self.postfilter_gain_old = self.postfilter_gain
        self.postfilter_tapset_old = self.postfilter_tapset
        self.postfilter_period = postfilter_pitch
        self.postfilter_gain = postfilter_gain
        self.postfilter_tapset = postfilter_tapset
        if LM != 0:
            self.postfilter_period_old = self.postfilter_period
            self.postfilter_gain_old = self.postfilter_gain
            self.postfilter_tapset_old = self.postfilter_tapset

        if not is_transient:
            self.old_log_e2[:, :] = self.old_log_e
            self.old_log_e[:, :] = old_band_e
            if self.loss_count < 10:
                max_bg = M * 0.001
            else:
                max_bg = 1.0
            self.background_log_e = np.minimum(
                self.background_log_e + max_bg, self.old_log_e)
        else:
            self.old_log_e = np.minimum(self.old_log_e, old_band_e)
        for c in range(2):
            old_band_e[c, : self.start] = 0.0
            self.old_log_e[c, : self.start] = -28.0
            self.old_log_e2[c, : self.start] = -28.0
            old_band_e[c, self.end:] = 0.0
            self.old_log_e[c, self.end:] = -28.0
            self.old_log_e2[c, self.end:] = -28.0
        self.rng = dec.rng & 0xFFFFFFFF

        pcm = None if return_desc else self._deemphasis(N, CC, accum_pcm)
        self.loss_count = 0
        self.loss_duration = 0
        self.prefilter_and_fold = False
        if dec.tell() > 8 * length:
            raise ValueError("decoder consumed too many bits")
        if dec.get_error():
            self.error = 1
        return desc if return_desc else pcm

    # ------------------------------------------------------------------
    def _synthesis(self, X: np.ndarray, old_band_e: np.ndarray, start: int,
                   eff_end: int, C: int, CC: int, is_transient: bool,
                   LM: int, silence: int) -> None:
        mode = self.mode
        overlap = self.overlap
        N = mode.short_mdct_size << LM
        M = 1 << LM
        if is_transient:
            B = M
            NB = mode.short_mdct_size
            shift = mode.max_lm
        else:
            B = 1
            NB = mode.short_mdct_size << LM
            shift = mode.max_lm - LM
        n2 = (2 * mode.short_mdct_size << mode.max_lm) >> shift >> 1
        Mmat = imdct_matrix(n2)

        freqs = []
        if CC == 2 and C == 1:
            f = denormalise_bands(mode, X[0], old_band_e[0], start, eff_end,
                                  M, self.downsample, bool(silence))
            freqs = [f, f.copy()]
        elif CC == 1 and C == 2:
            f0 = denormalise_bands(mode, X[0], old_band_e[0], start, eff_end,
                                   M, self.downsample, bool(silence))
            f1 = denormalise_bands(mode, X[1], old_band_e[1], start, eff_end,
                                   M, self.downsample, bool(silence))
            freqs = [0.5 * (f0 + f1)]
        else:
            freqs = [denormalise_bands(mode, X[c], old_band_e[c], start,
                                       eff_end, M, self.downsample,
                                       bool(silence)) for c in range(CC)]

        half = overlap // 2
        for c in range(CC):
            freq = freqs[c]
            # de-interleave blocks: block b coefficient k = freq[b + k*B]
            blocks = freq.reshape(n2, B).T            # (B, n2)
            raw = blocks @ Mmat.T                      # (B, n2)
            pos = DECODE_BUFFER_SIZE - N
            # After the pre-synthesis memmove, the raw IMDCT tail stored by
            # the previous frame sits exactly at `pos`.
            prev_tail = self.decode_mem[c, pos: pos + half].copy()
            out, new_tail = celt_overlap_add(raw, prev_tail, mode.window)
            self.decode_mem[c, pos: pos + N] = out
            self.decode_mem[c, pos + N: pos + N + half] = new_tail

    def _deemphasis(self, N: int, CC: int, accum_pcm=None) -> np.ndarray:
        coef = self.mode.preemph
        coef0 = coef[0]
        Nd = N // self.downsample
        pcm = np.zeros((Nd, CC), np.float64)
        for c in range(CC):
            x = self.decode_mem[c, DECODE_BUFFER_SIZE - N: DECODE_BUFFER_SIZE]
            m = self.preemph_mem[c]
            scratch = np.empty(N, np.float64)
            if coef[1] != 0.0:
                # custom modes below 40 kHz use the 3-tap response
                # (celt_decoder.rs deemphasis, coef[1] branch)
                coef1, coef3 = coef[1], coef[3]
                for j in range(N):
                    tmp = x[j] + m
                    m = coef0 * tmp - coef1 * x[j]
                    scratch[j] = coef3 * tmp
            else:
                for j in range(N):
                    tmp = x[j] + m
                    m = coef0 * tmp
                    scratch[j] = tmp
            self.preemph_mem[c] = m
            pcm[:, c] = scratch[:: self.downsample][:Nd] / 32768.0
        if accum_pcm is not None:
            accum_pcm[:Nd, :CC] += pcm
            return accum_pcm
        return pcm

    # ------------------------------------------------------------------
    def _plc_pitch_search(self) -> int:
        """Open-loop pitch on the decode history (celt_decode_lost:1429 uses
        pitch_downsample + pitch_search); returns the lag at 48 kHz."""
        mono = self.decode_mem[:, :DECODE_BUFFER_SIZE].mean(axis=0)
        lp = 0.5 * (mono[0::2][:-1] + mono[1::2][:-1]) \
            if len(mono) % 2 else 0.5 * (mono[0::2] + mono[1::2])
        n = len(lp)
        frame = lp[n - 512:]
        e_f = float(frame @ frame) + 1e-9
        best_l, best_s = PLC_PITCH_LAG_MAX, -1.0
        for lag2 in range(PLC_PITCH_LAG_MIN // 2, PLC_PITCH_LAG_MAX // 2 + 1):
            seg = lp[n - 512 - lag2: n - lag2]
            c = float(frame @ seg)
            if c <= 0:
                continue
            s = c / math.sqrt(e_f * (float(seg @ seg) + 1e-9))
            if s > best_s:
                best_s, best_l = s, lag2 * 2
        return max(PLC_PITCH_LAG_MIN, min(PLC_PITCH_LAG_MAX, best_l))

    @staticmethod
    def _plc_lpc(x: np.ndarray, order: int = CELT_LPC_ORDER) -> np.ndarray:
        """Windowed autocorrelation + Levinson (celt _celt_autocorr/_celt_lpc
        float semantics incl. noise floor and lag windowing)."""
        w = np.hanning(len(x) + 2)[1:-1]
        xw = x * w
        ac = np.correlate(xw, xw, "full")[len(x) - 1: len(x) + order]
        ac[0] *= 1.0001
        ac[0] += 1e-9 * len(x)
        ac[1:] -= ac[1:] * (0.008 * np.arange(1, order + 1)) ** 2
        a = np.zeros(order)
        err = ac[0]
        for i in range(order):
            acc = ac[i + 1] - np.dot(a[:i], ac[i:0:-1][:i])
            k = np.clip(acc / max(err, 1e-12), -0.98, 0.98)
            a_new = a.copy()
            a_new[i] = k
            a_new[:i] = a[:i] - k * a[i - 1::-1][:i]
            a = a_new
            err *= 1 - k * k
        return a * (0.99 ** np.arange(1, order + 1))  # bandwidth expansion

    def _decode_lost(self, N: int, LM: int, accum_pcm=None) -> np.ndarray:
        """Pitch-based PLC: extrapolate the excitation of the last pitch
        period through the LPC envelope, then feed the extrapolated signal
        through the normal forward-MDCT -> synthesis path so the TDAC
        overlap with the next real frame stays consistent (reference
        celt_decode_lost:1429; MDCT re-entry replaces prefilter_and_fold)."""
        from ..ops.mdct import mdct_fold, mdct_matrix
        mode = self.mode
        CC = self.channels
        overlap = self.overlap
        d = CELT_LPC_ORDER
        if self.loss_count == 0:
            self.plc_pitch = self._plc_pitch_search()
        pitch = self.plc_pitch
        fade = 1.0 if self.loss_count == 0 else 0.8
        half = overlap // 2
        n_ext = N + overlap  # MDCT window advance: one full overlap of lookahead

        ext = np.zeros((CC, n_ext), np.float64)
        for c in range(CC):
            buf = self.decode_mem[c, :DECODE_BUFFER_SIZE]
            hist = buf[-COMBFILTER_MAXPERIOD:]
            if self.loss_count == 0:
                self.lpc[c] = self._plc_lpc(hist, d)
            a = self.lpc[c]
            # excitation (LPC residual) of the recent history
            exc = hist.copy()
            for j in range(d):
                exc[j + 1:] -= a[j] * hist[: len(hist) - j - 1]
            # per-period attenuation from successive period energies
            e1 = float(exc[-pitch:] @ exc[-pitch:])
            e2 = float(exc[-2 * pitch: -pitch] @ exc[-2 * pitch: -pitch]) \
                if 2 * pitch <= len(exc) else e1
            decay = math.sqrt(min(1.0, e1 / max(e2, 1e-9)))
            atten = fade
            # periodic excitation continuation
            e_ext = np.empty(n_ext)
            src_pos = len(exc) - pitch
            for n in range(n_ext):
                if n > 0 and n % pitch == 0:
                    atten *= decay
                e_ext[n] = exc[src_pos + (n % pitch)] * atten
            # LPC synthesis with decoder-history initial conditions
            mem = list(buf[-d:])
            out = np.empty(n_ext)
            for n in range(n_ext):
                v = e_ext[n]
                for j in range(d):
                    v += a[j] * mem[-1 - j]
                v = max(-65536.0, min(65536.0, v))
                out[n] = v
                mem.append(v)
                mem = mem[-d:]
            ext[c] = out

        # re-enter the standard transform path: forward MDCT of
        # [last overlap of history | extrapolated N], then normal synthesis
        F = mdct_matrix(N)
        w = mode.window.astype(np.float64)
        # decode_mem holds the post-postfilter signal, but the TDAC raw
        # tails live in the pre-postfilter domain: undo the comb filter on
        # the re-entry window (the prefilter_and_fold role in the
        # reference), synthesize, then re-apply the comb on the PLC frame.
        T = max(self.postfilter_period, COMBFILTER_MINPERIOD)
        g = self.postfilter_gain
        tap = self.postfilter_tapset
        gains = _COMB_GAINS[tap]
        for c in range(CC):
            full = np.concatenate([self.decode_mem[c, :DECODE_BUFFER_SIZE],
                                   ext[c]])
            if g != 0.0:
                pre = full.copy()
                idx = np.arange(T + 2, len(full))
                pre[idx] = (full[idx]
                            - g * gains[0] * full[idx - T]
                            - g * gains[1] * (full[idx - T + 1]
                                              + full[idx - T - 1])
                            - g * gains[2] * (full[idx - T + 2]
                                              + full[idx - T - 2]))
            else:
                pre = full
            inb = pre[DECODE_BUFFER_SIZE: DECODE_BUFFER_SIZE + N + overlap]
            freq = mdct_fold(inb, w, N) @ F.T
            self.decode_mem[c, : DECODE_BUFFER_SIZE - N + half] = \
                self.decode_mem[c, N: DECODE_BUFFER_SIZE + half]
            raw = freq[None, :] @ imdct_matrix(N).T
            pos = DECODE_BUFFER_SIZE - N
            prev_tail = self.decode_mem[c, pos: pos + half].copy()
            out, new_tail = celt_overlap_add(raw, prev_tail, mode.window)
            self.decode_mem[c, pos: pos + N] = out
            self.decode_mem[c, pos + N: pos + N + half] = new_tail
            if g != 0.0:
                comb_filter(self.decode_mem[c], pos, T, T, N, g, g, tap, tap,
                            mode.window, overlap)

        self.loss_count += 1
        self.loss_duration += N
        return self._deemphasis(N, CC, accum_pcm)
