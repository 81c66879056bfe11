"""CELT encoder: produces valid streams decodable by libopus and our decoder.

Parity target: reference `src/celt/celt_encoder.rs` (celt_encode_with_ec:
6710). The normative symbol layout (coarse energy incl. two-pass intra RD,
tf, spread, dynalloc, trim, allocation, PVQ, anti-collapse, fine/finalise)
matches libopus exactly; perceptual heuristics (transient detection,
dynalloc boosts, trim analysis, prefilter pitch search) start as simpler
conservative versions — every choice they make is a valid bitstream, and
they are refined incrementally against quality benchmarks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..bitstream.entcode import BITRES, RangeEncoder, ec_ilog
from ..bitstream.laplace import laplace_encode
from .bands import quant_all_bands
from .decoder import (COMBFILTER_MAXPERIOD, COMBFILTER_MINPERIOD,
                      SPREAD_ICDF, TAPSET_ICDF, TF_SELECT_TABLE, TRIM_ICDF,
                      init_caps)
from .modes import CeltMode, MAX_FINE_BITS, opus_custom_mode
from .ops_float import (amp2_log2, compute_band_energies, normalise_bands)
from .quant_bands import (BETA_COEF, BETA_INTRA, E_MEANS, E_PROB_MODEL,
                          PRED_COEF, SMALL_ENERGY_ICDF)
from .rate import clt_compute_allocation
from ..ops.mdct import mdct_fold, mdct_matrix
from .vq import (SPREAD_AGGRESSIVE, SPREAD_LIGHT, SPREAD_NONE, SPREAD_NORMAL)

# intensity-stereo rate thresholds per band, kb/s (celt_encoder.rs:6154)
INTENSITY_THRESHOLDS = [1, 2, 3, 4, 5, 6, 7, 8, 16, 24, 36, 44, 50, 56, 62,
                        67, 72, 79, 88, 106, 134]
INTENSITY_HYSTERESIS = [1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 3, 3, 4,
                        5, 6, 8, 8]


# inverse masking ratio table (celt_encoder.rs:2604 INV_TABLE)
_TRANSIENT_INV_TABLE = [
    255, 255, 156, 110, 86, 70, 59, 51, 45, 40, 37, 33, 31, 28, 26, 25, 23,
    22, 21, 20, 19, 18, 17, 16, 16, 15, 15, 14, 13, 13, 12, 12, 12, 12, 11,
    11, 11, 10, 10, 10, 9, 9, 9, 9, 9, 9, 8, 8, 8, 8, 8, 7, 7, 7, 7, 7, 7,
    6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 5, 5, 5, 5, 5, 5, 5, 5,
    5, 5, 5, 5, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4,
    4, 4, 4, 4, 4, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 2,
]


def _hysteresis_decision(value: float, thresholds, hysteresis,
                         prev: int) -> int:
    """Sticky threshold table lookup (celt/bands.rs:573-600)."""
    count = len(thresholds)
    index = 0
    while index < count and value >= thresholds[index]:
        index += 1
    if prev < count and index > prev and value < thresholds[prev] \
            + hysteresis[prev]:
        index = prev
    if 0 < prev and index < prev and value > thresholds[prev - 1] \
            - hysteresis[prev - 1]:
        index = prev
    return index


@dataclass
class CeltEncoder:
    mode: CeltMode = None
    channels: int = 2
    stream_channels: int = 2
    upsample: int = 1
    start: int = 0
    end: int = 21
    bitrate: int = -1  # OPUS_BITRATE_MAX
    vbr: bool = False
    constrained_vbr: bool = True
    complexity: int = 5
    lsb_depth: int = 24
    disable_inv: bool = False
    lfe: bool = False
    loss_rate: int = 0
    force_intra: bool = False

    def __post_init__(self):
        if self.mode is None:
            self.mode = opus_custom_mode()
        self.overlap = self.mode.overlap
        nb = self.mode.num_ebands
        CC = self.channels
        self.rng = 0
        self.spread_decision = SPREAD_NORMAL
        self.delayed_intra = 1.0
        self.tonal_average = 256
        self.hf_average = 0
        self.tapset_decision = 0
        self.prefilter_period = 0
        self.prefilter_gain = 0.0
        self.prefilter_tapset = 0
        self.consec_transient = 0
        self.intensity = 0  # hysteresis state for the intensity decision
        self.intensity = 0
        self.last_coded_bands = 0
        self.in_mem = np.zeros((CC, self.overlap), np.float64)
        self.prefilter_mem = np.zeros((CC, COMBFILTER_MAXPERIOD), np.float64)
        self.old_band_e = np.zeros((2, nb), np.float64)
        self.old_log_e = np.full((2, nb), -28.0, np.float64)
        self.old_log_e2 = np.full((2, nb), -28.0, np.float64)
        self.energy_error = np.zeros((2, nb), np.float64)
        self.preemph_mem = np.zeros(CC, np.float64)
        self.vbr_reservoir = 0
        self.vbr_offset = 0
        self.vbr_drift = 0
        self.vbr_count = 0

    def reset(self):
        self.__post_init__()

    # ------------------------------------------------------------------
    def encode_with_ec(self, pcm: np.ndarray, frame_size: int,
                       nb_compressed_bytes: int,
                       enc: RangeEncoder | None = None,
                       precomputed: dict | None = None) -> bytes | None:
        """Encode one frame; pcm is float (frame_size, CC) in [-1, 1].

        Returns the compressed bytes when it owns the encoder, else None
        (hybrid mode: caller's RangeEncoder carries the stream).

        precomputed: per-stream outputs of the batched device front end
        (ops/encode_front_jax.front_step) — preemphasis, tone/pitch
        analyses, prefilter decision+application, transient analysis and
        the forward MDCT all already done on the TPU; this call then only
        runs the symbol layer. Keys: silence, tone_freq, toneishness,
        pf_on, pitch_index, qg, gain1, is_transient, tf_estimate,
        freq (C, N). The device owns in_mem/prefilter_mem state.
        """
        mode = self.mode
        C = self.stream_channels
        CC = self.channels
        nb = mode.num_ebands
        overlap = self.overlap
        eb = mode.ebands

        LM = None
        for lm in range(mode.max_lm + 1):
            if mode.short_mdct_size << lm == frame_size:
                LM = lm
                break
        if LM is None:
            raise ValueError("bad frame size")
        M = 1 << LM
        N = M * mode.short_mdct_size

        own_enc = enc is None
        if own_enc:
            enc = RangeEncoder(nb_compressed_bytes)
            tell = 1
        else:
            tell = enc.tell()
        nb_filled_bytes = 0 if own_enc else (tell + 4) >> 3

        if self.bitrate != -1:
            tmp = self.bitrate * frame_size
            if tell > 1:
                tmp += tell
            nb_compressed_bytes = max(2, min(
                nb_compressed_bytes, (tmp + 4 * mode.fs) // (8 * mode.fs)))
            if self.vbr and own_enc:
                # quality-driven VBR with a bit reservoir: louder / busier
                # frames borrow bytes, quiet frames repay (simplified
                # celt_encoder.rs vbr_rate loop)
                x = pcm[:, :1] if pcm.ndim > 1 else pcm[:, None]
                e = float(np.square(pcm).mean())
                loud = 10.0 * np.log10(e + 1e-12)
                if not hasattr(self, "_vbr_loud_avg"):
                    self._vbr_loud_avg = loud
                self._vbr_loud_avg += 0.05 * (loud - self._vbr_loud_avg)
                scale = 2.0 ** ((loud - self._vbr_loud_avg) / 12.0)
                scale = max(0.6, min(1.6, scale))
                # reservoir keeps long-term average on target (in bytes)
                scale *= max(0.7, min(1.4, 1.0 - self.vbr_reservoir
                                      / (8.0 * nb_compressed_bytes + 1)))
                target = int(round(nb_compressed_bytes * scale))
                target = max(8, min(1275, target))
                self.vbr_reservoir += target - nb_compressed_bytes
                self.vbr_reservoir = max(-20 * nb_compressed_bytes,
                                         min(20 * nb_compressed_bytes,
                                             self.vbr_reservoir))
                nb_compressed_bytes = target
        effective_bytes = nb_compressed_bytes - nb_filled_bytes
        if own_enc:
            enc.shrink(nb_compressed_bytes)

        total_bits = nb_compressed_bytes * 8
        eff_end = min(self.end, mode.effective_ebands)

        # --- preemphasis into the analysis buffer ---
        if precomputed is None:
            inb = np.empty((CC, N + overlap), np.float64)
            inb[:, :overlap] = self.in_mem
            coef = mode.preemph
            coef0 = coef[0]
            for c in range(min(CC, pcm.shape[1]) if pcm.ndim > 1 else 1):
                x = pcm[:, c] * 32768.0
                m = self.preemph_mem[c]
                out = np.empty(N)
                if coef[1] != 0.0:
                    # custom modes below 40 kHz: 3-tap response
                    # (celt_encoder.rs celt_preemphasis, coef[1] branch)
                    coef1, coef2 = coef[1], coef[2]
                    for j in range(N):
                        tmp = coef2 * x[j]
                        out[j] = tmp + m
                        m = coef1 * out[j] - coef0 * tmp
                    self.preemph_mem[c] = m
                else:
                    # y[n] = x[n] - coef0*x[n-1] with carried memory
                    out[0] = x[0] - m
                    out[1:] = x[1:] - coef0 * x[:-1]
                    self.preemph_mem[c] = coef0 * x[-1]
                inb[c, overlap:] = out
            if CC == 2 and (pcm.ndim == 1 or pcm.shape[1] == 1):
                inb[1] = inb[0]
            self.in_mem = inb[:, N: N + overlap].copy()

        # --- silence detection ---
        if precomputed is None:
            silence = bool(np.abs(pcm).max() <= 1.0 / (1 << self.lsb_depth))
        else:
            silence = bool(precomputed["silence"])
        if tell == 1:
            enc.enc_bit_logp(1 if silence else 0, 15)
        else:
            silence = False
        if silence:
            # pretend we've used all bits
            enc.nbits_total += total_bits - enc.tell()

        # --- tone detection (feeds prefilter/transient/dynalloc) ---
        if precomputed is None:
            tone_freq, toneishness = self._tone_detect(inb, CC)
        else:
            tone_freq = float(precomputed["tone_freq"])
            toneishness = float(precomputed["toneishness"])

        # --- prefilter (pitch prediction, inverse of the decoder's
        # postfilter; reference run_prefilter celt_encoder.rs:3200) ---
        pf_on = 0
        pitch_index = COMBFILTER_MINPERIOD
        gain1 = 0.0
        qg = 0
        prefilter_tapset = self.tapset_decision  # tracked by spread analysis
        enabled = (self.start == 0 and not silence
                   and enc.tell() + 16 <= total_bits
                   and self.complexity >= 5 and nb_compressed_bytes > 12)
        if precomputed is not None:
            pf_on = int(precomputed["pf_on"]) if enabled else 0
            if pf_on:
                pitch_index = int(precomputed["pitch_index"])
                qg = int(precomputed["qg"])
                gain1 = 0.09375 * (qg + 1)
        elif enabled:
            pitch_index, gain1 = self._prefilter_pitch(inb, N, CC)
            if toneishness > 0.99 and gain1 < 0.4:
                # pure tone but the pitch search failed (octave error /
                # weak correlation): derive the comb period from the tone
                # itself and run near-full gain (run_prefilter:3344).
                # When the search already found a confident gain we keep
                # its measured value instead of the reference's 0.75.
                tf = tone_freq
                while tf >= 0.39:
                    tf *= 0.5
                if tf > 0.006148:
                    pitch_index = min(COMBFILTER_MAXPERIOD - 2,
                                      int(math.floor(0.5 + 2 * math.pi / tf)))
                else:
                    pitch_index = COMBFILTER_MINPERIOD
                gain1 = 0.75
            loss = getattr(self, "loss_rate", 0)
            if loss > 2:
                gain1 *= 0.5
            if loss > 4:
                gain1 *= 0.5
            if loss > 8:
                gain1 = 0.0
            # quantize the gain like the decoder will read it
            qg = max(0, min(7, int(np.floor(0.5 + gain1 * 32 / 3)) - 1))
            gain1 = 0.09375 * (qg + 1)
            pf_threshold = 0.2 if nb_compressed_bytes > 25 else 0.4
            if gain1 > pf_threshold and pitch_index > COMBFILTER_MINPERIOD:
                pf_on = 1
            else:
                gain1 = 0.0
        # apply (or coast) the prefilter with overlap blending from the
        # previous frame's parameters, even when pf_on = 0 (device-applied
        # in precomputed mode)
        if precomputed is None and self.start == 0 and not silence:
            self._apply_prefilter(inb, N, CC,
                                  pitch_index if pf_on else COMBFILTER_MINPERIOD,
                                  gain1 if pf_on else 0.0, prefilter_tapset)
        if self.start == 0 and not silence and enc.tell() + 16 <= total_bits:
            enc.enc_bit_logp(pf_on, 1)
            if pf_on:
                octave = max(0, ec_ilog(pitch_index + 1) - 5)
                enc.enc_uint(octave, 6)
                enc.enc_bits(pitch_index + 1 - (16 << octave), 4 + octave)
                enc.enc_bits(qg, 3)
                if enc.tell() + 2 <= total_bits:
                    enc.enc_icdf(prefilter_tapset, TAPSET_ICDF, 2)
        if pf_on:
            self.prefilter_period = pitch_index
            self.prefilter_gain = gain1
            self.prefilter_tapset = prefilter_tapset
        else:
            self.prefilter_period = COMBFILTER_MINPERIOD
            self.prefilter_gain = 0.0
            self.prefilter_tapset = 0

        # --- transient analysis ---
        is_transient = 0
        tf_estimate = 0.0
        if LM > 0 and enc.tell() + 3 <= total_bits and not silence:
            if precomputed is not None:
                transient = bool(precomputed["is_transient"])
                tf_estimate = float(precomputed["tf_estimate"])
            else:
                transient, tf_estimate, _tf_chan = self._transient_analysis(
                    inb, N, CC)
                if toneishness > 0.98 and tone_freq < 0.026:
                    transient = False  # strong low tone: never transient
            is_transient = 1 if transient else 0
            enc.enc_bit_logp(is_transient, 3)
        short_blocks = M if is_transient else 0

        # --- MDCT + energies ---
        if precomputed is not None:
            freq = np.asarray(precomputed["freq"], np.float64)[:CC]
        else:
            freq = self._compute_mdcts(inb, short_blocks, LM, CC)
        if CC == 2 and C == 1:
            freq = (freq[:1] + freq[1:]) * 0.5
        band_e = compute_band_energies(mode, freq, eff_end, M, C)
        band_log_e = amp2_log2(mode, band_e, eff_end, self.end, C)
        X = normalise_bands(mode, freq, band_e, eff_end, M, C)

        # --- coarse energy ---
        old_be_prev = self.old_band_e.copy()  # pre-quant state for dynalloc
        error = np.zeros((2, nb), np.float64)
        self._quant_coarse_energy(
            enc, band_log_e, error, total_bits, C, LM, eff_end,
            effective_bytes, two_pass=self.complexity >= 4)

        # --- dynalloc analysis (also yields importance/spread weights) ---
        want, importance, spread_weight = self._dynalloc_analysis(
            band_log_e, old_be_prev, C, LM, effective_bytes,
            bool(is_transient), tone_freq, toneishness)

        # --- tf ---
        tf_sel = 0
        if (self.start == 0 and effective_bytes >= 15 * C
                and self.complexity >= 2):
            lam = max(80, 20480 // max(1, effective_bytes) + 2)
            tf_res, tf_sel = self._tf_analysis(
                eff_end, bool(is_transient), lam, X, N, LM,
                tf_estimate, importance)
            for i in range(eff_end, nb):
                tf_res[i] = tf_res[eff_end - 1]
        elif self.start > 0:  # hybrid: flat resolution, no analysis
            tf_res = [int(bool(is_transient))] * nb
        else:
            tf_res = [int(bool(is_transient))] * nb
        self._tf_encode(enc, bool(is_transient), tf_res, LM, tf_sel,
                        total_bits)

        # --- spread ---
        if enc.tell() + 4 <= total_bits:
            if self.complexity == 0 or silence:
                self.spread_decision = SPREAD_NONE
            elif (short_blocks or self.complexity < 3
                    or effective_bytes < 10 * C):
                self.spread_decision = SPREAD_NORMAL
            else:
                self.spread_decision = self._spreading_decision(
                    X, eff_end, C, M, spread_weight,
                    update_hf=pf_on and not short_blocks)
            enc.enc_icdf(self.spread_decision, SPREAD_ICDF, 5)

        # --- dynalloc ---
        cap = init_caps(mode, LM, C)
        offsets = [0] * nb
        dynalloc_logp = 6
        total_bits_q3 = total_bits << BITRES
        tell_frac = enc.tell_frac()
        for i in range(self.start, self.end):
            width = C * (int(eb[i + 1]) - int(eb[i])) << LM
            quanta = min(width << BITRES, max(6 << BITRES, width))
            dynalloc_loop_logp = dynalloc_logp
            boost = 0
            j = 0
            # flag chain mirroring the decoder's parse loop exactly
            # (decoder.py:295-310): 1-flags add `quanta` boost, a 0-flag
            # (when affordable) terminates
            while (tell_frac + (dynalloc_loop_logp << BITRES) < total_bits_q3
                    and boost < cap[i]):
                flag = 1 if j < want[i] else 0
                enc.enc_bit_logp(flag, dynalloc_loop_logp)
                tell_frac = enc.tell_frac()
                if not flag:
                    break
                boost += quanta
                total_bits_q3 -= quanta
                dynalloc_loop_logp = 1
                j += 1
            offsets[i] = boost
            if boost:
                dynalloc_logp = max(2, dynalloc_logp - 1)

        # --- trim ---
        alloc_trim = 5
        if enc.tell_frac() + (6 << BITRES) <= total_bits_q3:
            if C == 2 and self.start == 0:
                alloc_trim = self._alloc_trim_analysis(X, band_log_e, N, LM, C)
            enc.enc_icdf(alloc_trim, TRIM_ICDF, 7)

        # --- allocation ---
        bits = ((nb_compressed_bytes * 8) << BITRES) - enc.tell_frac() - 1
        anti_collapse_rsv = (1 << BITRES) if (
            is_transient and LM >= 2 and bits >= (LM + 2) << BITRES) else 0
        bits -= anti_collapse_rsv

        # intensity/dual-stereo decisions (celt_encoder.rs:6149-6170):
        # intensity threshold per band from the equivalent 20 ms rate with
        # hysteresis; dual stereo when LR codes flat-panned content cheaper
        # than MS (stereo_analysis L1 comparison, celt_encoder.rs:1559)
        intensity = self.end
        dual_stereo = 0
        if C == 2:
            base_rate = nb_compressed_bytes * 8 * 50
            shift = 3 - LM
            equiv_rate = (base_rate << shift if shift >= 0
                          else base_rate >> -shift)
            equiv_rate -= (40 * C + 20) * ((400 >> LM) - 50)
            if self.bitrate > 0:
                equiv_rate = min(equiv_rate,
                                 self.bitrate - (40 * C + 20)
                                 * ((400 >> LM) - 50))
            intensity = _hysteresis_decision(
                equiv_rate / 1000.0, INTENSITY_THRESHOLDS,
                INTENSITY_HYSTERESIS, self.intensity)
            intensity = min(self.end, max(self.start, intensity))
            self.intensity = intensity
            if LM != 0:
                dual_stereo = 1 if self._stereo_analysis(X, LM, N) else 0
        signal_bandwidth = self.end - 1
        alloc = clt_compute_allocation(
            mode, self.start, self.end, offsets, cap, alloc_trim,
            intensity, dual_stereo, bits, C, LM, enc, is_encoder=True,
            prev=self.last_coded_bands, signal_bandwidth=signal_bandwidth)
        coded_bands = alloc.coded_bands
        if self.last_coded_bands:
            self.last_coded_bands = min(self.last_coded_bands + 1,
                                        max(self.last_coded_bands - 1, coded_bands))
        else:
            self.last_coded_bands = coded_bands

        self._quant_fine_energy(enc, error, alloc.ebits, C)

        # --- PVQ band encode ---
        collapse_masks = np.zeros(C * nb, np.uint8)
        X_flat = np.concatenate([X[c] for c in range(C)])
        self.rng = quant_all_bands(
            True, mode, self.start, self.end, X_flat[:N],
            X_flat[N:] if C == 2 else None, collapse_masks, band_e,
            alloc.pulses, bool(short_blocks), self.spread_decision,
            alloc.dual_stereo, alloc.intensity, tf_res,
            nb_compressed_bytes * (8 << BITRES) - anti_collapse_rsv,
            alloc.balance, enc, LM, coded_bands, self.rng,
            self.complexity, self.disable_inv)

        anti_collapse_on = 0
        if anti_collapse_rsv > 0:
            anti_collapse_on = 1 if self.consec_transient < 2 else 0
            enc.enc_bits(anti_collapse_on, 1)

        self._quant_energy_finalise(enc, error, alloc.ebits,
                                    alloc.fine_priority,
                                    nb_compressed_bytes * 8 - enc.tell(), C)
        self.energy_error[:, :] = 0.0
        for c in range(C):
            self.energy_error[c, self.start:self.end] = np.clip(
                error[c, self.start:self.end], -0.5, 0.5)

        if silence:
            self.old_band_e[:, :] = -28.0

        # --- state updates (match decoder bookkeeping) ---
        self.prefilter_period = pitch_index
        self.prefilter_gain = gain1
        self.prefilter_tapset = prefilter_tapset
        if C == 1:
            self.old_band_e[1] = self.old_band_e[0]
        if not is_transient:
            self.old_log_e2[:, :] = self.old_log_e
            self.old_log_e[:, :] = self.old_band_e
        else:
            self.old_log_e = np.minimum(self.old_log_e, self.old_band_e)
        for c in range(2):
            self.old_band_e[c, : self.start] = 0.0
            self.old_log_e[c, : self.start] = -28.0
            self.old_log_e2[c, : self.start] = -28.0
            self.old_band_e[c, self.end:] = 0.0
            self.old_log_e[c, self.end:] = -28.0
            self.old_log_e2[c, self.end:] = -28.0
        self.consec_transient = self.consec_transient + 1 if is_transient else 0
        self.rng = enc.rng & 0xFFFFFFFF

        if enc.tell() > 8 * nb_compressed_bytes:
            raise ValueError("encoder busted budget")
        if own_enc:
            enc.done()
            if enc.get_error():
                raise ValueError("range encoder error")
            return enc.data()
        return None

    # ------------------------------------------------------------------
    def _compute_mdcts(self, inb, short_blocks, LM, CC):
        mode = self.mode
        N = mode.short_mdct_size << LM
        overlap = self.overlap
        if short_blocks:
            B = short_blocks
            NB = mode.short_mdct_size
        else:
            B = 1
            NB = N
        F = mdct_matrix(NB)
        w = mode.window.astype(np.float64)
        freq = np.empty((CC, N), np.float64)
        for c in range(CC):
            for b in range(B):
                seg = inb[c, b * NB: b * NB + NB + overlap]
                coeffs = mdct_fold(seg, w, NB) @ F.T
                freq[c, b::B] = coeffs
        return freq

    def _prefilter_pitch(self, inb, N, CC):
        """Open-loop pitch + gain on the preemphasized input (downsample 2x,
        normalized autocorrelation with sub-multiple preference)."""
        hist = self.prefilter_mem
        mono = np.concatenate([hist.mean(axis=0),
                               inb[:, self.overlap:].mean(axis=0)])
        lp = 0.5 * (mono[0::2] + mono[1::2])
        n = len(lp)
        frame = lp[-(N // 2):]
        e_f = float(frame @ frame) + 1e-9
        best_l, best_s = COMBFILTER_MINPERIOD, 0.0
        lo = COMBFILTER_MINPERIOD // 2 + 1
        hi = min(COMBFILTER_MAXPERIOD // 2 - 1, n - N // 2 - 1)
        for lag in range(lo, hi):
            seg = lp[n - N // 2 - lag: n - lag]
            c = float(frame @ seg)
            if c <= 0:
                continue
            s = c / np.sqrt(e_f * (float(seg @ seg) + 1e-9))
            if s > best_s:
                best_s, best_l = s, lag
        # prefer sub-multiples (avoid period doubling)
        for div in (2, 3):
            cand = best_l // div
            if cand >= lo:
                seg = lp[n - N // 2 - cand: n - cand]
                c = float(frame @ seg)
                if c > 0:
                    s = c / np.sqrt(e_f * (float(seg @ seg) + 1e-9))
                    if s > 0.85 * best_s:
                        best_l = cand
                        best_s = max(best_s, s)
                        break
        # refine at full rate (the 2x-downsampled search is +/-1 sample off,
        # which misaligns the decoder's postfilter re-addition)
        nf = len(mono)
        fr = mono[-N:]
        e_fr = float(fr @ fr) + 1e-9
        best_p, best_fs = 2 * best_l, 0.0
        for p in range(max(COMBFILTER_MINPERIOD, 2 * best_l - 2),
                       min(COMBFILTER_MAXPERIOD - 2, 2 * best_l + 3)):
            seg = mono[nf - N - p: nf - p]
            c = float(fr @ seg)
            if c <= 0:
                continue
            s = c / np.sqrt(e_fr * (float(seg @ seg) + 1e-9))
            if s > best_fs:
                best_fs, best_p = s, p
        return best_p, min(1.0, 0.7 * best_fs)

    def _apply_prefilter(self, inb, N, CC, period, gain, tapset):
        """Pitch prefilter: x[n] = s[n] - g * s[n-T] reading the ORIGINAL
        signal (FIR inverse of the decoder's feedback postfilter), with the
        window-blend handoff from the previous frame's parameters."""
        from .decoder import _COMB_GAINS
        overlap = self.overlap
        w2 = self.mode.window.astype(np.float64) ** 2
        t0 = max(self.prefilter_period, COMBFILTER_MINPERIOD)
        t1 = max(period, COMBFILTER_MINPERIOD)
        g0, g1 = self.prefilter_gain, gain
        tg0 = _COMB_GAINS[self.prefilter_tapset]
        tg1 = _COMB_GAINS[tapset]
        for c in range(CC):
            ref = np.concatenate([self.prefilter_mem[c], inb[c, overlap:]])
            pos = COMBFILTER_MAXPERIOD
            n = np.arange(N)

            def taps(t, tg):
                return (tg[0] * ref[pos + n - t]
                        + tg[1] * (ref[pos + n - t + 1] + ref[pos + n - t - 1])
                        + tg[2] * (ref[pos + n - t + 2] + ref[pos + n - t - 2]))

            p0 = g0 * taps(t0, tg0)
            p1 = g1 * taps(t1, tg1)
            f = np.ones(N)
            f[:overlap] = w2
            same = g0 == g1 and t0 == t1 and self.prefilter_tapset == tapset
            if same:
                f[:] = 1.0
            out = ref[pos: pos + N] - (1.0 - f) * p0 - f * p1
            inb[c, overlap:] = out
            # history keeps the ORIGINAL (unfiltered) signal
            self.prefilter_mem[c] = ref[N: N + COMBFILTER_MAXPERIOD]
        # the MDCT overlap memory must hold the *prefiltered* signal
        self.in_mem = inb[:, N: N + self.overlap].copy()

    def _tone_detect(self, inb, CC):
        """Narrowband tone detector.

        Parity: reference celt_encoder.rs:6985-7140 tone_detect/tone_lpc —
        fit a 2-tap LPC at doubling delays to the (downmixed) preemphasized
        input; complex roots mean a strong sinusoid. Returns (tone_freq in
        rad/sample or -1, toneishness in [0, 1])."""
        x = (inb[0] + inb[1] if CC == 2 else inb[0]).astype(np.float64)
        n = len(x)

        def tone_lpc(delay):
            lim = n - 2 * delay
            x0 = x[:lim]
            r00 = float(x0 @ x0)
            r01 = float(x0 @ x[delay: delay + lim])
            r02 = float(x0 @ x[2 * delay: 2 * delay + lim])
            t2, t1 = x[n - 2 * delay:], x[n - delay:]
            h0, h1 = x[:delay], x[delay: 2 * delay]
            r11 = r00 + float(t2 @ t2 - h0 @ h0)
            r22 = r11 + float(t1 @ t1 - h1 @ h1)
            r12 = r01 + float(t2[:delay] @ t1 - h0 @ h1)
            r00t, r01t = r00 + r22, r01 + r12
            r11t, r02t, r12t = 2.0 * r11, 2.0 * r02, r12 + r01
            den = r00t * r11t - r01t * r01t
            if den <= 0.0 or den < 0.001 * (r00t * r11t):
                return None
            num1 = r02t * r11t - r01t * r12t
            a1 = max(-1.0, min(1.0, num1 / den))
            num0 = r00t * r12t - r02t * r01t
            a0 = max(-1.999999, min(1.999999, num0 / den))
            return a0, a1

        delay = 1
        max_delay = max(1, 48000 // 3000)
        res = tone_lpc(delay)
        while delay <= max_delay and (
                res is None or (res[0] > 1.0 and res[1] < 0.0)):
            delay *= 2
            if 2 * delay >= n:
                res = None
                break
            res = tone_lpc(delay)
        if res is not None and res[0] ** 2 + 3.999999 * res[1] < 0.0:
            return math.acos(0.5 * res[0]) / delay, -res[1]
        return -1.0, 0.0

    def _transient_analysis(self, inb, N, CC):
        """Forward-masking transient detector.

        Parity: reference celt_encoder.rs:2592-2760 transient_analysis —
        2nd-order HP filter, squared-pair energies smoothed forward
        (1/16 decay) and backward (7/8), inverse-masking-ratio table sum
        over 4-sample strides -> mask_metric > 200 decides; also returns
        tf_estimate (sqrt(0.0069*tf_max - 0.139)) and the dominant channel.
        """
        length = inb.shape[1]
        len2 = length // 2
        mask_metric = 0
        tf_chan = 0
        for c in range(CC):
            x = inb[c].astype(np.float64)
            tmp = np.empty(length)
            mem0 = mem1 = 0.0
            for i in range(length):
                xi = x[i]
                tmp[i] = mem0 + xi
                mem0, mem1 = mem0 - xi + 0.5 * mem1, xi - mem0
            tmp[:12] = 0.0
            x2 = tmp[0: 2 * len2: 2] ** 2 + tmp[1: 2 * len2: 2] ** 2
            mean = float(x2.sum())
            fwd = np.empty(len2)
            m = 0.0
            for i in range(len2):
                m = x2[i] + 0.9375 * m
                fwd[i] = 0.0625 * m
            m = 0.0
            max_e = 0.0
            for i in range(len2 - 1, -1, -1):
                m = fwd[i] + 0.875 * m
                fwd[i] = 0.125 * m
                if fwd[i] > max_e:
                    max_e = fwd[i]
            frame_energy = math.sqrt(max(0.0, mean * max_e * 0.5 * len2))
            norm = len2 / (frame_energy + 1e-15)
            unmask = 0
            for i in range(12, max(12, len2 - 5), 4):
                p = math.floor(64.0 * norm * (fwd[i] + 1e-15))
                unmask += _TRANSIENT_INV_TABLE[int(min(127, max(0, p)))]
            if len2 > 17:
                value = (64 * unmask * 4) // (6 * (len2 - 17))
                if value > mask_metric:
                    mask_metric = value
                    tf_chan = c
        is_transient = mask_metric > 200
        tf_max = max(0.0, min(163.0, math.sqrt(27.0 * mask_metric) - 42.0))
        tf_estimate = math.sqrt(max(0.0, 0.0069 * tf_max - 0.139))
        return is_transient, tf_estimate, tf_chan

    def _stereo_analysis(self, X, LM, N) -> bool:
        """True when LR (dual) coding beats MS on the low bands
        (celt_encoder.rs:1559-1602: L1 norms over bands 0-13 with the
        theta-overhead correction)."""
        eb = self.mode.ebands
        sum_lr = sum_ms = 1e-15
        for band in range(13):
            j0, j1 = int(eb[band]) << LM, int(eb[band + 1]) << LM
            if j1 <= j0 or j1 > N:
                continue
            left = X[0, j0:j1]
            right = X[1, j0:j1]
            sum_lr += float(np.abs(left).sum() + np.abs(right).sum())
            sum_ms += float(np.abs(left + right).sum()
                            + np.abs(left - right).sum())
        sum_ms *= 0.7071067811865476
        thetas = 13 - (8 if LM <= 1 else 0)
        base = int(eb[13]) << (LM + 1)
        return (base + thetas) * sum_ms > base * sum_lr

    def _spreading_decision(self, X, end, C, M, spread_weight,
                            update_hf) -> int:
        """Tonality-driven spread choice + tapset tracking.

        Parity: reference celt/bands.rs:3576-3710 spreading_decision —
        count small normalized coefficients per band at three thresholds
        (sparse spectra = tonal = less spreading), average with hysteresis;
        the HF sparseness average drives next frame's prefilter tapset."""
        mode = self.mode
        eb = mode.ebands
        n0 = M * mode.short_mdct_size
        if M * (int(eb[end]) - int(eb[end - 1])) <= 8:
            return SPREAD_NONE
        ssum = 0
        nb_bands = 0
        hf_sum = 0
        for c in range(C):
            for band in range(end):
                j0, j1 = M * int(eb[band]), M * int(eb[band + 1])
                n = j1 - j0
                if n <= 8:
                    continue
                x2n = X[c, j0:j1] ** 2 * n
                t0 = int((x2n < 0.25).sum())
                t1 = int((x2n < 0.0625).sum())
                t2 = int((x2n < 0.015625).sum())
                if band + 4 > mode.num_ebands:
                    hf_sum += 32 * (t1 + t0) // n
                tmp = (int(2 * t2 >= n) + int(2 * t1 >= n)
                       + int(2 * t0 >= n))
                ssum += tmp * spread_weight[band]
                nb_bands += spread_weight[band]
        if update_hf:
            if hf_sum:
                denom = C * (4 - mode.num_ebands + end)
                hf_sum = hf_sum // denom if denom > 0 else 0
            self.hf_average = (self.hf_average + hf_sum) >> 1
            hf_sum = self.hf_average
            if self.tapset_decision == 2:
                hf_sum += 4
            elif self.tapset_decision == 0:
                hf_sum -= 4
            if hf_sum > 22:
                self.tapset_decision = 2
            elif hf_sum > 18:
                self.tapset_decision = 1
            else:
                self.tapset_decision = 0
        if nb_bands <= 0:
            return SPREAD_NORMAL
        ssum = ((ssum << 8) // nb_bands + self.tonal_average) >> 1
        self.tonal_average = ssum
        ssum = (3 * ssum + (((3 - self.spread_decision) << 7) + 64) + 2) >> 2
        if ssum < 80:
            return SPREAD_AGGRESSIVE
        if ssum < 256:
            return SPREAD_NORMAL
        if ssum < 384:
            return SPREAD_LIGHT
        return SPREAD_NONE

    def _tf_analysis(self, eff_end, is_transient, lam, X, N, LM,
                     tf_estimate, importance):
        """Per-band time-frequency resolution decision.

        Parity: reference celt/celt_encoder.rs:1604-1817 tf_analysis — for
        each band, compare the L1 cost (sparser = cheaper) of the spectrum
        under Haar merges/splits at each level, then run a 2-state Viterbi
        over the per-band flag costs (flag flips cost `lam`, deviations
        from the tf_select table targets cost importance-weighted error)."""
        from .bands import haar1

        mode = self.mode
        eb = mode.ebands
        bias = 0.04 * max(-0.25, 0.5 - tf_estimate)
        nb = mode.num_ebands
        metric = [0] * eff_end
        tf_res = [0] * nb

        def l1_metric(v, b):
            s = float(np.abs(v).sum())
            return s + b * bias * s

        for band in range(eff_end):
            j0, j1 = int(eb[band]), int(eb[band + 1])
            width = j1 - j0
            n = width << LM
            tmp = X[0, j0 << LM: (j0 << LM) + n].astype(np.float64).copy()
            narrow = width == 1
            best_level = 0
            best_l1 = l1_metric(tmp, LM if is_transient else 0)
            if is_transient and not narrow:
                alt = tmp.copy()
                haar1(alt, n >> LM, 1 << LM)
                l1 = l1_metric(alt, LM + 1)
                if l1 < best_l1:
                    best_l1, best_level = l1, -1
            extra = 0 if (is_transient or narrow) else 1
            for k in range(LM + extra):
                if n >> k == 0:
                    break
                haar1(tmp, n >> k, 1 << k)
                b = (LM - k - 1) if is_transient else (k + 1)
                l1 = l1_metric(tmp, b)
                if l1 < best_l1:
                    best_l1, best_level = l1, k + 1
            value = 2 * best_level if is_transient else -2 * best_level
            if narrow and (value == 0 or value == -2 * LM):
                value -= 1
            metric[band] = value

        table = TF_SELECT_TABLE[LM]
        base = 4 if is_transient else 0

        def viterbi(sel):
            path0 = [0] * eff_end
            path1 = [0] * eff_end
            t0 = 2 * int(table[base + 2 * sel])
            t1 = 2 * int(table[base + 2 * sel + 1])
            cost0 = importance[0] * abs(metric[0] - t0)
            cost1 = importance[0] * abs(metric[0] - t1) + (
                0 if is_transient else lam)
            for band in range(1, eff_end):
                if cost0 < cost1 + lam:
                    curr0, path0[band] = cost0, 0
                else:
                    curr0, path0[band] = cost1 + lam, 1
                if cost0 + lam < cost1:
                    curr1, path1[band] = cost0 + lam, 0
                else:
                    curr1, path1[band] = cost1, 1
                cost0 = curr0 + importance[band] * abs(metric[band] - t0)
                cost1 = curr1 + importance[band] * abs(metric[band] - t1)
            return cost0, cost1, path0, path1

        c0a, c1a, _, _ = viterbi(0)
        c0b, c1b, _, _ = viterbi(1)
        tf_select = 1 if (is_transient and min(c0b, c1b) < min(c0a, c1a)) \
            else 0
        cost0, cost1, path0, path1 = viterbi(tf_select)
        tf_res[eff_end - 1] = 0 if cost0 < cost1 else 1
        for band in range(eff_end - 2, -1, -1):
            tf_res[band] = (path1[band + 1] if tf_res[band + 1]
                            else path0[band + 1])
        return tf_res, tf_select

    def _dynalloc_analysis(self, band_log_e, old_band_e, C, LM,
                           effective_bytes, is_transient,
                           tone_freq=-1.0, toneishness=0.0):
        """Per-band boost counts for the dynalloc flag chain.

        Parity: reference celt/celt_encoder.rs:2861-3190 dynalloc_analysis —
        a piecewise-linear "follower" tracks the spectral floor (1.5 dB/band
        rise, 2 dB/band backtrack from the last peak, 5-point median floor,
        noise floor clamp); bands standing proud of the follower earn boost
        quanta, doubled below band 8 and halved above 12, capped at 4 and by
        a 2/3-of-budget CBR limit. Simplifications: bandLogE2 ~= bandLogE
        (no second MDCT grain), no surround/tone/leak inputs."""
        mode = self.mode
        nb = mode.num_ebands
        start, end = self.start, self.end
        want = [0] * nb
        importance = [13] * nb
        eb = mode.ebands
        idx = np.arange(end, dtype=np.float64)
        noise_floor = (0.0625 * mode.log_n[:end].astype(np.float64) + 0.5
                       + (9.0 - self.lsb_depth)
                       - np.asarray(E_MEANS[:end], np.float64)
                       + 0.0062 * (idx + 5.0) ** 2)
        # signal-to-mask spread weights (celt_encoder.rs:2980-3020): bands
        # standing proud of the leaked cross-band mask weigh more in the
        # spreading decision
        sig = band_log_e[0, :end] - noise_floor
        if C == 2:
            sig = np.maximum(sig, band_log_e[1, :end] - noise_floor)
        mask = sig.copy()
        for i in range(1, end):
            mask[i] = max(mask[i], mask[i - 1] - 2.0)
        for i in range(end - 2, -1, -1):
            mask[i] = max(mask[i], mask[i + 1] - 3.0)
        max_depth = float((band_log_e[:C, :end] - noise_floor[None, :]).max())
        base_threshold = max(0.0, max_depth - 12.0)
        spread_weight = [32] * nb
        for i in range(end):
            smr = sig[i] - max(base_threshold, mask[i])
            shift = min(5, max(0, -int(np.floor(smr + 0.5))))
            spread_weight[i] = 32 >> shift
        if effective_bytes < 30 + 5 * LM:
            return want, importance, spread_weight
        follower = np.zeros((C, end))
        for c in range(C):
            ble3 = band_log_e[c, :end].astype(np.float64).copy()
            if LM == 0:
                k = min(end, 8)
                ble3[:k] = np.maximum(ble3[:k], old_band_e[c, :k])
            f = np.empty(end)
            f[0] = ble3[0]
            last = 0
            for i in range(1, end):
                if ble3[i] > ble3[i - 1] + 0.5:
                    last = i
                f[i] = min(f[i - 1] + 1.5, ble3[i])
            for i in range(last - 1, -1, -1):
                f[i] = min(f[i], min(f[i + 1] + 2.0, ble3[i]))
            if end >= 3:
                med0 = float(np.median(ble3[:3])) - 1.0
                f[0] = max(f[0], med0)
                f[1] = max(f[1], med0)
                med1 = float(np.median(ble3[end - 3:])) - 1.0
                f[end - 2] = max(f[end - 2], med1)
                f[end - 1] = max(f[end - 1], med1)
            for i in range(2, end - 2):
                f[i] = max(f[i], float(np.median(ble3[i - 2: i + 3])) - 1.0)
            follower[c] = np.maximum(f, noise_floor)
        if C == 2:
            fr = np.maximum(follower[1, start:], follower[0, start:] - 4.0)
            fl = np.maximum(follower[0, start:], fr - 4.0)
            dl = np.maximum(band_log_e[0, start:end] - fl, 0.0)
            dr = np.maximum(band_log_e[1, start:end] - fr, 0.0)
            depth = 0.5 * (dl + dr)
        else:
            depth = np.maximum(band_log_e[0, start:end]
                               - follower[0, start:], 0.0)
        for k, i in enumerate(range(start, end)):
            importance[i] = int(13.0 * 2.0 ** min(depth[k], 4.0) + 0.5)
        if not self.vbr and not is_transient:
            depth = depth * 0.5
        tone_bin = (int(math.floor(tone_freq * (120.0 / math.pi) + 0.5))
                    if toneishness > 0.98 else None)
        for k, i in enumerate(range(start, end)):
            d = depth[k]
            if i < 8:
                d *= 2.0
            if i >= 12:
                d *= 0.5
            if tone_bin is not None:
                # concentrate extra bits on the band(s) holding a pure tone
                # (celt_encoder.rs:3132-3150)
                lo, hi = int(eb[i]), int(eb[i + 1])
                if lo <= tone_bin <= hi:
                    d += 2.0
                if lo - 1 <= tone_bin <= hi + 1:
                    d += 1.0
                if lo - 2 <= tone_bin <= hi + 2:
                    d += 1.0
                if lo - 3 <= tone_bin <= hi + 3:
                    d += 0.5
            d = min(d, 4.0)
            width = C * (int(eb[i + 1]) - int(eb[i])) << LM
            if width < 6:
                want[i] = int(d)
            elif width > 48:
                want[i] = int(d * 8.0)
            else:
                want[i] = int(d * width / 6.0)
        return want, importance, spread_weight

    def _alloc_trim_analysis(self, X, band_log_e, N, LM, C) -> int:
        # conservative mid trim; refine with tonality/stereo correlation later
        return 5

    # ------------------------------------------------------------------
    def _quant_coarse_energy(self, enc, e_bands, error, budget, C, LM,
                             eff_end, nb_available_bytes, two_pass):
        start, end = self.start, self.end
        old = self.old_band_e
        intra = self.force_intra or (
            not two_pass and self.delayed_intra > 2 * C * (end - start)
            and nb_available_bytes > (end - start) * C)
        intra_bias = int(budget * self.delayed_intra * self.loss_rate / (C * 512))
        new_distortion = self._loss_distortion(e_bands, old, start, eff_end, C)

        tell = enc.tell()
        if tell + 3 > budget:
            two_pass = False
            intra = False

        max_decay = 16.0
        if end - start > 10:
            max_decay = min(max_decay, 0.125 * nb_available_bytes)
        if self.lfe:
            max_decay = 3.0

        snap_start = enc.save()
        old_intra = old.copy()
        error_intra = np.zeros_like(error)
        badness1 = 0
        if two_pass or intra:
            badness1 = self._coarse_impl(enc, e_bands, old_intra, budget, tell,
                                         E_PROB_MODEL[LM][1], error_intra, C,
                                         LM, True, max_decay)
        if not intra:
            snap_intra = enc.save()
            tell_intra = enc.tell_frac()
            enc.restore(snap_start)
            badness2 = self._coarse_impl(enc, e_bands, old, budget, tell,
                                         E_PROB_MODEL[LM][0], error, C, LM,
                                         False, max_decay)
            if two_pass and (badness1 < badness2
                             or (badness1 == badness2
                                 and enc.tell_frac() + intra_bias > tell_intra)):
                enc.restore(snap_intra)
                old[:, :] = old_intra
                error[:, :] = error_intra
                intra = True
        else:
            old[:, :] = old_intra
            error[:, :] = error_intra

        if intra:
            self.delayed_intra = new_distortion
        else:
            self.delayed_intra = (PRED_COEF[LM] ** 2 * self.delayed_intra
                                  + new_distortion)

    def _loss_distortion(self, e_bands, old, start, end, C):
        d = e_bands[:C, start:end] - old[:C, start:end]
        return min(200.0, float((d * d).sum()))

    def _coarse_impl(self, enc, e_bands, old, budget, tell, prob_model,
                     error, C, LM, intra, max_decay):
        start, end = self.start, self.end
        badness = 0
        prev = [0.0, 0.0]
        if tell + 3 <= budget:
            enc.enc_bit_logp(1 if intra else 0, 3)
        coef = 0.0 if intra else PRED_COEF[LM]
        beta = BETA_INTRA if intra else BETA_COEF[LM]
        for i in range(start, end):
            for c in range(C):
                x = float(e_bands[c, i])
                old_e = max(-9.0, float(old[c, i]))
                f = x - coef * old_e - prev[c]
                qi = int(math.floor(0.5 + f))
                decay_bound = max(-28.0, float(old[c, i])) - max_decay
                if qi < 0 and x < decay_bound:
                    qi += int(decay_bound - x)
                    if qi > 0:
                        qi = 0
                qi0 = qi
                tell = enc.tell()
                bits_left = budget - tell - 3 * C * (end - i)
                if i != start and bits_left < 30:
                    if bits_left < 24:
                        qi = min(1, qi)
                    if bits_left < 16:
                        qi = max(-1, qi)
                if self.lfe and i >= 2:
                    qi = min(qi, 0)
                if budget - tell >= 15:
                    pi = 2 * min(i, 20)
                    qi = laplace_encode(enc, qi,
                                        prob_model[pi] << 7,
                                        prob_model[pi + 1] << 6)
                elif budget - tell >= 2:
                    qi = max(-1, min(qi, 1))
                    enc.enc_icdf((2 * qi) ^ -(1 if qi < 0 else 0),
                                 SMALL_ENERGY_ICDF, 2)
                elif budget - tell >= 1:
                    qi = min(0, qi)
                    enc.enc_bit_logp(-qi, 1)
                else:
                    qi = -1
                error[c, i] = f - qi
                badness += abs(qi0 - qi)
                q = float(qi)
                tmp = coef * old_e + prev[c] + q
                old[c, i] = tmp
                prev[c] = prev[c] + q - beta * q
        return 0 if self.lfe else badness

    # ------------------------------------------------------------------
    def _tf_encode(self, enc, is_transient, tf_res, LM, tf_select, budget):
        start, end = self.start, self.end
        tell = enc.tell()
        logp = 2 if is_transient else 4
        tf_select_rsv = 1 if (LM > 0 and tell + logp + 1 <= budget) else 0
        budget -= tf_select_rsv
        curr = tf_changed = 0
        for i in range(start, end):
            if tell + logp <= budget:
                enc.enc_bit_logp(tf_res[i] ^ curr, logp)
                tell = enc.tell()
                curr = tf_res[i]
                tf_changed |= curr
            else:
                tf_res[i] = curr
            logp = 4 if is_transient else 5
        ti = 1 if is_transient else 0
        if tf_select_rsv and (TF_SELECT_TABLE[LM][4 * ti + 0 + tf_changed]
                              != TF_SELECT_TABLE[LM][4 * ti + 2 + tf_changed]):
            enc.enc_bit_logp(tf_select, 1)
        else:
            tf_select = 0
        for i in range(start, end):
            tf_res[i] = TF_SELECT_TABLE[LM][4 * ti + 2 * tf_select + tf_res[i]]

    def _quant_fine_energy(self, enc, error, fine_quant, C):
        for i in range(self.start, self.end):
            if fine_quant[i] <= 0:
                continue
            frac = 1 << fine_quant[i]
            for c in range(C):
                q2 = int(math.floor((error[c, i] + 0.5) * frac))
                q2 = max(0, min(q2, frac - 1))
                enc.enc_bits(q2, fine_quant[i])
                offset = (q2 + 0.5) * (2.0 ** -fine_quant[i]) - 0.5
                self.old_band_e[c, i] += offset
                error[c, i] -= offset

    def _quant_energy_finalise(self, enc, error, fine_quant, fine_priority,
                               bits_left, C):
        for prio in range(2):
            for i in range(self.start, self.end):
                if bits_left < C:
                    break
                if fine_quant[i] >= MAX_FINE_BITS or fine_priority[i] != prio:
                    continue
                for c in range(C):
                    q2 = 0 if error[c, i] < 0 else 1
                    enc.enc_bits(q2, 1)
                    offset = (q2 - 0.5) * (2.0 ** -(fine_quant[i] + 1))
                    self.old_band_e[c, i] += offset
                    error[c, i] -= offset
                    bits_left -= 1
