"""Opus encoder top level: SILK, hybrid, and CELT modes with DTX, LBRR,
VBR/CBR, DRED embedding, and 8-48 kHz API rates.

Parity: reference `src/opus_encoder.rs` (opus_encoder_create:3965, TOC gen
gen_toc:1214, mode/bandwidth decision :1247-1511, DTX decide_dtx_mode:4365).
Produces standard Opus packets decodable by any decoder.
"""

from __future__ import annotations

import numpy as np

from .bitstream.packet import Bandwidth, Mode
from .celt.encoder import CeltEncoder

APP_VOIP = 2048
APP_AUDIO = 2049
APP_RESTRICTED_LOWDELAY = 2051


def compute_surround_masking_rate_offset(energy_masking, bandwidth,
                                         channels: int) -> int:
    """Surround masking SILK rate offset in bits/s (can be negative).

    Parity: reference opus_encoder.rs:1552-1587 — average the clamped
    per-band masking depth (21 bands per channel, [-2, 0.5], positive
    halved) over the bands the current bandwidth codes, add the +0.2
    floor, and scale by the internal sample rate."""
    from .bitstream.packet import Bandwidth
    end, srate = {Bandwidth.NARROWBAND: (13, 8000),
                  Bandwidth.MEDIUMBAND: (15, 12000)}.get(bandwidth,
                                                         (17, 16000))
    mask_sum = 0.0
    for c in range(channels):
        for i in range(end):
            idx = 21 * c + i
            if idx < len(energy_masking):
                mask = max(-2.0, min(0.5, float(energy_masking[idx])))
                mask_sum += mask * 0.5 if mask > 0 else mask
    depth = mask_sum / (end * channels) + 0.2
    return int(srate * depth)

_CELT_BW_TO_CONFIG = {
    Bandwidth.NARROWBAND: 16,
    Bandwidth.WIDEBAND: 20,
    Bandwidth.SUPERWIDEBAND: 24,
    Bandwidth.FULLBAND: 28,
}


def celt_toc(frame_size: int, bandwidth: Bandwidth, channels: int) -> int:
    size_code = {120: 0, 240: 1, 480: 2, 960: 3}[frame_size]
    if bandwidth == Bandwidth.MEDIUMBAND:
        bandwidth = Bandwidth.WIDEBAND  # CELT has no MB config (RFC 6716)
    config = _CELT_BW_TO_CONFIG[bandwidth] + size_code
    return (config << 3) | (0x4 if channels == 2 else 0)


_SILK_BW_TO_CONFIG = {
    Bandwidth.NARROWBAND: 0,
    Bandwidth.MEDIUMBAND: 4,
    Bandwidth.WIDEBAND: 8,
}
_SILK_BW_TO_KHZ = {
    Bandwidth.NARROWBAND: 8,
    Bandwidth.MEDIUMBAND: 12,
    Bandwidth.WIDEBAND: 16,
}


def silk_toc(frame_size: int, bandwidth: Bandwidth, channels: int) -> int:
    size_code = {480: 0, 960: 1, 1920: 2, 2880: 3}[frame_size]
    config = _SILK_BW_TO_CONFIG[bandwidth] + size_code
    return (config << 3) | (0x4 if channels == 2 else 0)


def hybrid_toc(frame_size: int, bandwidth: Bandwidth, channels: int) -> int:
    size_code = {480: 0, 960: 1}[frame_size]
    config = (12 if bandwidth == Bandwidth.SUPERWIDEBAND else 14) + size_code
    return (config << 3) | (0x4 if channels == 2 else 0)


class OpusEncoder:
    # max coding bandwidth by API sample rate (Nyquist-limited; reference
    # opus_encoder.rs limits via st.variable... + the CELT upsample path)
    _BW_CAP = {8000: Bandwidth.NARROWBAND, 12000: Bandwidth.MEDIUMBAND,
               16000: Bandwidth.WIDEBAND, 24000: Bandwidth.SUPERWIDEBAND,
               48000: Bandwidth.FULLBAND}

    def __init__(self, fs: int = 48000, channels: int = 2,
                 application: int = APP_RESTRICTED_LOWDELAY):
        if fs not in (8000, 12000, 16000, 24000, 48000) \
                or channels not in (1, 2):
            raise ValueError("fs must be 8/12/16/24/48 kHz, 1-2 channels")
        self.fs = fs
        self.channels = channels
        self.application = application
        self.bitrate = 64000 * channels
        self.vbr = True
        self.bandwidth = Bandwidth.FULLBAND
        self.mode = Mode.CELT  # SILK/hybrid modes land with the SILK encoder
        self.celt = CeltEncoder(channels=channels, stream_channels=channels,
                                end=21, disable_inv=channels == 1)
        from .silk.encoder import SilkEncoder, SilkStereoEncoder
        self.silk = SilkEncoder()
        self.silk_stereo = SilkStereoEncoder()
        self.range_final = 0
        self.force_mode = None
        self.analysis_state = None  # lazy TonalityAnalysisState (APP_AUDIO)
        self.analysis_info = None
        from .hp_filter import HighPassState
        self.hp_state = HighPassState()  # input HP / DC-reject filter
        self._last_silk_mirror = None
        self.energy_mask = None  # 21-band/channel surround masking input
        if application == APP_VOIP:
            self.mode = Mode.SILK
            self.bandwidth = Bandwidth.WIDEBAND
        if fs != 48000:
            # non-48k API input rides the Kaiser polyphase input resampler
            # up to the 48 kHz core (reference: opus_encoder.rs:3965 API
            # rates; our core runs at 48 kHz and caps coding bandwidth at
            # the input Nyquist). The FIFO is primed with the resampler's
            # output latency so every API frame maps to one 48k frame.
            from .ops.input_resampler import ArbitraryResampler
            self._in_rs = ArbitraryResampler(fs, 48000, channels=channels,
                                             quality=7)
            self._rs_fifo = np.zeros((self._in_rs.output_latency, channels),
                                     np.float64)
            self.set_bandwidth(min(self.bandwidth, self._BW_CAP[fs]))
            self.bandwidth_forced = False

    # -- ctl-equivalents ------------------------------------------------
    def set_bitrate(self, bitrate: int):
        self.bitrate = max(6000, min(bitrate, 510000 * self.channels))

    def set_vbr(self, vbr: bool):
        self.vbr = vbr

    def set_bandwidth(self, bw: Bandwidth):
        if self.fs != 48000:
            bw = min(bw, self._BW_CAP[self.fs])
        self.bandwidth = bw
        self.bandwidth_forced = True
        self.celt.end = {Bandwidth.NARROWBAND: 13,
                         Bandwidth.MEDIUMBAND: 17,  # CELT has no MB config
                         Bandwidth.WIDEBAND: 17,
                         Bandwidth.SUPERWIDEBAND: 19,
                         Bandwidth.FULLBAND: 21}[bw]

    def set_complexity(self, c: int):
        self.celt.complexity = max(0, min(10, c))

    def set_dred_duration(self, frames_10ms: int, model=None,
                          stats=None) -> None:
        """Enable DRED redundancy covering ~frames_10ms x 10 ms of past
        audio, embedded in each packet's padding as extension id 126
        (OPUS_SET_DRED_DURATION; reference opus_encoder.rs:1666 +
        dred_encoder.rs). model/stats default to synthetic weights when
        no trained blob is loaded."""
        frames_10ms = max(0, min(104, frames_10ms))
        self._dred_frames = frames_10ms
        if frames_10ms == 0:
            self._dred = None
            return
        from .dred import DredEncoder
        self._dred = DredEncoder(self.fs, self.channels, model=model,
                                 stats=stats,
                                 max_dframes=max(2, frames_10ms // 2))

    # -------------------------------------------------------------------
    def encode(self, pcm: np.ndarray, frame_size: int,
               max_bytes: int = 1275) -> bytes:
        """Encode one frame of float PCM (frame_size, channels) -> packet.

        frame_size is in samples at the API rate (2.5-120 ms)."""
        outer = not getattr(self, "_in_encode", False)
        self._in_encode = True
        try:
            pkt = self._encode_impl(pcm, frame_size, max_bytes)
        finally:
            if outer:
                self._in_encode = False
        if outer and getattr(self, "_dred", None) is not None \
                and len(pkt) > 1:
            # feed the DRED latent pipeline and embed the redundancy
            # payload as extension id 126 in the packet padding
            from .bitstream.extensions import ExtensionData, extensions_generate
            from .bitstream.packet import packet_get_nb_frames
            from .bitstream.repacketizer import opus_packet_pad_ext
            from .models.dred import DRED_EXTENSION_ID
            self._dred.frame(pcm if pcm.ndim == 2 else
                             np.asarray(pcm)[:, None])
            # pad_ext overhead: TOC padding signalling + length chain +
            # extension header (~6 bytes worst case for payloads <= 160).
            # Skip DRED entirely when the remaining budget can't fit the
            # minimum useful payload without exceeding the caller's
            # max_bytes (reference dred_encoder.rs caps against the same
            # budget rather than forcing a floor).
            _PAD_OVERHEAD = 6
            headroom = max_bytes - len(pkt) - _PAD_OVERHEAD
            payload = (self._dred.payload(max_bytes=min(160, headroom))
                       if headroom >= 32 else None)
            self._dred_last_payload = payload
            if payload is not None:
                nb = packet_get_nb_frames(pkt)
                blob = extensions_generate(
                    [ExtensionData(DRED_EXTENSION_ID, 0, payload)], nb)
                pkt = opus_packet_pad_ext(pkt, blob)
        return pkt

    def _encode_impl(self, pcm: np.ndarray, frame_size: int,
                     max_bytes: int = 1275) -> bytes:
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        if self.fs != 48000:
            # resample to the 48 kHz core; the primed FIFO turns each API
            # frame into exactly one 48k frame (integer 48000/fs ratios)
            if pcm.shape[0] != frame_size:
                raise ValueError("pcm length != frame_size")
            frame48 = frame_size * 48000 // self.fs
            if frame48 * self.fs != frame_size * 48000:
                raise ValueError("bad frame_size for API rate")
            self._rs_fifo = np.concatenate(
                [self._rs_fifo, self._in_rs.process(pcm)], axis=0)
            if self._rs_fifo.shape[0] < frame48:   # only possible on frame 0
                pad = frame48 - self._rs_fifo.shape[0]
                self._rs_fifo = np.concatenate(
                    [np.zeros((pad, self.channels)), self._rs_fifo], axis=0)
            pcm48 = self._rs_fifo[:frame48]
            self._rs_fifo = self._rs_fifo[frame48:]
            saved_fs = self.fs
            self.fs = 48000
            try:
                return self.encode(pcm48, frame48, max_bytes)
            finally:
                self.fs = saved_fs
        if frame_size in (3840, 4800, 5760):
            # 80/100/120 ms: encode 20 ms subframes and merge them into one
            # code-3 packet with the repacketizer (opus_encoder.rs multiframe)
            from .bitstream.repacketizer import Repacketizer
            rp = Repacketizer()
            for off in range(0, frame_size, 960):
                rp.cat(self.encode(pcm[off: off + 960], 960, max_bytes))
            return rp.out(min(65535, max_bytes * (frame_size // 960)))
        mode = self.force_mode or self.mode
        if (self.application == APP_AUDIO and self.force_mode is None
                and frame_size >= 960):
            # analysis-driven mode decision (run_analysis, opus_encoder.rs)
            from .analysis import TonalityAnalysisState, run_analysis
            if self.analysis_state is None:
                self.analysis_state = TonalityAnalysisState()
            self.analysis_info = run_analysis(self.analysis_state, pcm,
                                              frame_size, self.channels)
            info = self.analysis_info
            if info.valid:
                if info.music_prob > 0.5 or self.bitrate >= 64000 * self.channels:
                    mode = Mode.CELT
                elif self.bitrate >= 32000 and self.channels == 1:
                    mode = Mode.HYBRID
                else:
                    mode = Mode.SILK
        # DTX: during sustained silence emit TOC-only packets, refreshing
        # comfort noise every 400 ms (decide_dtx_mode, opus_encoder.rs:4365)
        if getattr(self, "dtx", False):
            energy = float(np.square(pcm).mean())
            if energy < 1e-7:
                self._dtx_count = getattr(self, "_dtx_count", 0) + 1
            else:
                self._dtx_count = 0
            frames_per_400ms = max(1, (self.fs * 2 // 5) // frame_size)
            if (self._dtx_count > 2
                    and (self._dtx_count - 3) % frames_per_400ms != 0):
                self.in_dtx = True
                if mode == Mode.CELT:
                    toc = celt_toc(frame_size, self.bandwidth, self.channels)
                else:
                    toc = silk_toc(max(frame_size, 480), Bandwidth.WIDEBAND,
                                   self.channels)
                return bytes([toc])
            self.in_dtx = False
        if mode == Mode.SILK and self.application == APP_VOIP \
                and self.bitrate >= 32000 * self.channels \
                and self.force_mode is None:
            mode = Mode.HYBRID  # mid/high-rate speech: SILK WB + CELT HF
        # input high-pass: VOIP runs a variable-cutoff (60-100 Hz) HP whose
        # corner tracks the voiced pitch; other applications DC-reject at
        # 3 Hz (opus_encoder.rs:2080-2530, silk/hp_variable_cutoff.rs)
        from .hp_filter import dc_reject, hp_cutoff
        if self.application == APP_VOIP:
            cutoff = self.hp_state.cutoff_hz(celt_only=mode == Mode.CELT)
            pcm = hp_cutoff(pcm, cutoff, self.hp_state.mem, self.fs)
        else:
            pcm = dc_reject(pcm, 3, self.hp_state.mem, self.fs)
        if mode == Mode.HYBRID:
            out = self._encode_hybrid(pcm, frame_size, max_bytes)
            self._update_hp_tracker()
            return out
        if mode == Mode.SILK:
            out = self._encode_silk(pcm, frame_size, max_bytes)
            self._update_hp_tracker()
            return out
        if frame_size not in (120, 240, 480, 960):
            raise NotImplementedError("2.5-20 ms frames (CELT) this round")
        # byte budget from bitrate (CBR semantics; VBR shrinks inside celt)
        nbytes = max(2, min(max_bytes,
                            (self.bitrate * frame_size) // (8 * self.fs)))
        self.celt.bitrate = self.bitrate
        self.celt.loss_rate = getattr(self, "packet_loss_perc", 0)
        self.celt.vbr = self.vbr
        payload = self.celt.encode_with_ec(pcm, frame_size,
                                           nbytes if not self.vbr else 1275)
        self.range_final = self.celt.rng
        toc = celt_toc(frame_size, self.bandwidth, self.channels)
        return bytes([toc]) + payload

    def _update_hp_tracker(self):
        """Feed the VOIP HP cutoff tracker from the last SILK frame's pitch
        decision (the encoder's mirror decoder state holds prev lag/type)."""
        worker = getattr(self, "_last_silk_worker", None)
        if worker is None:
            return
        mirror = getattr(worker, "mirror", None)
        if mirror is None:  # stereo worker: track the mid channel
            mirror = getattr(getattr(worker, "mid", None), "mirror", None)
        if mirror is not None and mirror.fs_khz > 0:
            self.hp_state.update_from_silk(mirror.prev_signal_type,
                                           mirror.lag_prev, mirror.fs_khz)

    def _silk_bandwidth_transition(self, worker, fs_khz: int) -> int:
        """Smooth NB/MB/WB switches with the variable-cutoff LP ramp.

        Parity: reference silk/control_audio_bandwidth.rs — a down-switch
        first narrows the input low-pass over the ramp (mode -2, staying at
        the old rate) and only then drops the internal rate; an up-switch
        raises the rate immediately and widens the filter back (mode 1)."""
        from .silk.lp_filter import TRANSITION_FRAMES

        lps = ([worker.lp] if hasattr(worker, "lp")
               else [worker.mid.lp, worker.side.lp])
        prev = getattr(worker, "_fs_prev", 0)
        lp0 = lps[0]
        if prev and fs_khz < prev:
            if lp0.mode == 0 and lp0.transition_frame_no <= 0:
                for lp in lps:  # start the narrowing ramp at the old rate
                    lp.transition_frame_no = TRANSITION_FRAMES
                    lp.in_lp_state = [0, 0]
                    lp.mode = -2
                fs_khz = prev
            elif lp0.mode != 0 and lp0.transition_frame_no > 0:
                fs_khz = prev  # ramp still in progress
            else:
                for lp in lps:  # ramp done: switch now
                    lp.mode = 0
        elif prev and fs_khz > prev:
            for lp in lps:  # switch up immediately, widen from narrow
                lp.transition_frame_no = 0
                lp.in_lp_state = [0, 0]
                lp.mode = 1
        elif prev and fs_khz == prev and lp0.mode < 0:
            for lp in lps:  # aborted down-switch: widen back
                lp.mode = 1
        if lp0.mode > 0 and lp0.transition_frame_no >= TRANSITION_FRAMES:
            for lp in lps:  # widening complete
                lp.mode = 0
        worker._fs_prev = fs_khz
        return fs_khz

    def _encode_silk(self, pcm: np.ndarray, frame_size: int,
                     max_bytes: int) -> bytes:
        from .bitstream.entcode import RangeEncoder
        from .silk.encoder import silk_encode_packet, _BudgetExceeded

        if frame_size not in (480, 960, 1920, 2880):
            raise NotImplementedError("SILK frames are 10/20/40/60 ms")
        bw = self.bandwidth
        if not getattr(self, "bandwidth_forced", False):
            # rate-driven internal bandwidth (control_audio_bandwidth.rs)
            if self.bitrate < 13000:
                bw = Bandwidth.NARROWBAND
            elif self.bitrate < 18000:
                bw = Bandwidth.MEDIUMBAND
            else:
                bw = Bandwidth.WIDEBAND
            bw = min(bw, self.bandwidth)
        fs_khz = _SILK_BW_TO_KHZ[bw]
        frame_ms = frame_size * 1000 // self.fs
        stereo_pre = self.channels == 2 and pcm.shape[1] == 2
        fs_khz = self._silk_bandwidth_transition(
            self.silk_stereo if stereo_pre else self.silk, fs_khz)
        bw = {8: Bandwidth.NARROWBAND, 12: Bandwidth.MEDIUMBAND,
              16: Bandwidth.WIDEBAND}[fs_khz]  # TOC matches the actual rate
        rate = self.bitrate
        if getattr(self, "energy_mask", None) is not None:
            # surround masking rate offset (opus_encoder.rs:1552,
            # applied to the SILK rate in encode_frame_native)
            rate = max(6000, rate + compute_surround_masking_rate_offset(
                self.energy_mask, bw, self.channels))
        target_bytes = (rate * frame_size) // (8 * self.fs)
        # VBR: the per-frame cap is elastic (reference VBR lets hard frames
        # exceed the nominal target and converges long-term through the
        # quantization gains; e.g. libopus ships ~35-byte frames at a
        # 12 kbps target on tonal input). CBR keeps the tight cap.
        if self.vbr:
            nbytes = max(10, min(max_bytes, target_bytes + target_bytes // 2
                                 + 20))
        else:
            nbytes = max(10, min(max_bytes, target_bytes + 10))
        stereo = self.channels == 2 and pcm.shape[1] == 2
        worker = self.silk_stereo if stereo else self.silk
        self._last_silk_worker = worker
        if not stereo:
            worker.fec_enabled = bool(getattr(self, "inband_fec", False)
                                      and getattr(self, "packet_loss_perc", 0)
                                      > 0)
        pcm_i = pcm[:, 0] * 32768.0
        if stereo:
            pcm_r = pcm[:, 1] * 32768.0
        # per-frame rate search: find the finest gain scale (coarsen) whose
        # packet fits the byte budget, so every frame lands just under the
        # budget instead of oscillating across frames
        snap = worker.snapshot()
        budget_bits = nbytes * 8
        base = getattr(worker, "coarsen_state", 1.0)
        if getattr(worker, "use_nsq_shaping", False):
            # the shaping path's gains already track the rate via
            # control_snr; coarsen is only a per-frame trim. An unclamped
            # carry-over lets silence refine it to ~0.05, and the next
            # speech onset then exhausts the escalation ladder into the
            # 1e4 mute slam -- decoded as a loud offset*gain noise burst
            # that LTP drags across the following frames.
            base = min(max(base, 0.5), 2.0)

        def attempt(c):
            worker.restore(snap)
            e = RangeEncoder(nbytes)
            try:
                if stereo:
                    worker.encode_packet(e, pcm_i, pcm_r, fs_khz, self.fs,
                                         frame_ms, self.bitrate, c)
                else:
                    silk_encode_packet(worker, e, pcm_i, fs_khz, self.fs,
                                       frame_ms, self.bitrate, c)
            except _BudgetExceeded:
                return None
            e.done()
            return None if e.get_error() else e

        c = max(0.05, base)
        enc = attempt(c)
        if enc is None and c < 1.0:
            # jump straight to the nominal scale before climbing the
            # ladder: a sub-1 starting point otherwise eats most steps
            # and the search slams into the 1e4 mute (decoded as a loud
            # offset*gain noise burst on speech onsets)
            c = 1.0
            enc = attempt(c)
        for step in range(10):
            if enc is not None:
                break
            c = 1e4 if (step >= 7 or c > 200) else c * 1.6
            enc = attempt(c)
        if enc is None:
            raise ValueError("silk rate control failed")
        # refine downward while there is unused TARGET budget (aim at the
        # nominal rate, not the elastic VBR cap)
        aim_bits = min(budget_bits, target_bytes * 8)
        best_c, last_was_best = c, True
        for _ in range(4):
            bits = enc.tell()
            if bits >= 0.72 * aim_bits or best_c <= 0.05:
                break
            c2 = max(0.05, best_c * max(0.5,
                                        (bits / (0.90 * aim_bits)) ** 1.2))
            if abs(c2 - best_c) / best_c < 0.05:
                break
            e2 = attempt(c2)
            if e2 is None:
                last_was_best = False
                break
            best_c, enc, last_was_best = c2, e2, True
        if not last_was_best:
            enc = attempt(best_c)
        worker.coarsen_state = max(0.05, min(best_c, 80.0))
        payload = enc.data()
        # trim unused trailing zero bytes (reading past the end yields the
        # same zeros, so the range-decode path is unchanged)
        used = max((enc.tell() + 7) >> 3, enc.offs)
        payload = payload[:max(used, 2)]
        self.range_final = enc.rng & 0xFFFFFFFF
        toc = silk_toc(frame_size, bw, self.channels)
        return bytes([toc]) + payload

    def _encode_hybrid(self, pcm: np.ndarray, frame_size: int,
                       max_bytes: int) -> bytes:
        """Hybrid mode: SILK codes 0-8 kHz (WB internal), CELT bands 17-21
        continue in the same range coder (reference opus_encoder.rs
        encode_frame_native hybrid path; decoder parity opus_decoder.rs)."""
        from .bitstream.entcode import RangeEncoder
        from .silk.encoder import silk_encode_packet, _BudgetExceeded

        if frame_size not in (480, 960):
            raise NotImplementedError("hybrid is 10/20 ms")
        bw = self.bandwidth
        if bw not in (Bandwidth.SUPERWIDEBAND, Bandwidth.FULLBAND):
            bw = Bandwidth.FULLBAND
        frame_ms = frame_size * 1000 // self.fs
        L = max(20, min(max_bytes,
                        (self.bitrate * frame_size) // (8 * self.fs)))
        # rate split (compute_silk_rate_for_hybrid simplified): SILK gets the
        # base share, shrinking as the total rate grows
        silk_share = 0.65 if self.bitrate < 40000 * self.channels else 0.55
        silk_bits_target = int(8 * L * silk_share)
        # elastic per-frame cap: hard frames may exceed the share target
        # as long as the CELT layer keeps a minimum allocation (reference
        # VBR behaviour); the refinement below still aims at the share
        silk_bits_cap = int(8 * L * 0.85)
        stereo = self.channels == 2 and pcm.shape[1] == 2
        worker = self.silk_stereo if stereo else self.silk
        self._last_silk_worker = worker
        if not stereo:
            worker.fec_enabled = False
        pcm_i = pcm[:, 0] * 32768.0
        if stereo:
            pcm_r = pcm[:, 1] * 32768.0

        snap = worker.snapshot()
        base = getattr(worker, "coarsen_state", 1.0)
        if getattr(worker, "use_nsq_shaping", False):
            base = min(max(base, 0.5), 2.0)  # see _encode_silk

        def attempt(c):
            worker.restore(snap)
            e = RangeEncoder(L)
            try:
                if stereo:
                    worker.encode_packet(e, pcm_i, pcm_r, 16, self.fs,
                                         frame_ms,
                                         int(self.bitrate * silk_share), c)
                else:
                    silk_encode_packet(worker, e, pcm_i, 16, self.fs,
                                       frame_ms,
                                       int(self.bitrate * silk_share), c)
            except _BudgetExceeded:
                return None
            if e.get_error() or e.tell() > silk_bits_cap:
                return None
            return e

        c = max(0.05, base)
        enc = attempt(c)
        if enc is None and c < 1.0:
            # jump straight to the nominal scale before climbing the
            # ladder: a sub-1 starting point otherwise eats most steps
            # and the search slams into the 1e4 mute (decoded as a loud
            # offset*gain noise burst on speech onsets)
            c = 1.0
            enc = attempt(c)
        for step in range(10):
            if enc is not None:
                break
            c = 1e4 if (step >= 7 or c > 200) else c * 1.6
            enc = attempt(c)
        if enc is None:
            raise ValueError("hybrid silk rate control failed")
        best_c = c
        for _ in range(3):
            bits = enc.tell()
            if bits >= 0.8 * silk_bits_target or best_c <= 0.05:
                break
            c2 = max(0.05, best_c * max(0.5,
                                        (bits / (0.92 * silk_bits_target))
                                        ** 1.2))
            if abs(c2 - best_c) / best_c < 0.05:
                break
            e2 = attempt(c2)
            if e2 is None:
                enc = attempt(best_c)
                break
            best_c, enc = c2, e2
        worker.coarsen_state = max(0.05, min(best_c, 80.0))

        # redundancy flag: written iff the decoder will look for it
        if enc.tell() + 37 <= 8 * L:
            enc.enc_bit_logp(0, 12)

        # CELT high bands continue in the same range coder
        self.celt.start = 17
        self.celt.end = 19 if bw == Bandwidth.SUPERWIDEBAND else 21
        self.celt.stream_channels = self.channels
        self.celt.bitrate = -1  # fill the remaining packet exactly
        self.celt.encode_with_ec(pcm, frame_size, L, enc=enc)
        enc.done()
        if enc.get_error():
            raise ValueError("hybrid celt overflow")
        payload = enc.data()[:L]
        self.range_final = enc.rng & 0xFFFFFFFF
        toc = hybrid_toc(frame_size, bw, self.channels)
        return bytes([toc]) + payload

    # -- sample-format wrappers (opus_encode / opus_encode24 parity) -----
    def encode_int16(self, pcm16: np.ndarray, frame_size: int,
                     max_bytes: int = 1275) -> bytes:
        """opus_encode: int16 input."""
        return self.encode(np.asarray(pcm16, np.float64) / 32768.0,
                           frame_size, max_bytes)

    def encode_int24(self, pcm24: np.ndarray, frame_size: int,
                     max_bytes: int = 1275) -> bytes:
        """opus_encode24: signed 24-bit-in-int32 input."""
        return self.encode(np.asarray(pcm24, np.float64) / (32768.0 * 256.0),
                           frame_size, max_bytes)

    @property
    def final_range(self) -> int:
        return self.range_final
