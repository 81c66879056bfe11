"""Opus decoder top level: mode demux, SILK+CELT glue, transitions, PLC.

Parity: reference `src/opus_decoder.rs` (OpusDecoder:200, decode_frame:453,
opus_decode_native:1605), following libopus 1.3.1 float semantics.
"""

from __future__ import annotations

import numpy as np

from .bitstream.entcode import RangeDecoder
from .bitstream.packet import (Bandwidth, Mode, parse_packet, samples_per_frame,
                               toc_bandwidth, toc_channels, toc_mode)
from .celt.decoder import CeltDecoder
from .celt.modes import opus_custom_mode
from .silk.dec_api import (FLAG_DECODE_LBRR, FLAG_DECODE_NORMAL,
                           FLAG_PACKET_LOST, silk_decode)
from .silk.structs import DecControl, SilkDecoder


class OpusDecoder:
    def __init__(self, fs: int = 48000, channels: int = 2):
        if fs not in (8000, 12000, 16000, 24000, 48000) or channels not in (1, 2):
            raise ValueError("bad decoder config")
        self.fs = fs
        self.channels = channels
        self.celt_mode = opus_custom_mode()
        self._reset()

    def _reset(self):
        self.silk = SilkDecoder()
        self.dec_control = DecControl(api_sample_rate=self.fs,
                                      n_channels_api=self.channels)
        self.celt = CeltDecoder(channels=self.channels,
                                stream_channels=self.channels,
                                downsample=48000 // self.fs,
                                disable_inv=self.channels == 1)
        self.stream_channels = self.channels
        self.bandwidth = 0
        self.mode = 0
        self.prev_mode = 0
        self.frame_size = self.fs // 50
        self.prev_redundancy = False
        self.last_packet_duration = 0
        self.decode_gain = 0
        self.range_final = 0
        self.softclip_mem = np.zeros(2, np.float32)

    # ------------------------------------------------------------------
    def _celt_reset(self):
        self.celt = CeltDecoder(channels=self.channels,
                                stream_channels=self.celt.stream_channels,
                                downsample=48000 // self.fs,
                                start=self.celt.start, end=self.celt.end,
                                disable_inv=self.channels == 1)

    def _silk_reset(self):
        self.silk = SilkDecoder()

    def _decode_frame(self, data: bytes | None, frame_size: int) -> np.ndarray:
        """Decode one frame (or PLC when data None); returns (N, channels) f64."""
        F20 = self.fs // 50
        F10 = F20 >> 1
        F5 = F10 >> 1
        F2_5 = F5 >> 1
        if frame_size < F2_5:
            raise ValueError("buffer too small")

        if data is not None and len(data) <= 1:
            data = None
            frame_size = min(frame_size, self.frame_size)

        if data is not None:
            audiosize = self.frame_size
            mode = self.mode
            bandwidth = self.bandwidth
            dec = RangeDecoder(data)
        else:
            # PLC
            audiosize = frame_size
            mode = self.prev_mode
            bandwidth = 0
            if mode == 0:
                # Decoder just initialized: return silence
                return np.zeros((audiosize, self.channels))
            while audiosize > F20:
                upper = self._decode_frame(None, F20)
                rest = self._decode_frame(None, audiosize - F20)
                return np.concatenate([upper, rest])
            dec = None

        transition = False
        pcm_transition = None
        if (data is not None and self.prev_mode > 0 and (
                (mode == Mode.CELT and self.prev_mode != Mode.CELT
                 and not self.prev_redundancy)
                or (mode != Mode.CELT and self.prev_mode == Mode.CELT))):
            transition = True
            if mode == Mode.CELT:
                pcm_transition = self._decode_frame(None, min(F5, audiosize))

        if audiosize > frame_size:
            raise ValueError("bad arg")
        frame_size = audiosize

        pcm_silk = None
        length = len(data) if data is not None else 0

        # --- SILK ---
        if mode != Mode.CELT:
            if self.prev_mode == Mode.CELT:
                self._silk_reset()
            ctl = self.dec_control
            ctl.payload_size_ms = max(10, 1000 * audiosize // self.fs)
            if data is not None:
                ctl.n_channels_internal = self.stream_channels
                if mode == Mode.SILK:
                    ctl.internal_sample_rate = {
                        Bandwidth.NARROWBAND: 8000,
                        Bandwidth.MEDIUMBAND: 12000,
                    }.get(bandwidth, 16000)
                else:
                    ctl.internal_sample_rate = 16000
            ctl.n_channels_api = self.channels
            lost_flag = FLAG_PACKET_LOST if data is None else FLAG_DECODE_NORMAL
            decoded = []
            decoded_samples = 0
            while decoded_samples < frame_size:
                first = decoded_samples == 0
                out = silk_decode(self.silk, ctl, lost_flag, first, dec)
                n = len(out) // self.channels
                decoded.extend(out)
                decoded_samples += n
            pcm_silk = np.array(decoded, np.float64).reshape(-1, self.channels)

        # --- redundancy detection ---
        redundancy = False
        celt_to_silk = False
        redundancy_bytes = 0
        if (mode != Mode.CELT and data is not None
                and dec.tell() + 17 + 20 * (mode == Mode.HYBRID) <= 8 * length):
            if mode == Mode.HYBRID:
                redundancy = bool(dec.dec_bit_logp(12))
            else:
                redundancy = True
            if redundancy:
                celt_to_silk = bool(dec.dec_bit_logp(1))
                if mode == Mode.HYBRID:
                    redundancy_bytes = dec.dec_uint(256) + 2
                else:
                    redundancy_bytes = length - ((dec.tell() + 7) >> 3)
                length -= redundancy_bytes
                if length * 8 < dec.tell():
                    length = 0
                    redundancy_bytes = 0
                    redundancy = False
                dec.storage -= redundancy_bytes

        start_band = 0 if mode == Mode.CELT else 17

        if redundancy:
            transition = False

        if transition and mode != Mode.CELT:
            pcm_transition = self._decode_frame(None, min(F5, audiosize))

        if bandwidth:
            endband = {Bandwidth.NARROWBAND: 13, Bandwidth.MEDIUMBAND: 17,
                       Bandwidth.WIDEBAND: 17, Bandwidth.SUPERWIDEBAND: 19,
                       Bandwidth.FULLBAND: 21}[bandwidth]
            self.celt.end = endband
        self.celt.stream_channels = self.stream_channels

        window = self.celt_mode.window

        redundant_audio = None
        redundant_rng = 0
        if redundancy and celt_to_silk:
            self.celt.start = 0
            redundant_audio = self.celt.decode_with_ec(
                data[length: length + redundancy_bytes], F5)
            redundant_rng = self.celt.rng

        self.celt.start = start_band

        pcm = np.zeros((frame_size, self.channels))
        if mode != Mode.SILK:
            celt_frame_size = min(F20, frame_size)
            if mode != self.prev_mode and self.prev_mode > 0 and not self.prev_redundancy:
                self._celt_reset()
            celt_out = self.celt.decode_with_ec(
                data, celt_frame_size, dec=dec if data is not None else None)
            pcm[:celt_frame_size] = celt_out
        else:
            if self.prev_mode == Mode.HYBRID and not (
                    redundancy and celt_to_silk and self.prev_redundancy):
                # Let the CELT MDCT fade out by decoding a silence frame
                self.celt.start = 0
                pcm[:F2_5] = self.celt.decode_with_ec(b"\xff\xff", F2_5)

        if mode != Mode.CELT and pcm_silk is not None:
            pcm[:frame_size] += pcm_silk[:frame_size] / 32768.0

        if redundancy and not celt_to_silk:
            self._celt_reset()
            self.celt.start = 0
            redundant_audio = self.celt.decode_with_ec(
                data[length: length + redundancy_bytes], F5)
            redundant_rng = self.celt.rng
            self._smooth_fade(pcm[frame_size - F2_5:],
                              redundant_audio[F2_5: 2 * F2_5],
                              pcm[frame_size - F2_5:], F2_5, window)
        if redundancy and celt_to_silk:
            pcm[:F2_5] = redundant_audio[:F2_5]
            self._smooth_fade(redundant_audio[F2_5: 2 * F2_5], pcm[F2_5: F5].copy(),
                              pcm[F2_5: F5], F2_5, window)
        if transition:
            if audiosize >= F5:
                pcm[:F2_5] = pcm_transition[:F2_5]
                self._smooth_fade(pcm_transition[F2_5: F5], pcm[F2_5: F5].copy(),
                                  pcm[F2_5: F5], F2_5, window)
            else:
                self._smooth_fade(pcm_transition[:F2_5], pcm[:F2_5].copy(),
                                  pcm[:F2_5], F2_5, window)

        if self.decode_gain:
            pcm *= 2.0 ** (6.48814081e-4 * self.decode_gain)

        if data is None or len(data) <= 1:
            self.range_final = 0
        else:
            self.range_final = (dec.rng ^ redundant_rng) & 0xFFFFFFFF

        self.prev_mode = mode
        self.prev_redundancy = redundancy and not celt_to_silk
        return pcm[:audiosize]

    @staticmethod
    def _smooth_fade(in1, in2, out, overlap, window):
        inc = 1  # 48 kHz decoder
        w = window[np.arange(overlap) * inc] ** 2
        out[:] = (w[:, None] * in2[:overlap]) + ((1.0 - w)[:, None] * in1[:overlap])

    # ------------------------------------------------------------------
    def set_deep_plc(self, fargan_model, pitch_model=None) -> None:
        """Enable neural concealment (SetDnnBlob ctl equivalent): loads the
        FARGAN vocoder (+PitchDNN) used instead of classic PLC on loss
        (reference deep_plc.rs lpcnet_plc_conceal)."""
        from .models.deep_plc import DeepPlcState
        self.deep_plc = DeepPlcState(fargan_model=fargan_model,
                                     pitch_model=pitch_model)

    def inject_dred_features(self, features_list) -> None:
        """Queue DRED-recovered feature vectors for upcoming losses."""
        if getattr(self, "deep_plc", None) is not None:
            self.deep_plc.inject_fec_features(features_list)

    # -- DRED public surface (reference src/dred.rs:463,509,608) --------
    def set_dred_models(self, dec_model=None, stats=None) -> None:
        """Install the RDOVAE decoder model + quantization stats used by
        dred_parse/dred_process (defaults: synthetic weights)."""
        self._dred_dec_model = dec_model
        self._dred_stats = stats

    def dred_parse(self, data: bytes):
        """opus_dred_parse: extract the DRED extension (id 126) from a
        packet's padding; returns OpusDred or None."""
        from .dred import opus_dred_parse
        return opus_dred_parse(data, getattr(self, "_dred_stats", None))

    def dred_process(self, dred):
        """opus_dred_process: RDOVAE-decode the latents into chronological
        10 ms feature vectors (fills dred.features)."""
        from .dred import opus_dred_process
        return opus_dred_process(dred,
                                 getattr(self, "_dred_dec_model", None),
                                 getattr(self, "_dred_stats", None))

    def dred_decode(self, dred, dred_offset_10ms: int,
                    frame_size: int) -> np.ndarray:
        """opus_decoder_dred_decode: synthesize PCM for a lost span using
        DRED-recovered features ending dred_offset_10ms x 10 ms before
        the packet that carried them. Requires set_deep_plc()."""
        if getattr(self, "deep_plc", None) is None:
            raise RuntimeError("dred_decode requires set_deep_plc()")
        if dred.features is None:
            self.dred_process(dred)
        n10 = frame_size * 100 // self.fs
        feats = dred.features
        # select the span covering the lost frames: features are
        # chronological and end dred_offset_10ms x 10 ms before "now"
        end = len(feats) - dred_offset_10ms
        take = feats[max(0, end - n10): end] if end > 0 else []
        self.deep_plc.inject_fec_features(list(take))
        return self.decode(None, frame_size)

    def _deep_plc_conceal(self, frame_size: int) -> np.ndarray:
        """Neural concealment: FARGAN at 16 kHz, repeated up to fs, blended
        into the classic PLC over 2.5 ms for continuity."""
        classic = []
        count = 0
        while count < frame_size:
            r = self._decode_frame(None, frame_size - count)
            classic.append(r)
            count += len(r)
        classic = np.concatenate(classic)
        n16 = frame_size * 16000 // self.fs
        n16 = max(160, (n16 // 160) * 160)
        neural = self.deep_plc.conceal(n16)
        rep = self.fs // 16000
        neural_up = np.repeat(neural, rep)[:frame_size]
        out = np.tile(neural_up[:, None], (1, self.channels))
        f5 = min(self.fs // 400, frame_size)
        ramp = np.linspace(0.0, 1.0, f5)[:, None]
        out[:f5] = (1 - ramp) * classic[:f5] + ramp * out[:f5]
        return out

    def decode(self, data: bytes | None, frame_size: int,
               decode_fec: bool = False) -> np.ndarray:
        """Decode an Opus packet -> float PCM array (N, channels)."""
        if data is None or len(data) == 0:
            if frame_size % (self.fs // 400) != 0:
                raise ValueError("bad PLC size")
            if getattr(self, "deep_plc", None) is not None:
                out = self._deep_plc_conceal(frame_size)
                self.last_packet_duration = frame_size
                return out
            out = []
            count = 0
            while count < frame_size:
                r = self._decode_frame(None, frame_size - count)
                out.append(r)
                count += len(r)
            self.last_packet_duration = count
            return np.concatenate(out)

        deep = getattr(self, "deep_plc", None)
        packet_mode = toc_mode(data[0])
        packet_bandwidth = toc_bandwidth(data[0])
        packet_frame_size = samples_per_frame(data, self.fs)
        packet_stream_channels = toc_channels(data[0])
        parsed = parse_packet(data)
        frames = parsed.frames
        count = len(frames)

        if decode_fec:
            if (frame_size < packet_frame_size or packet_mode == Mode.CELT
                    or self.mode == Mode.CELT):
                return self.decode(None, frame_size)
            dur = self.last_packet_duration
            outs = []
            if frame_size - packet_frame_size != 0:
                outs.append(self.decode(None, frame_size - packet_frame_size))
            self.mode = packet_mode
            self.bandwidth = packet_bandwidth
            self.frame_size = packet_frame_size
            self.stream_channels = packet_stream_channels
            outs.append(self._decode_fec_frame(frames[0], packet_frame_size))
            self.last_packet_duration = frame_size
            return np.concatenate(outs)

        if count * packet_frame_size > frame_size:
            raise ValueError("buffer too small")

        self.mode = packet_mode
        self.bandwidth = packet_bandwidth
        self.frame_size = packet_frame_size
        self.stream_channels = packet_stream_channels

        outs = []
        for f in frames:
            outs.append(self._decode_frame(f, packet_frame_size))
        result = np.concatenate(outs)
        self.last_packet_duration = len(result)
        if deep is not None:
            # feature tracking over good audio (10 ms hops at 16 kHz)
            mono16 = result.mean(axis=1)[:: self.fs // 16000]
            deep.update(mono16)
        return result

    def _decode_fec_frame(self, data: bytes, frame_size: int) -> np.ndarray:
        """Decode the LBRR data from a packet (decode_fec=1 path)."""
        F20 = self.fs // 50
        mode = self.mode
        dec = RangeDecoder(data)
        ctl = self.dec_control
        ctl.payload_size_ms = max(10, 1000 * frame_size // self.fs)
        ctl.n_channels_internal = self.stream_channels
        ctl.n_channels_api = self.channels
        if mode == Mode.SILK:
            ctl.internal_sample_rate = {
                Bandwidth.NARROWBAND: 8000,
                Bandwidth.MEDIUMBAND: 12000,
            }.get(self.bandwidth, 16000)
        else:
            ctl.internal_sample_rate = 16000
        if self.prev_mode == Mode.CELT:
            self._silk_reset()
        decoded = []
        decoded_samples = 0
        while decoded_samples < frame_size:
            first = decoded_samples == 0
            out = silk_decode(self.silk, ctl, FLAG_DECODE_LBRR, first, dec)
            n = len(out) // self.channels
            decoded.extend(out)
            decoded_samples += n
        pcm = np.array(decoded, np.float64).reshape(-1, self.channels) / 32768.0
        self.prev_mode = mode
        return pcm[:frame_size]

    # -- sample-format wrappers (opus_decode / opus_decode24 parity) -----
    def decode_int16(self, data: bytes | None, frame_size: int,
                     decode_fec: bool = False) -> np.ndarray:
        """opus_decode: int16 output. The float build soft-clips out-of-range
        samples before requantizing (opus_decoder.rs opus_decode ->
        opus_pcm_soft_clip) so overloads distort gracefully instead of
        wrapping; the clip memory carries across calls."""
        from .softclip import opus_pcm_soft_clip

        pcm = self.decode(data, frame_size, decode_fec)
        if not hasattr(self, "_declip_mem"):
            self._declip_mem = np.zeros(pcm.shape[1] if pcm.ndim > 1 else 1)
        pcm = opus_pcm_soft_clip(pcm, self._declip_mem)
        return np.clip(np.rint(pcm * 32768.0), -32768, 32767).astype(np.int16)

    def decode_int24(self, data: bytes | None, frame_size: int,
                     decode_fec: bool = False) -> np.ndarray:
        """opus_decode24: signed 24-bit samples stored in int32."""
        pcm = self.decode(data, frame_size, decode_fec)
        v = np.rint(pcm * (32768.0 * 256.0))
        return np.clip(v, -(1 << 23), (1 << 23) - 1).astype(np.int32)

    @property
    def final_range(self) -> int:
        return self.range_final
