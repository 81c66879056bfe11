"""Lightweight SILK-only decode path (second API shape).

Mirrors the reference's minimal Ogg-SILK pipeline (src/decoder.rs:137,220;
src/resample.rs:3; src/bitdepth.rs:15): TOC parse restricted to SILK
configurations, standalone SILK decode at the internal rate, then a 3x
sample-repeat upsample to 48 kHz with float/int16/int24 output converters.
Runs over the same SILK decoder as the full Opus path (SURVEY.md §2.3:
"implement ONE SILK decoder and expose both API shapes over it")."""

from __future__ import annotations

import math

import numpy as np

from .bitstream.entcode import RangeDecoder
from .bitstream.packet import Bandwidth, Mode, toc_bandwidth, toc_channels, toc_mode
from .silk.dec_api import DecControl, silk_decode
from .silk.structs import SilkDecoder

UPSAMPLE_FACTOR = 3
SILK_FRAME_SAMPLES = 320  # 20 ms at 16 kHz


class LightweightError(ValueError):
    pass


def resample_up(x: np.ndarray, factor: int = UPSAMPLE_FACTOR) -> np.ndarray:
    """Zero-order-hold upsample: each sample repeated `factor` times."""
    return np.repeat(np.asarray(x), factor, axis=0)


def float32_to_s16_le(x: np.ndarray, factor: int = 1) -> bytes:
    """float -> int16 LE bytes via floor(sample * 32767), repeated."""
    v = np.floor(np.asarray(x, np.float64) * 32767.0).astype(np.int32)
    v = np.clip(v, -32768, 32767).astype("<i2")
    return np.repeat(v, factor, axis=0).tobytes()


def float32_to_s24(x: np.ndarray, factor: int = 1) -> np.ndarray:
    """float -> signed 24-bit in int32 (round-to-nearest, RES2INT24)."""
    v = np.rint(np.asarray(x, np.float64) * 32768.0 * 256.0).astype(np.int64)
    v = np.clip(v, -(1 << 23), (1 << 23) - 1).astype(np.int32)
    return np.repeat(v, factor, axis=0)


class LightweightDecoder:
    """SILK-only packet decoder producing 48 kHz output by 3x repetition."""

    def __init__(self):
        self.silk = SilkDecoder()
        self.ctl = DecControl()
        self._buffer = None  # last decoded internal-rate float frame

    def _decode_internal(self, packet: bytes):
        if len(packet) < 1:
            raise LightweightError("too short for TOC")
        toc = packet[0]
        if toc_mode(toc) != Mode.SILK:
            raise LightweightError("configuration is not SILK-only")
        if toc & 0x3:
            raise LightweightError(f"unsupported frame code {toc & 0x3}")
        bandwidth = toc_bandwidth(toc)
        channels = toc_channels(toc)
        fs_int = {Bandwidth.NARROWBAND: 8000,
                  Bandwidth.MEDIUMBAND: 12000}.get(bandwidth, 16000)
        config = (toc >> 3) & 0x1F
        frame_ms = (10, 20, 40, 60)[config & 0x3]
        ctl = self.ctl
        ctl.n_channels_api = channels
        ctl.n_channels_internal = channels
        ctl.api_sample_rate = fs_int
        ctl.internal_sample_rate = fs_int
        ctl.payload_size_ms = min(frame_ms, 20)
        dec = RangeDecoder(packet[1:])
        out = []
        done_ms = 0
        first = True
        while done_ms < frame_ms:
            out.extend(silk_decode(self.silk, ctl, 0, first, dec))
            first = False
            done_ms += ctl.payload_size_ms
        pcm = np.asarray(out, np.float64).reshape(-1, channels) / 32768.0
        self._buffer = pcm.astype(np.float32)
        return bandwidth, channels == 2

    def decode_float32(self, packet: bytes):
        """Returns (bandwidth, stereo, float32 pcm upsampled 3x)."""
        bw, stereo = self._decode_internal(packet)
        return bw, stereo, resample_up(self._buffer)

    def decode(self, packet: bytes):
        """Returns (bandwidth, stereo, int16 LE bytes upsampled 3x)."""
        bw, stereo = self._decode_internal(packet)
        return bw, stereo, float32_to_s16_le(self._buffer, UPSAMPLE_FACTOR)

    def decode_int24(self, packet: bytes):
        """Returns (bandwidth, stereo, int24-in-int32 upsampled 3x)."""
        bw, stereo = self._decode_internal(packet)
        return bw, stereo, float32_to_s24(self._buffer, UPSAMPLE_FACTOR)
