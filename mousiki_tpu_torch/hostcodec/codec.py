"""High-level typed API (parity: reference src/codec.rs Encoder/Decoder +
setters with Application/Channels/Bitrate/Bandwidth/Signal/FrameDuration
enums, re-exported at crate root; lib.rs:67-73)."""

from __future__ import annotations

import enum

import numpy as np

from .bitstream.packet import Bandwidth as _Bw
from .opus_decoder import OpusDecoder
from .opus_encoder import OpusEncoder


class Application(enum.IntEnum):
    VOIP = 2048
    AUDIO = 2049
    RESTRICTED_LOWDELAY = 2051


class Channels(enum.IntEnum):
    MONO = 1
    STEREO = 2


class Bandwidth(enum.IntEnum):
    NARROWBAND = 1101
    MEDIUMBAND = 1102
    WIDEBAND = 1103
    SUPERWIDEBAND = 1104
    FULLBAND = 1105


class Signal(enum.IntEnum):
    AUTO = -1000
    VOICE = 3001
    MUSIC = 3002


class FrameDuration(enum.IntEnum):
    MS_2_5 = 120
    MS_5 = 240
    MS_10 = 480
    MS_20 = 960
    MS_40 = 1920
    MS_60 = 2880


class Bitrate:
    """Bitrate in bits/s, or AUTO/MAX sentinels."""
    AUTO = -1000
    MAX = -1

    def __init__(self, bps: int):
        self.bps = bps


class Encoder:
    """Typed encoder facade over OpusEncoder (chainable setters)."""

    def __init__(self, sample_rate: int = 48000,
                 channels: Channels = Channels.STEREO,
                 application: Application = Application.AUDIO):
        self._enc = OpusEncoder(sample_rate, int(channels), int(application))
        self.sample_rate = sample_rate
        self.channels = Channels(channels)

    def set_bitrate(self, bps: int) -> "Encoder":
        self._enc.set_bitrate(bps)
        return self

    def set_bandwidth(self, bw: Bandwidth) -> "Encoder":
        self._enc.set_bandwidth(_Bw(int(bw)))
        return self

    def set_vbr(self, vbr: bool) -> "Encoder":
        self._enc.set_vbr(vbr)
        return self

    def set_complexity(self, c: int) -> "Encoder":
        self._enc.set_complexity(c)
        return self

    def encode_float(self, pcm: np.ndarray, frame_size: int) -> bytes:
        return self._enc.encode(np.asarray(pcm, np.float64), frame_size)

    def encode(self, pcm_i16: np.ndarray, frame_size: int) -> bytes:
        return self.encode_float(np.asarray(pcm_i16, np.float64) / 32768.0,
                                 frame_size)

    @property
    def final_range(self) -> int:
        return self._enc.final_range


class Decoder:
    """Typed decoder facade over OpusDecoder."""

    def __init__(self, sample_rate: int = 48000,
                 channels: Channels = Channels.STEREO):
        self._dec = OpusDecoder(sample_rate, int(channels))
        self.sample_rate = sample_rate
        self.channels = Channels(channels)

    def decode_float(self, packet: bytes | None, frame_size: int,
                     fec: bool = False) -> np.ndarray:
        return self._dec.decode(packet, frame_size, decode_fec=fec)

    def decode(self, packet: bytes | None, frame_size: int,
               fec: bool = False) -> np.ndarray:
        f = self.decode_float(packet, frame_size, fec)
        return np.clip(np.rint(f * 32768.0), -32768, 32767).astype(np.int16)

    def reset(self) -> None:
        self._dec._reset()

    def set_gain(self, gain_q8: int) -> None:
        self._dec.decode_gain = gain_q8

    @property
    def final_range(self) -> int:
        return self._dec.final_range

    @property
    def last_packet_duration(self) -> int:
        return self._dec.last_packet_duration
