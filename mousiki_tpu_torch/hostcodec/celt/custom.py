"""Custom-mode CELT API: non-48k rates / non-2.5-20 ms frame sizes.

Mirrors the reference's `custom_modes` feature surface
(src/celt/modes.rs:592 opus_custom_mode_create, celt_decoder.rs:4158
opus_custom_decode/float, celt_encoder.rs opus_custom_encode): a CELT
mode built for any 8-96 kHz rate and any even 40-1024-sample frame,
with encoder/decoder wrappers fixed to that mode. Custom streams are
NOT Opus-compatible (no TOC framing; both ends must share the mode) —
same contract as the reference feature.
"""

from __future__ import annotations

import numpy as np

from .decoder import CeltDecoder
from .encoder import CeltEncoder
from .modes import CeltMode, opus_custom_mode


def opus_custom_mode_create(fs: int, frame_size: int) -> CeltMode:
    """Build (or fetch the cached) mode for fs/frame_size.

    Raises ValueError for configurations the reference also rejects
    (rate outside 8-96 kHz, odd or out-of-range frame, >3.3 ms short
    blocks, degenerate band layouts)."""
    return opus_custom_mode(fs, frame_size)


class OpusCustomEncoder:
    """opus_custom_encoder_create + opus_custom_encode[_float]."""

    def __init__(self, mode: CeltMode, channels: int):
        if channels not in (1, 2):
            raise ValueError("channels must be 1 or 2")
        self.mode = mode
        self.channels = channels
        self._enc = CeltEncoder(mode=mode, channels=channels,
                                stream_channels=channels,
                                end=mode.num_ebands)

    @property
    def final_range(self) -> int:
        return self._enc.rng

    def reset(self) -> None:
        self._enc = CeltEncoder(mode=self.mode, channels=self.channels,
                                stream_channels=self.channels,
                                end=self.mode.num_ebands)

    def encode_float(self, pcm: np.ndarray, max_bytes: int) -> bytes:
        """pcm: (frame_size, channels) float in [-1, 1] (or flat
        interleaved). Returns the compressed frame (<= max_bytes)."""
        frame = self.mode.frame_size(self.mode.max_lm)
        pcm = np.asarray(pcm, np.float64)
        if pcm.ndim == 1:
            pcm = pcm.reshape(-1, self.channels)
        for lm in range(self.mode.max_lm + 1):
            if self.mode.frame_size(lm) == pcm.shape[0]:
                frame = pcm.shape[0]
                break
        else:
            raise ValueError(f"bad frame size {pcm.shape[0]}")
        return self._enc.encode_with_ec(pcm, frame,
                                        nb_compressed_bytes=max_bytes)

    def encode(self, pcm16: np.ndarray, max_bytes: int) -> bytes:
        """int16 entry point (opus_custom_encode)."""
        x = np.asarray(pcm16, np.int16).astype(np.float64) / 32768.0
        return self.encode_float(x, max_bytes)


class OpusCustomDecoder:
    """opus_custom_decoder_create + opus_custom_decode[_float]."""

    def __init__(self, mode: CeltMode, channels: int):
        if channels not in (1, 2):
            raise ValueError("channels must be 1 or 2")
        self.mode = mode
        self.channels = channels
        self._dec = CeltDecoder(mode=mode, channels=channels,
                                stream_channels=channels,
                                end=mode.num_ebands)
        self._dec.disable_inv = channels == 1

    @property
    def final_range(self) -> int:
        return self._dec.rng

    def reset(self) -> None:
        self._dec = CeltDecoder(mode=self.mode, channels=self.channels,
                                stream_channels=self.channels,
                                end=self.mode.num_ebands)
        self._dec.disable_inv = self.channels == 1

    def decode_float(self, data: bytes | None,
                     frame_size: int | None = None) -> np.ndarray:
        """data=None conceals a lost frame (PLC). Returns
        (frame_size, channels) float32."""
        if frame_size is None:
            frame_size = self.mode.frame_size(self.mode.max_lm)
        pcm = self._dec.decode_with_ec(data, frame_size)
        return np.asarray(pcm, np.float32)

    def decode(self, data: bytes | None,
               frame_size: int | None = None) -> np.ndarray:
        """int16 entry point (opus_custom_decode)."""
        f = self.decode_float(data, frame_size)
        return np.clip(np.rint(f * 32768.0), -32768, 32767).astype(np.int16)
