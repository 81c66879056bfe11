"""Differential-testing oracle: ctypes bindings to the system libopus.

Used ONLY by tests/tools to generate packets and golden PCM for comparing
against our from-scratch implementation (the reference repo does the same
with its `ctests/` C harnesses against opus-c — SURVEY.md §4.3). Gracefully
unavailable if the shared library is missing.
"""

from __future__ import annotations

import ctypes as C
import ctypes.util

import numpy as np

# --- constants (opus_defines.h, normative public API values) -------------
OPUS_OK = 0
APP_VOIP = 2048
APP_AUDIO = 2049
APP_RESTRICTED_LOWDELAY = 2051

BANDWIDTH_NARROWBAND = 1101
BANDWIDTH_MEDIUMBAND = 1102
BANDWIDTH_WIDEBAND = 1103
BANDWIDTH_SUPERWIDEBAND = 1104
BANDWIDTH_FULLBAND = 1105

SET_APPLICATION = 4000
SET_BITRATE = 4002
SET_MAX_BANDWIDTH = 4004
SET_VBR = 4006
SET_BANDWIDTH = 4008
SET_COMPLEXITY = 4010
SET_INBAND_FEC = 4012
SET_PACKET_LOSS_PERC = 4014
SET_DTX = 4016
SET_VBR_CONSTRAINT = 4020
SET_FORCE_CHANNELS = 4022
SET_SIGNAL = 4024
GET_LOOKAHEAD = 4027
RESET_STATE = 4028
GET_FINAL_RANGE = 4031
GET_PITCH = 4033
SET_GAIN = 4034
SET_LSB_DEPTH = 4036
SET_EXPERT_FRAME_DURATION = 4040
SET_PREDICTION_DISABLED = 4042
SET_PHASE_INVERSION_DISABLED = 4046

SIGNAL_VOICE = 3001
SIGNAL_MUSIC = 3002

# private but stable across libopus versions; used to pin the mode in tests
SET_FORCE_MODE = 11002
MODE_SILK_ONLY = 1000
MODE_HYBRID = 1001
MODE_CELT_ONLY = 1002

FRAMESIZE_ARG = 5000
FRAMESIZE_2_5_MS = 5001
FRAMESIZE_5_MS = 5002
FRAMESIZE_10_MS = 5003
FRAMESIZE_20_MS = 5004
FRAMESIZE_40_MS = 5005
FRAMESIZE_60_MS = 5006
FRAMESIZE_80_MS = 5007
FRAMESIZE_100_MS = 5008
FRAMESIZE_120_MS = 5009


def _load():
    for name in ("libopus.so.0", "libopus.so", ctypes.util.find_library("opus")):
        if not name:
            continue
        try:
            lib = C.CDLL(name)
        except OSError:
            continue
        lib.opus_encoder_create.restype = C.c_void_p
        lib.opus_encoder_create.argtypes = [C.c_int32, C.c_int, C.c_int, C.POINTER(C.c_int)]
        lib.opus_encoder_destroy.argtypes = [C.c_void_p]
        lib.opus_decoder_create.restype = C.c_void_p
        lib.opus_decoder_create.argtypes = [C.c_int32, C.c_int, C.POINTER(C.c_int)]
        lib.opus_decoder_destroy.argtypes = [C.c_void_p]
        lib.opus_encode.restype = C.c_int
        lib.opus_encode.argtypes = [C.c_void_p, C.POINTER(C.c_int16), C.c_int, C.c_char_p, C.c_int32]
        lib.opus_encode_float.restype = C.c_int
        lib.opus_encode_float.argtypes = [C.c_void_p, C.POINTER(C.c_float), C.c_int, C.c_char_p, C.c_int32]
        lib.opus_decode.restype = C.c_int
        lib.opus_decode.argtypes = [C.c_void_p, C.c_char_p, C.c_int32, C.POINTER(C.c_int16), C.c_int, C.c_int]
        lib.opus_decode_float.restype = C.c_int
        lib.opus_decode_float.argtypes = [C.c_void_p, C.c_char_p, C.c_int32, C.POINTER(C.c_float), C.c_int, C.c_int]
        lib.opus_get_version_string.restype = C.c_char_p
        return lib
    return None


_LIB = _load()


def available() -> bool:
    return _LIB is not None


def version() -> str:
    return _LIB.opus_get_version_string().decode() if _LIB else "unavailable"


class RefEncoder:
    def __init__(self, fs: int = 48000, channels: int = 2, application: int = APP_AUDIO):
        err = C.c_int()
        self._st = _LIB.opus_encoder_create(fs, channels, application, C.byref(err))
        if err.value != OPUS_OK:
            raise RuntimeError(f"opus_encoder_create failed: {err.value}")
        self.fs = fs
        self.channels = channels

    def ctl_set(self, request: int, value: int) -> int:
        fn = _LIB.opus_encoder_ctl
        fn.restype = C.c_int
        return fn(C.c_void_p(self._st), C.c_int(request), C.c_int32(value))

    def ctl_get(self, request: int) -> int:
        out = C.c_int32()
        fn = _LIB.opus_encoder_ctl
        fn.restype = C.c_int
        ret = fn(C.c_void_p(self._st), C.c_int(request), C.byref(out))
        if ret != OPUS_OK:
            raise RuntimeError(f"ctl {request} failed: {ret}")
        return out.value

    def final_range(self) -> int:
        out = C.c_uint32()
        _LIB.opus_encoder_ctl(C.c_void_p(self._st), C.c_int(GET_FINAL_RANGE), C.byref(out))
        return out.value

    def encode(self, pcm: np.ndarray, max_bytes: int = 4000) -> bytes:
        """pcm: int16 interleaved, frame_size*channels samples."""
        pcm = np.ascontiguousarray(pcm, dtype=np.int16)
        frame_size = pcm.size // self.channels
        buf = C.create_string_buffer(max_bytes)
        n = _LIB.opus_encode(
            self._st, pcm.ctypes.data_as(C.POINTER(C.c_int16)), frame_size, buf, max_bytes
        )
        if n < 0:
            raise RuntimeError(f"opus_encode failed: {n}")
        return buf.raw[:n]

    def encode_float(self, pcm: np.ndarray, max_bytes: int = 4000) -> bytes:
        pcm = np.ascontiguousarray(pcm, dtype=np.float32)
        frame_size = pcm.size // self.channels
        buf = C.create_string_buffer(max_bytes)
        n = _LIB.opus_encode_float(
            self._st, pcm.ctypes.data_as(C.POINTER(C.c_float)), frame_size, buf, max_bytes
        )
        if n < 0:
            raise RuntimeError(f"opus_encode_float failed: {n}")
        return buf.raw[:n]

    def __del__(self):
        if getattr(self, "_st", None) and _LIB is not None:
            _LIB.opus_encoder_destroy(self._st)
            self._st = None


class RefDecoder:
    def __init__(self, fs: int = 48000, channels: int = 2):
        err = C.c_int()
        self._st = _LIB.opus_decoder_create(fs, channels, C.byref(err))
        if err.value != OPUS_OK:
            raise RuntimeError(f"opus_decoder_create failed: {err.value}")
        self.fs = fs
        self.channels = channels

    def ctl_set(self, request: int, value: int) -> int:
        return _LIB.opus_decoder_ctl(C.c_void_p(self._st), C.c_int(request), C.c_int32(value))

    def final_range(self) -> int:
        out = C.c_uint32()
        _LIB.opus_decoder_ctl(C.c_void_p(self._st), C.c_int(GET_FINAL_RANGE), C.byref(out))
        return out.value

    def decode(self, packet: bytes | None, frame_size: int = 5760, fec: int = 0) -> np.ndarray:
        out = np.zeros(frame_size * self.channels, np.int16)
        n = _LIB.opus_decode(
            self._st, packet, len(packet) if packet else 0,
            out.ctypes.data_as(C.POINTER(C.c_int16)), frame_size, fec,
        )
        if n < 0:
            raise RuntimeError(f"opus_decode failed: {n}")
        return out[: n * self.channels].reshape(n, self.channels)

    def decode_float(self, packet: bytes | None, frame_size: int = 5760, fec: int = 0) -> np.ndarray:
        out = np.zeros(frame_size * self.channels, np.float32)
        n = _LIB.opus_decode_float(
            self._st, packet, len(packet) if packet else 0,
            out.ctypes.data_as(C.POINTER(C.c_float)), frame_size, fec,
        )
        if n < 0:
            raise RuntimeError(f"opus_decode_float failed: {n}")
        return out[: n * self.channels].reshape(n, self.channels)

    def __del__(self):
        if getattr(self, "_st", None) and _LIB is not None:
            _LIB.opus_decoder_destroy(self._st)
            self._st = None


def make_test_signal(n: int, channels: int = 2, fs: int = 48000, kind: str = "mix",
                     seed: int = 42) -> np.ndarray:
    """Deterministic band-limited test audio, float32 in [-1, 1), shape (n, ch)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    sig = np.zeros((n, channels), np.float32)
    for ch in range(channels):
        x = np.zeros(n)
        if kind in ("mix", "tones"):
            for f, a in ((233.0 + 11 * ch, 0.3), (987.0 + 7 * ch, 0.2),
                         (3511.0, 0.1), (9700.0, 0.05)):
                x += a * np.sin(2 * np.pi * f * t + 0.1 * ch)
        if kind in ("mix", "noise"):
            x += 0.1 * rng.standard_normal(n)
        # gentle AM so frames differ
        x *= 0.5 + 0.45 * np.sin(2 * np.pi * 1.3 * t + ch)
        sig[:, ch] = x
    peak = np.abs(sig).max()
    if peak > 0.95:
        sig *= 0.95 / peak
    return sig.astype(np.float32)


def float_to_i16(x: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int16)
