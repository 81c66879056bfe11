"""ctypes binding for the port's own copy of the native (C++) SILK host
decoder.

A copy of mousiki_tpu/silk/host_native.py. The library builds at first
use from `csrc/silk_host.cpp` (a byte-for-byte copy of
native/silk_host.cpp) into `mousiki_tpu_torch/build/libsilk_host.so`; a
failed build raises with g++'s stderr. One object decodes one mono
stream to int16 PCM at the SILK internal rate (8/12/16 kHz), or to the
symbols alone when the synthesis runs on the device
(ops/silk_synthesis.py).
"""

from __future__ import annotations

import ctypes as C

import numpy as np

from ..ops import _build

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load_host("silk_host")
    lib.silk_host_create.argtypes = []
    lib.silk_host_create.restype = C.c_void_p
    lib.silk_host_destroy.argtypes = [C.c_void_p]
    lib.silk_host_destroy.restype = None
    lib.silk_host_reset.argtypes = [C.c_void_p]
    lib.silk_host_reset.restype = None
    lib.silk_host_decode.restype = C.c_int
    lib.silk_host_decode.argtypes = [C.c_void_p, C.c_char_p, C.c_int, C.c_int,
                                     C.c_int, C.POINTER(C.c_int16)]
    lib.silk_host_rng.restype = C.c_uint32
    lib.silk_host_rng.argtypes = [C.c_void_p]
    lib.silk_host_plc.restype = C.c_int
    lib.silk_host_plc.argtypes = [C.c_void_p, C.POINTER(C.c_int16)]
    fp = C.POINTER(C.c_float)
    ip = C.POINTER(C.c_int32)
    lib.silk_host_decode_symbols.restype = C.c_int
    lib.silk_host_decode_symbols.argtypes = [
        C.c_void_p, C.c_char_p, C.c_int, C.c_int,
        fp, fp, fp, ip, fp, ip, fp]
    _lib = lib
    return lib


class NativeSilkHost:
    """One mono SILK stream's native host decoder (internal-rate output)."""

    def __init__(self):
        self._lib = _load()
        self._st = self._lib.silk_host_create()

    def __del__(self):
        if getattr(self, "_st", None) and self._lib is not None:
            self._lib.silk_host_destroy(self._st)
            self._st = None

    def reset(self):
        self._lib.silk_host_reset(self._st)

    @property
    def rng(self) -> int:
        return self._lib.silk_host_rng(self._st)

    def decode(self, payload: bytes, fs_khz: int, frame_ms: int) -> np.ndarray:
        """Decode one mono SILK payload; returns int16 at fs_khz kHz."""
        n = fs_khz * frame_ms
        out = np.zeros(n, np.int16)
        rc = self._lib.silk_host_decode(
            self._st, payload, len(payload), fs_khz, frame_ms,
            out.ctypes.data_as(C.POINTER(C.c_int16)))
        if rc < 0:
            raise ValueError(f"native silk decode failed (rc={rc})")
        return out[:rc]

    def plc(self) -> np.ndarray:
        """Conceal one lost frame; returns int16 at the stream's rate."""
        out = np.zeros(16 * 20, np.int16)
        rc = self._lib.silk_host_plc(
            self._st, out.ctypes.data_as(C.POINTER(C.c_int16)))
        return out[:rc]

    def decode_symbols(self, payload: bytes, fs_khz: int) -> dict:
        """Symbol-only decode of one 20 ms mono frame (SILK plan split):
        the synthesis stays on the device (ops/silk_synthesis.py).
        Returns the dense SilkFrameParams fields as numpy arrays."""
        fp = C.POINTER(C.c_float)
        ip = C.POINTER(C.c_int32)
        L = fs_khz * 20
        exc = np.zeros(L, np.float32)
        a = np.zeros((2, 16), np.float32)
        b = np.zeros((4, 5), np.float32)
        pitch = np.zeros(4, np.int32)
        gains = np.zeros(4, np.float32)
        iflags = np.zeros(3, np.int32)
        ltp_scale = np.zeros(1, np.float32)
        rc = self._lib.silk_host_decode_symbols(
            self._st, payload, len(payload), fs_khz,
            exc.ctypes.data_as(fp), a.ctypes.data_as(fp),
            b.ctypes.data_as(fp), pitch.ctypes.data_as(ip),
            gains.ctypes.data_as(fp), iflags.ctypes.data_as(ip),
            ltp_scale.ctypes.data_as(fp))
        if rc < 0:
            raise ValueError(f"native silk symbol decode failed (rc={rc})")
        return {"exc": exc, "a": a, "b": b, "pitch_l": pitch,
                "gains": gains, "voiced": bool(iflags[0]),
                "interp": bool(iflags[1]), "vad": bool(iflags[2]),
                "ltp_scale": float(ltp_scale[0])}
