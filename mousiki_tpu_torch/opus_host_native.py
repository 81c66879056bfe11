"""ctypes binding for the port's own copy of the unified native Opus
host stage.

A copy of mousiki_tpu/opus_host_native.py. `libopus_host.so` builds at
first use from `csrc/opus_host.cpp` + `csrc/celt_host.cpp` +
`csrc/silk_host.cpp` (byte-for-byte copies of native/) into
`mousiki_tpu_torch/build/`; a failed build raises with g++'s stderr. It
routes mixed SILK / CELT / hybrid 20 ms packets per stream by TOC: CELT
frames emit packed band plans, SILK frames decode to pcm at their
internal rate, hybrid frames do both over one shared range decoder.
Consumed by pipeline.OpusStreamPipeline.

The library carries its own copy of the plan-profile globals;
`celt.host_native.set_plan_profile` reaches it once it is loaded, and
the current profile is pushed into it at load.
"""

from __future__ import annotations

import ctypes as C

import numpy as np

from .celt import host_native as celt_native
from .ops import _build

_lib = None

# Feeder sentinel: this stream's 20 ms tick is a buffered chunk of an
# already-decoded multiframe SILK packet, so the native batch must neither
# decode nor conceal (pipeline.OpusStreamPipeline.push/tick).
SKIP = object()


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load_host("opus_host")
    lib.celt_host_create.argtypes = []
    lib.celt_host_create.restype = C.c_void_p
    lib.celt_host_destroy.argtypes = [C.c_void_p]
    lib.celt_host_destroy.restype = None
    lib.silk_host_create.argtypes = []
    lib.silk_host_create.restype = C.c_void_p
    lib.silk_host_destroy.argtypes = [C.c_void_p]
    lib.silk_host_destroy.restype = None
    ip = C.POINTER(C.c_int32)
    sp = C.POINTER(C.c_int16)
    vp = C.POINTER(C.c_void_p)
    fp = C.POINTER(C.c_float)
    lib.opus_host_decode_plan_batch.argtypes = [
        vp, vp, vp, ip, C.c_char_p, ip, ip, C.c_int, C.c_int, C.c_int, vp,
        sp, ip, ip, ip, C.c_char_p, ip, ip, C.c_int, fp, ip]
    lib.opus_host_decode_plan_batch.restype = None
    lib.silk_host_decode.restype = C.c_int
    lib.silk_host_decode.argtypes = [C.c_void_p, C.c_char_p, C.c_int,
                                     C.c_int, C.c_int, sp]
    celt_native._apply_profile(lib)
    _lib = lib
    return lib


def _marshal(packets: list, offs, lens) -> bytes:
    """Fill offs/lens for a batch call and return the joined blob: a lost
    packet (None) has length 0, a SKIP tick length -1."""
    blob = b"".join(p for p in packets if p is not None and p is not SKIP)
    pos = 0
    for i, p in enumerate(packets):
        offs[i] = pos
        if p is SKIP:
            lens[i] = -1
        elif p is None:
            lens[i] = 0
        else:
            lens[i] = len(p)
            pos += lens[i]
    return blob


class NativeOpusHostBatch:
    """S independent (CELT state, SILK state) pairs driven by one
    TOC-routed multithreaded batch call (n_threads workers; 0 = one per
    hardware thread).

    arena_alloc: see celt.host_native.NativeCeltHostBatch."""

    # Per-stream SilkFrameParams wire layout (native kSilkParamF/I):
    # floats [exc 320 | a 32 | b 20 | gains 4 | ltp_scale 1], ints
    # [pitch 4 | voiced, interp, vad 3]
    SILK_PARAM_F = 377
    SILK_PARAM_I = 7

    def __init__(self, n_streams: int, channels: int = 1,
                 n_threads: int = 0, arena_alloc=None):
        if channels not in (1, 2):
            raise ValueError("channels must be 1 or 2")
        lib = _load()
        self._lib = lib
        self.S = n_streams
        self.channels = channels
        self.n_threads = n_threads
        self._arena_alloc = arena_alloc or celt_native._zeros_i32

        def states(create):
            return (C.c_void_p * n_streams)(
                *[create() for _ in range(n_streams)])

        self._celt = states(lib.celt_host_create)
        self._silk = states(lib.silk_host_create)
        # stereo pipelines: a side-channel SILK state + an 8-int stereo
        # state (s_mid/s_side/pred_prev/prev_mid_only/active) per stream
        if channels == 2:
            self._silk_side = states(lib.silk_host_create)
            self._ssts = np.zeros((n_streams, 8), np.int32)
        else:
            self._silk_side = None
            self._ssts = None
        self._lenbufs = (np.empty(n_streams, np.int32),
                         np.empty(n_streams, np.int32))
        self._plan_db = {}
        self._sparams = None

    def __del__(self):
        if getattr(self, "_celt", None) is not None and self._lib is not None:
            for st in self._celt:
                if st:
                    self._lib.celt_host_destroy(st)
            for group in (self._silk, self._silk_side or ()):
                for st in group:
                    if st:
                        self._lib.silk_host_destroy(st)
            self._celt = self._silk = self._silk_side = None

    def decode(self, packets: list, frame_size: int = 960,
               fec_packets: list | None = None, silk_params: bool = False):
        """packets: S whole Opus packets (20 ms, code 0); None = lost
        frame, SKIP = neither decode nor conceal.

        Returns (arenas, aux, layout, silk16, modes, silk_fs,
        silk_stereo): the CELT plan arenas (zero rows for SILK-only
        streams), (S, 320 * channels) int16 SILK pcm at each stream's
        internal rate (fs*20 valid samples a channel plane, zero for
        CELT-only), per-stream mode tags (0 CELT / 1 SILK / 2 hybrid,
        3 PLC-concealed, 4 FEC-recovered, 5 SILK with parameters on the
        wire), SILK internal rates in kHz and the per-stream stereo-SILK
        flag. fec_packets (optional, per lost stream): the NEXT packet,
        whose in-band LBRR replaces the loss when present. rcs rides in
        aux (1 = concealed, 2 = FEC-recovered). With silk_params=True an
        eighth element holds the (S, 377) f32 / (S, 7) int32
        SilkFrameParams planes of the streams tagged 5. The arenas,
        silk16 and the parameter planes are reused by the next call."""
        S = self.S
        if len(packets) != S:
            raise ValueError(f"{len(packets)} packets for {S} streams")
        offs, lens = self._lenbufs
        if frame_size not in self._plan_db:
            # single reused arena set (see celt.host_native
            # decode_plan_arenas); silk16 is fully overwritten by the
            # native call for every stream, every step
            _, _, _, _, _, total = celt_native.arena_word_layout(
                S, self.channels, frame_size)
            arenas, aux, layout = celt_native.alloc_plan_arenas(
                S, self.channels, frame_size, self._arena_alloc((total,)))
            views = celt_native.plan_views(arenas, aux, layout)
            self._plan_db[frame_size] = (
                arenas, aux, layout, celt_native._plan_ptr_table(views),
                np.zeros((S, 320 * self.channels), np.int16))
        arenas, aux, layout, ptrs, silk16 = self._plan_db[frame_size]
        if silk_params and self._sparams is None:
            self._sparams = (np.zeros((S, self.SILK_PARAM_F), np.float32),
                             np.zeros((S, self.SILK_PARAM_I), np.int32))
        modes = np.zeros(S, np.int32)
        silk_fs = np.full(S, 16, np.int32)
        silk_stereo = np.zeros(S, np.int32)
        blob = _marshal(packets, offs, lens)
        fec_offs = np.zeros(S, np.int32)
        fec_lens = np.zeros(S, np.int32)
        fec_blob = b""
        if fec_packets is not None:
            fec_blob = _marshal(fec_packets, fec_offs, fec_lens)
        ip = C.POINTER(C.c_int32)
        sp = C.POINTER(C.c_int16)
        ssts_p = (self._ssts.ctypes.data_as(ip) if self._ssts is not None
                  else None)
        self._lib.opus_host_decode_plan_batch(
            self._celt, self._silk, self._silk_side, ssts_p, blob,
            offs.ctypes.data_as(ip), lens.ctypes.data_as(ip), S,
            self.channels, 1 if self.channels == 1 else 0, ptrs,
            silk16.ctypes.data_as(sp), modes.ctypes.data_as(ip),
            silk_fs.ctypes.data_as(ip), silk_stereo.ctypes.data_as(ip),
            fec_blob, fec_offs.ctypes.data_as(ip),
            fec_lens.ctypes.data_as(ip), self.n_threads,
            (self._sparams[0].ctypes.data_as(C.POINTER(C.c_float))
             if silk_params else None),
            (self._sparams[1].ctypes.data_as(ip) if silk_params else None))
        out = (arenas, aux, layout, silk16, modes, silk_fs, silk_stereo)
        return out + (self._sparams,) if silk_params else out

    def decode_silk_frames(self, s: int, payload: bytes, fs_khz: int,
                           frame_ms: int) -> np.ndarray:
        """Direct single-stream SILK decode of a whole 10-60 ms frame
        (used by the pipeline feeder for 10/40/60 ms packets; the batched
        20 ms path then consumes the buffered chunks via SKIP ticks).
        Returns (fs_khz * frame_ms,) int16."""
        n = fs_khz * frame_ms
        out = np.zeros(max(n, 320), np.int16)
        rc = self._lib.silk_host_decode(
            self._silk[s], payload, len(payload), fs_khz, frame_ms,
            out.ctypes.data_as(C.POINTER(C.c_int16)))
        if rc < 0:
            raise ValueError(f"stream {s}: silk multiframe decode rc={rc}")
        return out[:n]
