"""ctypes binding for the port's own copy of the native (C++) CELT host
symbol decoder.

A copy of the batch decoder of mousiki_tpu/celt/host_native.py: the plan
path (packed band plans) and the non-plan batch call (dense spectra);
and of its batch symbol encoder (`NativeCeltEncoderBatch`), the back half
of the CELT encode pipeline.
The library builds at first use from `csrc/celt_host.cpp` (a
byte-for-byte copy of native/celt_host.cpp) into
`mousiki_tpu_torch/build/libcelt_host.so`; a failed build raises with
g++'s stderr. Each of the port's libraries that carries the plan writer
(this one and `libopus_host.so`) has its own plan-profile globals:
`set_plan_profile` here sets every one the process has loaded, and none
of the JAX package's.
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
    lib = _build.load_host()
    lib.celt_host_create.argtypes = []
    lib.celt_host_create.restype = C.c_void_p
    lib.celt_host_destroy.argtypes = [C.c_void_p]
    lib.celt_host_destroy.restype = None
    ip = C.POINTER(C.c_int32)
    vp = C.POINTER(C.c_void_p)
    dp = C.POINTER(C.c_double)
    fp = C.POINTER(C.c_float)
    lib.celt_host_decode_batch.argtypes = [
        C.POINTER(C.c_void_p), C.c_char_p, ip, ip, C.c_int, C.c_int, C.c_int,
        C.c_int, C.c_int, C.c_int, fp, dp, ip, dp, ip, C.c_int]
    lib.celt_host_decode_batch.restype = None
    lib.celt_host_decode_plan_batch.argtypes = [
        C.POINTER(C.c_void_p), C.c_char_p, ip, ip, C.c_int, C.c_int, C.c_int,
        C.c_int, C.c_int, C.c_int, vp, C.c_int]
    lib.celt_host_decode_plan_batch.restype = None
    lib.celt_enc_host_create.restype = C.c_void_p
    lib.celt_enc_host_create.argtypes = [C.c_int, C.c_int, C.c_int]
    lib.celt_enc_host_destroy.argtypes = [C.c_void_p]
    lib.celt_enc_host_destroy.restype = None
    lib.celt_enc_host_encode_batch.argtypes = [
        C.POINTER(C.c_void_p), fp, ip, fp, C.c_int, C.c_int, C.c_int,
        C.c_int, C.c_char_p, ip, C.c_int]
    lib.celt_enc_host_encode_batch.restype = None
    lib.celt_enc_host_tapset.restype = C.c_int
    lib.celt_enc_host_tapset.argtypes = [C.c_void_p]
    _apply_profile(lib)
    _lib = lib
    return lib


# Packed plan-array layout shared with csrc/celt_host.cpp (see the
# celt_host_decode_plan comment there). _TIERS/_FILL are the FULL profile
# (no direct fallback up to 510 kbps stereo); serving pipelines shrink
# them via set_plan_profile to shrink the per-step H2D arena (streams
# that overflow a tier fall back to the exact direct decoder, so
# correctness is profile-independent).
_FULL_TIERS = ((16, 224), (48, 48), (176, 16))
_FULL_FILL = 4
_TIERS = _FULL_TIERS
_NB = 21
_FILL = 4
_POOL = _NB * 2 * _FILL   # per-stream fill pool slots (wire planes)
_DUP = 2                  # special-hybrid-folding dup slots (native kDupPool)


def set_plan_profile(tiers=None, fills=None, pool=None) -> None:
    """Set the process-wide plan tier/fill capacities.

    tiers: 3 slot counts for the (n<=16, n<=48, n<=176) leaf tiers;
    fills: fold/noise slots per (band, channel) call (the device dense F
    axis); pool: per-stream fill POOL slots on the wire (<= 42 * fills;
    default the dense bound). None restores the full profile. Must be
    called BEFORE creating native batches (arena layouts bake the profile
    in; existing NativeCeltHostBatch / NativeOpusHostBatch objects keep
    stale arenas). Applies to every loaded library of the port.
    """
    global _TIERS, _FILL, _POOL
    t = tuple(int(x) for x in tiers) if tiers is not None \
        else tuple(s for _, s in _FULL_TIERS)
    f = int(fills) if fills is not None else _FULL_FILL
    if len(t) != 3 or not all(1 <= t[i] <= _FULL_TIERS[i][1]
                              for i in range(3)):
        raise ValueError(f"bad tier profile {t}")
    if not 1 <= f <= _FULL_FILL:
        raise ValueError(f"bad fill profile {f}")
    p = int(pool) if pool is not None else _NB * 2 * f
    if not 1 <= p <= _NB * 2 * f:
        raise ValueError(f"bad fill pool {p}")
    _TIERS = tuple((n, t[i]) for i, (n, _) in enumerate(_FULL_TIERS))
    _FILL = f
    _POOL = p
    for lib in _profile_libs():
        _apply_profile(lib)


def get_plan_profile():
    return tuple(s for _, s in _TIERS), _FILL, _POOL


def _profile_libs():
    """Every loaded library of the port carrying the plan writer (each
    .so has its own copy of the capacity globals)."""
    libs = [_lib, _build.loaded_host("opus_host")]
    return [lib for lib in libs if lib is not None]


def _apply_profile(lib) -> None:
    """Push the current profile into a library."""
    lib.celt_host_set_plan_profile.argtypes = [C.c_int, C.c_int, C.c_int,
                                               C.c_int]
    lib.celt_host_set_plan_profile.restype = None
    lib.celt_host_set_fill_pool.argtypes = [C.c_int]
    lib.celt_host_set_fill_pool.restype = None
    t, f, p = get_plan_profile()
    lib.celt_host_set_plan_profile(t[0], t[1], t[2], f)
    lib.celt_host_set_fill_pool(p)


# Plane dtypes mirror native PlanOut (celt_host.cpp, wire format v4):
# bit-packed flag planes, pooled sparse records, and ONE sequential
# 12-byte record per PVQ leaf (the device scatters records into the
# executor's tier planes with a cumsum at unpack).
# ops/band_exec.unpack_plan_arenas reconstructs the executor's logical
# planes on the device.
_PLANE_DTYPES = {
    "direct": np.uint8,
    "pvq_rec": np.uint32,      # (R, 3): w0 = n | k<<8 | log2(b)<<16 |
                               # tier<<19 | dst<<21 (active == k>0 after
                               # the tier scatter); w1 = gain f32 bits;
                               # w2 = idx
    "pvq_cnt": np.uint16,      # records written per stream
    "call_flags": np.uint8,    # active|has_lb<<1|lb_buf<<2|nwr<<3|nbuf<<4
    "call_combo": np.uint8,    # pre == post combo id
    "call_lb_src": np.int16, "call_blend_upto": np.int16,
    "dup_pool": np.int16,      # (S, _DUP, 4): [callid, dst, src, n]
    "fill_cid": np.uint8,      # active | fold<<1 | callid<<2
    "fill_off": np.int16, "fill_n": np.int16,
    "fill_gain": np.float32, "fill_seed": np.uint32,
    "bm_flags": np.uint8,      # merge_a|m_inv<<1|t2_a<<2|cswap<<3|
                               # t_inv<<4|sign_neg<<5
    "bm_mid": np.float32, "bm_side": np.float32,
    "n1_as": np.uint8,         # active | neg<<1
    "ac_on": np.uint8, "ac_masks": np.uint8, "ac_r": np.float32,
    "ac_seed": np.uint32, "iflags": np.int32,
    "ble32": np.float32, "pf32": np.float32,
    "spread8": np.uint8,       # frame-wide PVQ spread (one per stream)
    "lost8": np.uint8,
}

# Native pointer-table order (29 entries; see celt_host_decode_plan).
_PTR_ORDER = (["direct", "pvq_rec", "pvq_cnt",
               "call_flags", "call_combo", "call_lb_src",
               "call_blend_upto", "dup_pool", "fill_cid", "fill_off",
               "fill_n", "fill_gain", "fill_seed", "bm_flags", "bm_mid",
               "bm_side", "n1_as", "ac_on", "ac_masks", "ac_r", "ac_seed",
               "x_direct", "band_log_e", "iflags", "pf_gain", "rcs",
               "ble32", "pf32", "spread8"])


def _plane_shapes(S: int, channels: int, frame: int) -> dict:
    c2, b1, fp = (S, _NB, 2), (S, _NB), (S, _POOL)
    R = sum(s for _, s in _TIERS)
    shapes = {
        "direct": (S,),
        "pvq_rec": (S, R, 3), "pvq_cnt": (S,),
        "call_flags": c2, "call_combo": c2, "call_lb_src": c2,
        "call_blend_upto": c2, "dup_pool": (S, _DUP, 4),
        "fill_cid": fp, "fill_off": fp, "fill_n": fp,
        "fill_gain": fp, "fill_seed": fp,
        "bm_flags": b1, "bm_mid": b1, "bm_side": b1,
        "n1_as": c2, "ac_on": (S,), "ac_masks": c2,
        "ac_r": (S, 2, _NB), "ac_seed": (S,), "iflags": (S, 4),
        "ble32": (S, 2, _NB), "pf32": (S,), "spread8": (S,),
        # written by the PYTHON caller (not the native decoder): the
        # per-stream lost mask rides the single arena H2D copy
        "lost8": (S,),
    }
    return shapes


def plan_arena_layout(S: int, channels: int, frame: int):
    """Byte layout of the three plan arenas (by element width).

    Returns (layout, sizes) where layout maps each plane key ->
    (arena_name, elem_offset, shape) and sizes maps arena_name -> element
    count. Arena dtypes: a32 int32 (f32/u32 planes are same-width views),
    a16 int16, a8 uint8. The ble32/pf32 planes are host-converted f32
    copies of band_log_e / pf_gain so the descriptor rides the same
    transfer.
    """
    shapes = _plane_shapes(S, channels, frame)
    arena_of = {1: "a8", 2: "a16", 4: "a32"}
    layout = {}
    sizes = {"a8": 0, "a16": 0, "a32": 0}
    for key in list(shapes):
        dt = np.dtype(_PLANE_DTYPES[key])
        name = arena_of[dt.itemsize]
        n = int(np.prod(shapes[key]))
        layout[key] = (name, sizes[name], shapes[key])
        sizes[name] += n
    return layout, sizes


def arena_word_layout(S: int, channels: int, frame: int):
    """Word offsets of the three arenas inside ONE int32 backing buffer
    (a32 | a16 | a8, each padded to whole words). Returns
    (n32, w16_off, n16, w8_off, n8, total_words)."""
    _, sizes = plan_arena_layout(S, channels, frame)
    n32 = sizes["a32"]
    w16 = (sizes["a16"] + 1) // 2
    w8 = (sizes["a8"] + 3) // 4
    return n32, n32, sizes["a16"], n32 + w16, sizes["a8"], n32 + w16 + w8


def _zeros_i32(shape):
    return np.zeros(shape, np.int32)


def alloc_plan_arenas(S: int, channels: int, frame: int, backing=None):
    """Zeroed plan arenas + the separate native output arrays.

    All three arenas are views of ONE int32 backing buffer (returned as
    arenas["backing"]) so the whole plan ships to the device as a single
    H2D transfer. `backing` is a zeroed (total_words,) int32 array to lay
    the arenas in (a row of a chunk stack, page-locked memory); None
    allocates one. The native decoder only writes flagged slots and the
    device executor masks by those flags (zero defaults are correct for
    every plane, including call_blend_upto where 0 and -1 both mean "no
    blend").
    """
    layout, _ = plan_arena_layout(S, channels, frame)
    n32, o16, n16, o8, n8, total = arena_word_layout(S, channels, frame)
    if backing is None:
        backing = _zeros_i32(total)
    if backing.shape != (total,) or backing.dtype != np.int32:
        raise ValueError(f"backing must be ({total},) int32")
    arenas = {"backing": backing,
              "a32": backing[:n32],
              "a16": backing[o16: o16 + (n16 + 1) // 2].view(np.int16)[:n16],
              "a8": backing[o8: o8 + (n8 + 3) // 4].view(np.uint8)[:n8]}
    aux = {"x_direct": np.zeros((S, channels, frame), np.float32),
           "band_log_e": np.zeros((S, 2, _NB), np.float64),
           "pf_gain": np.zeros(S, np.float64),
           "rcs": np.zeros(S, np.int32)}
    return arenas, aux, layout


def plan_views(arenas: dict, aux: dict, layout: dict) -> dict:
    """Typed numpy views of every plan plane, backed by the arenas, plus
    the separate native outputs."""
    out = {}
    for key, (name, off, shape) in layout.items():
        dt = np.dtype(_PLANE_DTYPES[key])
        n = int(np.prod(shape))
        out[key] = arenas[name][off:off + n].view(dt).reshape(shape)
    out.update(aux)
    return out


def plane_of(arenas: dict, layout: dict, key: str) -> np.ndarray:
    """The flat arena slice that holds plane `key` (a one-byte plane
    reads as its own values)."""
    name, off, shape = layout[key]
    return arenas[name][off:off + int(np.prod(shape))]


def _plan_ptr_table(views: dict):
    ptrs = (C.c_void_p * len(_PTR_ORDER))()
    for k, key in enumerate(_PTR_ORDER):
        ptrs[k] = views[key].ctypes.data_as(C.c_void_p)
    return ptrs


class NativeCeltHostBatch:
    """S independent native host decoders driven by one multithreaded
    call (n_threads workers; 0 = one per hardware thread), emitting
    packed band plans for the device executor, or dense spectra on the
    non-plan path.

    arena_alloc: optional callable (shape) -> zeroed int32 numpy array,
    from which the plan arenas' backing buffers come (a pipeline on a GPU
    passes page-locked memory so that its copies can be asynchronous)."""

    def __init__(self, n_streams: int, channels: int = 2,
                 start: int = 0, end: int = 21,
                 disable_inv: bool | None = None, n_threads: int = 0,
                 arena_alloc=None):
        lib = _load()
        self._lib = lib
        self.S = n_streams
        self.channels = channels
        self.start = start
        self.end = end
        self.disable_inv = (channels == 1) if disable_inv is None \
            else disable_inv
        self.n_threads = n_threads
        self._states = (C.c_void_p * n_streams)(
            *[lib.celt_host_create() for _ in range(n_streams)])
        self._arena_alloc = arena_alloc or _zeros_i32
        self._lenbufs = (np.empty(n_streams, np.int32),
                         np.empty(n_streams, np.int32))
        self._plan_nbufs = 1
        self._plan_db = {}
        self._plan_chunk_db = {}

    def __del__(self):
        if getattr(self, "_states", None) is not None and self._lib is not None:
            for st in self._states:
                if st:
                    self._lib.celt_host_destroy(st)
            self._states = None

    def _marshal(self, payloads: list):
        """(blob, offs, lens) of S payloads for a native batch call; a
        None payload (lost packet) has length 0."""
        if len(payloads) != self.S:
            raise ValueError(f"{len(payloads)} payloads for {self.S} streams")
        offs, lens = self._lenbufs
        blob = b"".join(p for p in payloads if p is not None)
        lens[:] = np.fromiter(
            (0 if p is None else len(p) for p in payloads),
            np.int32, count=len(payloads))
        np.cumsum(lens[:-1], out=offs[1:], dtype=np.int32)
        offs[0] = 0
        return blob, offs, lens

    def decode(self, payloads: list, frame_size: int):
        """Non-plan batch decode: the host reconstructs the PVQ bands too.

        payloads: S byte strings. Returns (x (S, C, frame) f32 unit-norm
        band shapes, band_log_e (S, 2, 21) f64, iflags (S, 4) int32
        [transient, silence, pf_pitch, pf_tapset], pf_gains (S,) f64,
        rcs (S,) int32). Outputs are freshly allocated every call."""
        S, Cch = self.S, self.channels
        if any(p is None for p in payloads):
            raise ValueError("the non-plan decode has no loss concealment; "
                             "use plan mode for lost packets")
        blob, offs, lens = self._marshal(payloads)
        # the native decoder fully overwrites every output element
        x = np.empty((S, Cch, frame_size), np.float32)
        ble = np.empty((S, 2, _NB), np.float64)
        iflags = np.empty((S, 4), np.int32)
        pf_gains = np.empty(S, np.float64)
        rcs = np.empty(S, np.int32)
        dp = C.POINTER(C.c_double)
        fp = C.POINTER(C.c_float)
        ip = C.POINTER(C.c_int32)
        self._lib.celt_host_decode_batch(
            self._states, blob, offs.ctypes.data_as(ip),
            lens.ctypes.data_as(ip), S, frame_size, Cch, self.start, self.end,
            1 if self.disable_inv else 0, x.ctypes.data_as(fp),
            ble.ctypes.data_as(dp), iflags.ctypes.data_as(ip),
            pf_gains.ctypes.data_as(dp), rcs.ctypes.data_as(ip),
            self.n_threads)
        return x, ble, iflags, pf_gains, rcs

    def set_plan_buffers(self, n: int) -> None:
        """Size the plan arena ring in use (default 1 buffer, reused in
        place).

        n=2 lets a caller write the arenas of frame k+1 (on a worker
        thread: the C call releases the GIL) while those of frame k are
        still being copied to the device. Arenas are allocated once, the
        first time the ring needs them, and kept: a smaller ring uses the
        first n of them."""
        if n < 1:
            raise ValueError("need >= 1 plan buffer")
        self._plan_nbufs = n

    def _plan_slot(self, frame_size: int, backing=None):
        """One arena set: (arenas, aux, layout, views, pointer table)."""
        if backing is None:
            _, _, _, _, _, total = arena_word_layout(self.S, self.channels,
                                                     frame_size)
            backing = self._arena_alloc((total,))
        arenas, aux, layout = alloc_plan_arenas(self.S, self.channels,
                                                frame_size, backing)
        views = plan_views(arenas, aux, layout)
        return arenas, aux, layout, views, _plan_ptr_table(views)

    def _decode_plan_into(self, slot, payloads: list, frame_size: int):
        arenas, aux, layout, views, ptrs = slot
        blob, offs, lens = self._marshal(payloads)
        views["lost8"][:] = lens == 0
        ip = C.POINTER(C.c_int32)
        self._lib.celt_host_decode_plan_batch(
            self._states, blob, offs.ctypes.data_as(ip),
            lens.ctypes.data_as(ip), self.S, frame_size, self.channels,
            self.start, self.end, 1 if self.disable_inv else 0, ptrs,
            self.n_threads)
        return arenas, aux, layout

    def decode_plan_arenas(self, payloads: list, frame_size: int):
        """Symbol-only batch decode emitting packed band plans.

        payloads: S byte strings (None = lost packet). Returns (arenas,
        aux, layout): three contiguous plan arenas (see plan_arena_layout)
        inside one int32 `arenas["backing"]`, plus the separate native
        outputs {x_direct, band_log_e, pf_gain, rcs}.

        The arena set is a ring of set_plan_buffers(n) buffers (default
        1, reused in place): the native decoder re-memsets every flag
        plane and the device executor masks all value planes by those
        flags, so stale values in inactive slots are never read. Callers
        that keep arenas across steps must copy them.
        """
        db = self._plan_db.setdefault(frame_size, [0, []])
        ring = db[1]
        while len(ring) < self._plan_nbufs:
            ring.append(self._plan_slot(frame_size))
        i = db[0] % self._plan_nbufs
        db[0] = i + 1
        return self._decode_plan_into(ring[i], payloads, frame_size)

    def decode_plan_chunk(self, frames: list, frame_size: int):
        """Decode K frame batches straight into ONE contiguous
        (K, total_words) int32 backing, the stacked input of
        ops/band_exec.plan_synthesis_scan, with no per-frame copy.

        frames: list of K payload lists (each length S; None = lost).
        Returns (backing2d, aux_list, any_direct, any_lost): backing2d is
        the (K, total_words) arena stack (the first K rows of one
        backing per frame size, reused across calls and replaced only by
        a call with more frames than any before: callers must consume or
        copy it before the next call), aux_list holds each frame's
        {x_direct, band_log_e, ...}, any_direct says whether any stream
        of any frame fell back to the direct decoder, and any_lost[k]
        whether frame k lost a packet.
        """
        K = len(frames)
        held = self._plan_chunk_db.get(frame_size)
        if held is None or len(held[1]) < K:
            _, _, _, _, _, total = arena_word_layout(self.S, self.channels,
                                                     frame_size)
            backing2d = self._arena_alloc((K, total))
            held = self._plan_chunk_db[frame_size] = (
                backing2d, [self._plan_slot(frame_size, backing2d[k])
                            for k in range(K)])
        backing2d, slots = held
        if K < len(slots):
            backing2d = backing2d[:K]
        aux_list = []
        any_lost = []
        any_direct = False
        for slot, payloads in zip(slots, frames):
            arenas, aux, layout = self._decode_plan_into(slot, payloads,
                                                         frame_size)
            any_direct |= bool(plane_of(arenas, layout, "direct").any())
            any_lost.append(bool(plane_of(arenas, layout, "lost8").any()))
            aux_list.append(aux)
        return backing2d, aux_list, any_direct, any_lost



class NativeCeltEncoderBatch:
    """S native CELT symbol encoders driven by one multithreaded batch
    call: the back half of the encode pipeline. The device front
    (ops/encode_front.py) computes the MDCT spectrum and the analysis
    decisions; this stage runs coarse/fine energy, tf, spread, dynalloc,
    allocation, PVQ search and range coding (csrc/celt_host.cpp, encoder
    section)."""

    MAX_BYTES = 1275

    def __init__(self, n_streams: int, channels: int = 2,
                 complexity: int = 5, disable_inv: bool = False,
                 n_threads: int = 0):
        lib = _load()
        self._lib = lib
        self.S = n_streams
        self.channels = channels
        self.n_threads = n_threads
        self._states = (C.c_void_p * n_streams)(
            *[lib.celt_enc_host_create(channels, complexity,
                                       1 if disable_inv else 0)
              for _ in range(n_streams)])
        self._out = np.zeros((n_streams, self.MAX_BYTES), np.uint8)
        self._lens = np.zeros(n_streams, np.int32)

    def __del__(self):
        if getattr(self, "_states", None) is not None and self._lib is not None:
            for st in self._states:
                if st:
                    self._lib.celt_enc_host_destroy(st)
            self._states = None

    def encode(self, freq: np.ndarray, iparams: np.ndarray,
               fparams: np.ndarray, frame_size: int = 960) -> list:
        """freq: (S, C, frame) float32 MDCT spectra of the device front.
        iparams: (S, 6) int32 [silence, pf_on, pitch_index, qg,
        is_transient, nbytes]. fparams: (S, 3) float32 [tone_freq,
        toneishness, tf_estimate]. Returns S packets (bytes)."""
        S = self.S
        freq = np.ascontiguousarray(freq, np.float32)
        iparams = np.ascontiguousarray(iparams, np.int32)
        fparams = np.ascontiguousarray(fparams, np.float32)
        if freq.shape != (S, self.channels, frame_size):
            raise ValueError(f"freq {freq.shape} for "
                             f"{(S, self.channels, frame_size)}")
        if iparams.shape != (S, 6) or fparams.shape != (S, 3):
            raise ValueError(f"iparams {iparams.shape} / fparams "
                             f"{fparams.shape} for {S} streams")
        ip = C.POINTER(C.c_int32)
        fp = C.POINTER(C.c_float)
        self._lib.celt_enc_host_encode_batch(
            self._states, freq.ctypes.data_as(fp),
            iparams.ctypes.data_as(ip), fparams.ctypes.data_as(fp), S,
            self.channels, frame_size, self.MAX_BYTES,
            self._out.ctypes.data_as(C.c_char_p),
            self._lens.ctypes.data_as(ip), self.n_threads)
        return [bytes(self._out[s, :ln]) if ln > 0 else None
                for s, ln in enumerate(self._lens.tolist())]

    def tapsets(self) -> np.ndarray:
        """Per-stream tapset decisions (they feed the next front step)."""
        return np.asarray(
            [self._lib.celt_enc_host_tapset(st) for st in self._states],
            np.int32)
