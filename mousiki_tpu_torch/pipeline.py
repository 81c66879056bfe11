"""End-to-end batched stream decoders and encoders in PyTorch: port of
the pipelines of mousiki_tpu/pipeline.py.

  CeltStreamPipeline   S CELT payloads --native symbol stage--> one packed
                       int32 plan arena --host-to-device copy--> device
                       step (unpack + band plans + PLC + synthesis)
                       --> (S, N, C) PCM. Also the non-plan path (the host
                       reconstructs the bands, the device synthesises).
  SilkStreamPipeline   S mono SILK payloads --native decoder--> pcm (or
                       symbols) at 8/12/16 kHz --device (synthesis +)
                       up-resampler--> (S, 48 * ms) PCM.
  OpusStreamPipeline   S whole Opus packets of mixed SILK / CELT / hybrid
                       20 ms frames --native TOC-routed stage--> plan
                       arena + SILK pcm --one device step (CELT plan step,
                       per-rate resamplers, sum)--> (S, 960, C) PCM.

  CeltEncodePipeline   (S, frame, C) PCM --device front (analysis +
                       forward MDCT)--device-to-host copy--> native symbol
                       encoder --> S CELT frames.
  SilkEncodePipeline   (S, 960) PCM --S host SILK encoders on threads,
                       their noise-shaping quantizer calls batched into
                       one device call a round--> S SILK packets.

The host halves are the port's own copies of the native C++ codecs
(`celt/host_native.py`, `silk/host_native.py`, `opus_host_native.py`,
built with g++ from `csrc/` at first use) and, for the SILK encoder, of
the numpy host codec (`hostcodec/`). `CeltStreamPipeline(use_native=False)`
puts the copied Python CELT decoder (`hostcodec/celt/decoder.py`) in
front of the device synthesis instead; otherwise a native stage that does
not build raises: there is no fallback to Python.

The two stream decoders also take `mesh=` (a `parallel.streaming.
StreamMesh`): the streams are split into one shard a mesh device, each
shard a single-device pipeline of S / n streams with its own native
batch, staging buffers and state, and the shards' PCM is gathered onto
`device`, which must be one of the mesh's.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.profiler import record_function

from . import _device
from .bitstream.packet import parse_packet
from .celt import host_native
from .celt.modes import MODE
from .hostcodec.celt.decoder import CeltDecoder
from .ops.band_exec import (plan_combo_mats, plan_synthesis_scan,
                            plan_synthesis_step_plc)
from .ops.encode_front import (front_scan, front_step, init_front_state,
                               make_front_consts)
from .ops.plc import init_plc_state, make_plc_consts
from .ops.silk_resampler import init_up48_state, make_up48_plan, up48_step
from .ops.silk_synthesis import (SilkFrameParams, init_silk_state,
                                 silk_synthesis_step)
from .ops.synthesis import FrameDesc, init_state, make_consts, synthesis_step
from .parallel import streaming

# bench.py's serving plan profile: (leaf-tier slots, fills, fill pool)
SERVING_PROFILE = ((144, 40, 6), 2, 8)

_LOW_E = -28.0
_SILK_RATES = (8, 12, 16)


def set_plan_profile(tiers=None, fills=None, pool=None) -> None:
    """Set the port's native host stages' plan capacities, process-wide
    (every pipeline and every loaded library of the port; the JAX
    package's libraries keep their own). No arguments restore the full
    profile. A stream that overflows a tier falls back to the exact
    direct decoder, so the profile moves the arena size, not the output."""
    host_native.set_plan_profile(tiers, fills, pool)


def _shard_pipelines(mesh, n_streams: int, device, make):
    """The shards of a mesh pipeline: `make(n, dev)`, a single-device
    pipeline of n streams, on every mesh device, each told the global
    index of its first stream. The shards on one device share one
    constants cache (they have one size, so even their all-zero x_direct
    is the same). Returns (the output device, the shards)."""
    bounds = streaming.shard_bounds(mesh, n_streams)
    out = streaming.output_device(mesh, device)
    shards = [make(hi - lo, dev)
              for (lo, hi), dev in zip(bounds, mesh.devices)]
    caches = streaming.replicate(mesh, lambda d: {})
    for shard, (lo, _), cache in zip(shards, bounds, caches):
        shard._lo, shard._cache = lo, cache
    return out, shards


class _HostStaging:
    """Host-to-device copies of buffers that the native decoders reuse in
    place.

    On a GPU the plan arenas live in page-locked memory, allocated once
    (`alloc`), so `arena_to_device` is asynchronous; it records an event,
    and `wait` holds the host until that copy is done, which every caller
    does before the native decoder writes an arena again. Other arrays go
    through `to_device`, a copy that has read its source when it returns.
    On the CPU both are real copies, never aliases of the reused buffer.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self._event = None

    def alloc(self, shape) -> np.ndarray:
        if self.cuda:
            return torch.zeros(shape, dtype=torch.int32,
                               pin_memory=True).numpy()
        return np.zeros(shape, np.int32)

    def arena_to_device(self, arena: np.ndarray) -> torch.Tensor:
        src = torch.from_numpy(arena)
        if not self.cuda:
            return src.clone()
        with record_function("host.h2d"):
            out = src.to(self.device, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(self.device))
        return out

    def wait(self) -> None:
        if self._event is not None:
            self._event.synchronize()
            self._event = None

    def to_device(self, array: np.ndarray) -> torch.Tensor:
        src = torch.from_numpy(array)
        return src.to(self.device) if self.cuda else src.clone()

    def finish(self, pcm: torch.Tensor) -> torch.Tensor:
        if self.cuda:
            torch.cuda.synchronize(self.device)
        return pcm


class CeltStreamPipeline:
    """Decode S parallel CELT streams, one 48 kHz frame per step.

    The arguments are the reference's, in its order, with `device`
    added as a keyword.

    use_plan=True (the serving path): the native host decodes only
    symbols, emitting packed band plans; band reconstruction, concealment
    of lost packets (a payload of None) and synthesis run on `device`.
    use_plan=False (the default): the host reconstructs the bands too and
    the device runs the synthesis alone; that path conceals no loss.

    use_native: None or True take the native host library (a failed
    build raises); False takes one copied Python CeltDecoder a stream,
    non-plan only (plan mode with use_native=False raises ValueError).
    host_threads: worker threads of the native batch call (0 = one per
    hardware thread). Set `overlap_host = True` to have `decode_stream`
    decode frame k+1 on a worker thread while frame k is copied and
    launched.

    mesh: a StreamMesh to split the streams over (n_streams a multiple of
    its size); `device` is then where the gathered PCM lands, one of the
    mesh's devices. Each shard is a pipeline of this class on its own
    device. Under a mesh, `decode_stream` runs step by step and the
    chunked and scanned decodes are refused.
    """

    def __init__(self, n_streams: int, channels: int = 2,
                 use_native: bool | None = None, mesh=None,
                 host_threads: int = 0, use_plan: bool = False, *, device):
        if use_plan and use_native is False:
            raise ValueError("plan mode requires the native host")
        self.S = n_streams
        self.channels = channels
        self.use_plan = use_plan
        self.overlap_host = False
        self._shards = None
        self._lo = 0            # global index of stream 0 (error messages)
        # per frame size: synthesis, PLC and combo constants and the
        # all-zero x_direct, which is shipped only when some stream fell
        # back to the direct decoder
        self._cache = {}
        if mesh is not None:
            self.device, self._shards = _shard_pipelines(
                mesh, n_streams, device, lambda n, dev: CeltStreamPipeline(
                    n, channels, use_native, None, host_threads, use_plan,
                    device=dev))
            self._h2d = _HostStaging(self.device)
            return
        self.device = _device.as_device(device)
        self._h2d = _HostStaging(self.device)
        self._native = None
        self._py_hosts = None
        if use_native is False:
            self._py_hosts = [CeltDecoder(channels=channels,
                                          stream_channels=channels)
                              for _ in range(n_streams)]
            for h in self._py_hosts:
                h.disable_inv = channels == 1
        else:
            self._native = host_native.NativeCeltHostBatch(
                n_streams, channels=channels, disable_inv=channels == 1,
                n_threads=host_threads, arena_alloc=self._h2d.alloc)
        self.state = init_state(n_streams, channels, self.device)
        self.plc_state = init_plc_state(n_streams, channels, self.device)

    def _frame_consts(self, frame_size: int):
        """(synthesis consts, PLC consts, combo mats, zero x_direct) of a
        frame size (LM 0-3), built at its first use."""
        if frame_size not in self._cache:
            dev = self.device
            self._cache[frame_size] = (
                make_consts(frame_size, dev),
                make_plc_consts(frame_size, MODE.window, dev),
                plan_combo_mats(self.channels, frame_size, dev),
                torch.zeros((self.S, self.channels, frame_size),
                            dtype=torch.float32, device=dev))
        return self._cache[frame_size]

    def _plan_step(self, frame_size, state, backing, xd, any_lost):
        consts, plc_consts, mats, _ = self._frame_consts(frame_size)
        pcm, new_state, self.plc_state = plan_synthesis_step_plc(
            consts, plc_consts, state, self.plc_state, backing, xd, mats,
            any_lost=any_lost, channels=self.channels, frame=frame_size,
            n_streams=self.S)
        return pcm, new_state

    # ------------------------------------------------------------------
    def _host_decode(self, payloads: list, frame_size: int) -> FrameDesc:
        """Non-plan host stage: dense band shapes and descriptors, on the
        device. Both hosts allocate fresh outputs every call."""
        if self._py_hosts is not None:
            return self._host_decode_python(payloads, frame_size)
        with record_function("host.celt_decode"):
            x, ble2, iflags, pf_gains, rcs = self._native.decode(
                payloads, frame_size)
        if np.any(rcs < 0):
            bad = int(np.argmax(rcs < 0))
            raise ValueError(f"stream {self._lo + bad}: native celt decode "
                             f"failed rc={rcs[bad]}")
        return self._desc_to_device(
            x, ble2[:, :self.channels, :], iflags[:, 0] != 0,
            iflags[:, 1] != 0, iflags[:, 2], pf_gains, iflags[:, 3])

    def _host_decode_python(self, payloads: list, frame_size: int):
        """The copied Python decoder, one a stream (ref pipeline.py's
        _py_hosts branch)."""
        if any(p is None for p in payloads):
            raise ValueError("the non-plan decode has no loss concealment; "
                             "use plan mode for lost packets")
        S, C = self.S, self.channels
        x = np.zeros((S, C, frame_size), np.float32)
        ble = np.zeros((S, C, 21))
        transient = np.zeros(S, bool)
        silence = np.zeros(S, bool)
        pf_pitch = np.zeros(S, np.int32)
        pf_tapset = np.zeros(S, np.int32)
        pf_gains = np.zeros(S)
        with record_function("host.celt_decode"):
            for s, payload in enumerate(payloads):
                d = self._py_hosts[s].decode_with_ec(payload, frame_size,
                                                     return_desc=True)
                x[s] = d["x"]
                ble[s] = d["band_log_e"][:C]
                transient[s] = d["transient"]
                silence[s] = d["silence"]
                pf_pitch[s] = d["pf_pitch"]
                pf_tapset[s] = d["pf_tapset"]
                pf_gains[s] = d["pf_gain"]
        return self._desc_to_device(x, ble, transient, silence, pf_pitch,
                                    pf_gains, pf_tapset)

    def _desc_to_device(self, x, ble, transient, silence, pf_pitch,
                        pf_gains, pf_tapset) -> FrameDesc:
        ble_pad = np.full((self.S, self.channels, 22), _LOW_E, np.float32)
        ble_pad[:, :, :21] = ble
        to_dev = self._h2d.to_device
        return FrameDesc(
            x=to_dev(x), band_log_e=to_dev(ble_pad),
            transient=to_dev(transient), silence=to_dev(silence),
            pf_pitch=to_dev(np.ascontiguousarray(pf_pitch, np.int32)),
            pf_gain=to_dev(np.asarray(pf_gains, np.float32)),
            pf_tapset=to_dev(np.ascontiguousarray(pf_tapset, np.int32)))

    def _decode_plan_host(self, payloads: list, frame_size: int):
        """The pure-CPU part of the plan host stage (safe on a worker
        thread: the C call releases the GIL). Returns the host-side tuple
        for _plan_args_to_device."""
        with record_function("host.celt_decode"):
            arenas, aux, layout = self._native.decode_plan_arenas(
                payloads, frame_size)
        rcs = aux["rcs"]
        if np.any(rcs < 0):
            bad = int(np.argmax(rcs < 0))
            raise ValueError(f"stream {self._lo + bad}: native celt plan "
                             f"decode failed rc={rcs[bad]}")
        any_direct = bool(
            host_native.plane_of(arenas, layout, "direct").any())
        # the lost mask rides the arena (lost8 plane); this host copy only
        # decides whether the concealment runs at all
        any_lost = bool(host_native.plane_of(arenas, layout, "lost8").any())
        return arenas, aux, any_direct, any_lost

    def _host_decode_plan(self, payloads: list, frame_size: int,
                          to_device: bool = True):
        """Plan-mode host stage: one packed arena (+ x_direct when some
        stream fell back to the direct decoder). to_device=False returns
        the host-side tuple for a later _plan_args_to_device call."""
        # the native decoder reuses its arena in place: the copy of the
        # arena's last contents must be done before it writes again
        self._h2d.wait()
        host = self._decode_plan_host(payloads, frame_size)
        if not to_device:
            return host
        return self._plan_args_to_device(host, frame_size)

    def _plan_args_to_device(self, host, frame_size: int):
        """Host-to-device half of the plan stage."""
        arenas, aux, any_direct, any_lost = host
        backing = self._h2d.arena_to_device(arenas["backing"])
        if any_direct:
            xd = self._h2d.to_device(aux["x_direct"])
        else:
            xd = self._frame_consts(frame_size)[3]
        return backing, xd, any_lost

    def step(self, payloads: list, frame_size: int = 960):
        """Decode one frame for every stream.

        payloads: S CELT payload byte strings (None = lost packet, plan
        mode only). Returns a tensor (S, frame_size, channels) on the
        pipeline's device, float32 in [-1, 1]."""
        if self._shards is not None:
            return streaming.gather(
                [shard.step(payloads[shard._lo:shard._lo + shard.S],
                            frame_size) for shard in self._shards],
                self.device)
        if self.use_plan:
            args = self._host_decode_plan(payloads, frame_size)
            pcm, self.state = self._plan_step(frame_size, self.state, *args)
            return pcm
        desc = self._host_decode(payloads, frame_size)
        pcm, self.state = synthesis_step(self._frame_consts(frame_size)[0],
                                         self.state, desc, n=frame_size)
        return pcm

    def decode_stream(self, frames_iter, frame_size: int = 960,
                      chunk: int = 1):
        """Generator over frames of S payloads: the native decode of frame
        k+1 runs on the host while the device works on frame k (launches
        are asynchronous); each yielded tensor is finished.

        Plan mode decodes frame k+1 into the single reused arena after
        frame k's launches (the default), or, with `overlap_host` set, on
        a worker thread into the other arena of a ring of two while the
        main thread copies and launches frame k.

        chunk > 1 (plan mode): decode `chunk` frames per device dispatch
        through the scanned step: one stacked-arena copy per chunk, at the
        price of chunk * 20 ms of added latency. Yields (S, frame, C)
        results one frame at a time, exactly as chunk=1 does.

        Under a mesh every frame is one `step` (no overlap, no chunks).
        """
        it = iter(frames_iter)
        if chunk > 1:
            if self._shards is not None:
                raise ValueError("chunked decode runs on one device, "
                                 "not under a mesh")
            if not self.use_plan:
                raise ValueError("chunked decode needs plan mode")
            return self._decode_stream_chunked(it, frame_size, chunk)
        if self._shards is not None:
            return (self._h2d.finish(self.step(payloads, frame_size))
                    for payloads in it)
        if not self.use_plan:
            return self._decode_stream_descs(it, frame_size)
        return self._decode_stream_plan(it, frame_size, self.overlap_host)

    def _decode_stream_plan(self, it, frame_size: int, threaded: bool):
        self._native.set_plan_buffers(2 if threaded else 1)
        try:
            first = next(it)
        except StopIteration:
            return
        with ThreadPoolExecutor(max_workers=1) as pool:
            host = self._host_decode_plan(first, frame_size, to_device=False)
            for payloads in it:
                if threaded:
                    # frame k+1 goes into the arena frame k-1 used: its
                    # copy is done before the worker may write there
                    self._h2d.wait()
                    fut = pool.submit(self._decode_plan_host, payloads,
                                      frame_size)
                args = self._plan_args_to_device(host, frame_size)
                out, self.state = self._plan_step(frame_size, self.state,
                                                  *args)
                if threaded:
                    host = fut.result()
                else:
                    host = self._host_decode_plan(payloads, frame_size,
                                                  to_device=False)
                yield self._h2d.finish(out)
            args = self._plan_args_to_device(host, frame_size)
            out, self.state = self._plan_step(frame_size, self.state, *args)
            yield self._h2d.finish(out)

    def _decode_stream_descs(self, it, frame_size: int):
        consts = self._frame_consts(frame_size)[0]
        pending = None
        for payloads in it:
            desc = self._host_decode(payloads, frame_size)
            if pending is not None:
                yield self._h2d.finish(pending)
            pending, self.state = synthesis_step(consts, self.state, desc,
                                                 n=frame_size)
        if pending is not None:
            yield self._h2d.finish(pending)

    def _decode_stream_chunked(self, it, frame_size: int, chunk: int):
        """Dispatch chunk i, then run the native decode of chunk i+1 while
        the device finishes i."""
        def next_batch():
            batch = []
            for payloads in it:
                batch.append(payloads)
                if len(batch) >= chunk:
                    break
            return batch

        batch = next_batch()
        if not batch:
            return
        host = self._host_decode_chunk(batch, frame_size)
        while True:
            pcm = self._dispatch_chunk(host, frame_size)
            batch = next_batch() if len(batch) == chunk else []
            if batch:
                host = self._host_decode_chunk(batch, frame_size)
            self._h2d.finish(pcm)
            yield from pcm
            if not batch:
                return

    def decode_frames_scanned(self, frames: list, frame_size: int = 960):
        """Decode a whole list of frames (each: S payloads) with one
        stacked-arena copy and the scanned step. Returns a
        (K, S, frame, channels) tensor on the device; plan mode only."""
        host = self._host_decode_chunk(frames, frame_size)
        return self._dispatch_chunk(host, frame_size)

    def _host_decode_chunk(self, frames: list, frame_size: int):
        """Pure-CPU half of the scanned chunk decode (native symbol stage
        into the contiguous (K, words) backing)."""
        if self._shards is not None:
            raise ValueError("the scanned decode runs on one device, "
                             "not under a mesh")
        if not self.use_plan:
            raise ValueError("the scanned decode needs plan mode")
        if not frames:
            raise ValueError("decode_frames_scanned needs >= 1 frame batch")
        self._h2d.wait()
        with record_function("host.celt_decode"):
            backing2d, aux_list, any_direct, any_lost = \
                self._native.decode_plan_chunk(frames, frame_size)
        # NB: the native decoder has already advanced through ALL K frames
        # before this check runs, so a raise here leaves the native stream
        # states desynced for the whole chunk (the per-frame `step` path
        # raises immediately instead). Callers that must survive malformed
        # packets use step().
        for k, aux in enumerate(aux_list):
            rcs = aux["rcs"]
            if np.any(rcs < 0):
                bad = int(np.argmax(rcs < 0))
                raise ValueError(f"chunk frame {k} stream {bad}: native "
                                 f"celt plan decode failed rc={rcs[bad]}")
        return backing2d, aux_list, any_direct, any_lost

    def _dispatch_chunk(self, host, frame_size: int):
        """Device half: copy the stacked arenas and run the scanned step.
        The returned (K, S, frame, C) tensor is not synchronised."""
        backing2d, aux_list, any_direct, any_lost = host
        consts, plc_consts, mats, xd = self._frame_consts(frame_size)
        if any_direct:
            xd = self._h2d.to_device(np.stack(
                [aux["x_direct"] for aux in aux_list]))
        pcm, self.state, self.plc_state = plan_synthesis_scan(
            consts, plc_consts, self.state, self.plc_state,
            self._h2d.arena_to_device(backing2d), xd, mats,
            any_lost=any_lost, channels=self.channels, frame=frame_size,
            n_streams=self.S)
        return pcm


class SilkStreamPipeline:
    """Decode S parallel mono SILK streams with the batched device
    8/12/16 kHz -> 48 kHz up-resampler on the back. Two placements of the
    synthesis:

    * ``synthesis="host"``: the native host decodes symbols and
      synthesises (int16-exact); only the resampler runs on the device.
    * ``synthesis="device"``: the native host decodes SYMBOLS only (side
      info + excitation) and the LTP/LPC core runs as the batched
      ops/silk_synthesis.py step before the resampler; out_hist/lpc_hist
      live on the device. Float-level PCM against the bit-exact host.
      Lossless 20 ms batches (the host concealment needs synthesised PCM).
    """

    def __init__(self, n_streams: int, fs_khz: int = 16, frame_ms: int = 20,
                 synthesis: str = "host", *, device):
        from .silk import host_native as silk_native

        if fs_khz not in _SILK_RATES:
            raise ValueError("SILK internal rate must be 8/12/16 kHz")
        if synthesis not in ("host", "device"):
            raise ValueError("synthesis must be 'host' or 'device'")
        if synthesis == "device" and frame_ms != 20:
            raise ValueError("device synthesis: 20 ms frames only")
        self.S = n_streams
        self.fs_khz = fs_khz
        self.frame_ms = frame_ms
        self.synthesis = synthesis
        self.device = _device.as_device(device)
        self._h2d = _HostStaging(self.device)
        self.hosts = [silk_native.NativeSilkHost() for _ in range(n_streams)]
        self._plan = make_up48_plan(fs_khz * frame_ms, fs_khz, self.device)
        self._rs_state = init_up48_state(n_streams, self.device)
        if synthesis == "device":
            self._silk_state = init_silk_state(n_streams, fs_khz,
                                               self.device)

    def _resample(self, x):
        with record_function("silk.resample"):
            out, self._rs_state = up48_step(x, self._rs_state, self._plan)
            return out / 32768.0

    def _step_device(self, payloads: list):
        L = self.fs_khz * self.frame_ms
        S = self.S
        exc = np.empty((S, L), np.float32)
        a = np.empty((S, 2, 16), np.float32)
        b = np.empty((S, 4, 5), np.float32)
        pitch = np.empty((S, 4), np.int32)
        gains = np.empty((S, 4), np.float32)
        voiced = np.empty(S, bool)
        interp = np.empty(S, bool)
        ltp_scale = np.empty(S, np.float32)
        with record_function("host.silk_decode"):
            for s, payload in enumerate(payloads):
                d = self.hosts[s].decode_symbols(payload, self.fs_khz)
                exc[s] = d["exc"]
                a[s] = d["a"]
                b[s] = d["b"]
                pitch[s] = d["pitch_l"]
                gains[s] = d["gains"]
                voiced[s] = d["voiced"]
                interp[s] = d["interp"]
                ltp_scale[s] = d["ltp_scale"]
        params = SilkFrameParams(*(self._h2d.to_device(v) for v in (
            exc, a, b, pitch, gains, voiced, ltp_scale, interp)))
        with record_function("silk.synthesis"):
            xq, self._silk_state = silk_synthesis_step(
                params, self._silk_state, nb_subfr=4,
                subfr_len=self.fs_khz * self.frame_ms // 4)
        return self._resample(xq)

    def step(self, payloads: list):
        """payloads: S SILK payload byte strings -> (S, 48 * frame_ms)
        float32 tensor on the pipeline's device."""
        if len(payloads) != self.S:
            raise ValueError(f"{len(payloads)} payloads for {self.S} streams")
        if self.synthesis == "device":
            return self._step_device(payloads)
        x = np.empty((self.S, self.fs_khz * self.frame_ms), np.float32)
        with record_function("host.silk_decode"):
            for s, payload in enumerate(payloads):
                x[s] = self.hosts[s].decode(payload, self.fs_khz,
                                            self.frame_ms)
        return self._resample(self._h2d.to_device(x))


def _masked(mask, new, old):
    """Per field of a state tuple: rows where `mask` holds take `new`,
    the others keep `old`."""
    return type(old)(*(
        torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
        for a, b in zip(new, old)))


class OpusStreamPipeline:
    """Decode S parallel Opus streams of mixed SILK / CELT / hybrid 20 ms
    packets, one frame per step, batched on one device (or split over a
    mesh).

    The native unified host (opus_host_native) routes each packet by TOC:
    CELT frames emit packed band plans, SILK frames decode to pcm at
    their internal rate, hybrid frames run SILK then resume the same
    range decoder into the CELT plan decode. One device step then runs
    the CELT band reconstruction + synthesis, the batched up-resamplers
    (one per SILK rate, selected per stream by mask), and sums the two
    paths: the per-stream mode needs no mask of its own because inactive
    components carry all-zero inputs.

    Scope: 20 ms steps (the push/tick feeder splits multi-frame and
    10/40/60 ms SILK packets); streams keep a consistent mode (no
    per-stream mode switching with transition smoothing). Mono pipelines
    take NB/MB/WB SILK, hybrid and mono CELT; stereo pipelines take
    stereo CELT, stereo SILK, stereo hybrid, mono hybrid and mono SILK
    (duplicated to both channels).

    silk_synthesis="device" (mono): WB SILK streams carry their frame
    parameters on the wire and the LTP/LPC core runs on the device
    (ops/silk_synthesis.py); such streams must be lossless.

    mesh: a StreamMesh to split the streams over (n_streams a multiple of
    its size), one pipeline of this class a shard; `device` is where the
    gathered PCM lands, one of the mesh's devices. Packets, fec_packets
    and the feeder's queues stay indexed by global stream; `last_modes`
    holds every shard's modes in stream order.
    """

    def __init__(self, n_streams: int, host_threads: int = 0,
                 channels: int = 1, mesh=None,
                 silk_synthesis: str = "host", *, device):
        from .opus_host_native import NativeOpusHostBatch

        if silk_synthesis not in ("host", "device"):
            raise ValueError("silk_synthesis must be 'host' or 'device'")
        if silk_synthesis == "device" and channels != 1:
            raise ValueError("device SILK synthesis: mono pipelines only")
        self.S = n_streams
        self.channels = channels
        self._shards = None
        self._lo = 0            # global index of stream 0 (error messages)
        self._cache = {}        # device constants, built at the first step
        self.last_modes = None
        self._queues = None  # feeder mode (push/tick), built on first push
        if mesh is not None:
            self.device, self._shards = _shard_pipelines(
                mesh, n_streams, device, lambda n, dev: OpusStreamPipeline(
                    n, host_threads, channels, None, silk_synthesis,
                    device=dev))
            self._h2d = _HostStaging(self.device)
            return
        self.device = dev = _device.as_device(device)
        self._h2d = _HostStaging(dev)
        self._silk_device = silk_synthesis == "device"
        self._native = NativeOpusHostBatch(n_streams, channels, host_threads,
                                           arena_alloc=self._h2d.alloc)
        self.state = init_state(n_streams, channels, dev)
        self.plc_state = init_plc_state(n_streams, channels, dev)
        # one up-resampler plan per SILK internal rate; a stream's rate
        # selects its output (and which state advances) by mask. Stereo
        # pipelines resample each SILK channel on its own (stereo SILK
        # decodes natively to L/R planes): one row per (stream, channel)
        self._rows = n_streams * channels
        self.rs_states = {r: init_up48_state(self._rows, dev)
                          for r in _SILK_RATES}
        self.silk_prev = torch.zeros((self._rows,), dtype=torch.float32,
                                     device=dev)
        self.prev_fs = torch.full((n_streams,), 16, dtype=torch.int32,
                                  device=dev)
        self.silk_dev_state = None
        if self._silk_device:
            self.silk_dev_state = init_silk_state(n_streams, 16, dev)
            self._last_real_mode = np.zeros(n_streams, np.int32)

    def _consts(self) -> dict:
        """The device constants: synthesis, PLC and combo constants, one
        up-resampler plan per SILK rate and the all-zero x_direct."""
        k = self._cache
        if not k:
            dev = self.device
            k.update(
                synthesis=make_consts(960, dev),
                plc=make_plc_consts(960, MODE.window, dev),
                mats=plan_combo_mats(self.channels, 960, dev),
                up48={r: make_up48_plan(20 * r, r, dev) for r in _SILK_RATES},
                xd_zeros=torch.zeros((self.S, self.channels, 960),
                                     dtype=torch.float32, device=dev))
        return k

    # ------------------------------------------------------------------
    def _silk_lane(self, silk16, sf, si, dev_mask):
        """Device-SILK lane: the streams of `dev_mask` carry
        SilkFrameParams on the wire instead of host-synthesised pcm; the
        LTP/LPC core runs here and its output replaces those streams'
        silk16 rows. Masked-out streams run on stale-but-valid parameters
        and are discarded; only the lane's streams advance their state."""
        S = sf.shape[0]
        params = SilkFrameParams(
            exc=sf[:, :320],
            a=sf[:, 320:352].reshape(S, 2, 16),
            b=sf[:, 352:372].reshape(S, 4, 5),
            pitch_l=torch.clamp(si[:, :4], min=18),
            gains=sf[:, 372:376],
            voiced=si[:, 4] != 0,
            ltp_scale=sf[:, 376],
            interp=si[:, 5] != 0)
        xq, new_state = silk_synthesis_step(params, self.silk_dev_state,
                                            nb_subfr=4, subfr_len=80)
        self.silk_dev_state = _masked(dev_mask, new_state,
                                      self.silk_dev_state)
        return torch.where(dev_mask[:, None], xq, silk16)

    def _resample(self, xs, silk_fs, sdel):
        """The per-rate masked up-resamplers: (rows, 320) SILK pcm at each
        row's rate -> (rows, 960) at 48 kHz.

        The SILK decode API feeds its resampler through a 1-sample delay
        (the stereo-prediction tail), mirrored here for exact alignment.
        Stereo-SILK rows (sdel) are already delayed: the native MS->LR
        unmix bakes the delay into its output window. A stream whose rate
        switched starts that rate's filter from zero state."""
        ch = self.channels
        fs_rows = silk_fs.repeat_interleave(ch)
        pfs_rows = self.prev_fs.repeat_interleave(ch)
        sdel_rows = sdel.repeat_interleave(ch)
        up = torch.zeros((xs.shape[0], 960), dtype=torch.float32,
                         device=xs.device)
        new_prev = torch.zeros_like(self.silk_prev)
        zero = torch.zeros((), dtype=torch.float32, device=xs.device)
        for r in _SILK_RATES:
            L = 20 * r
            on = fs_rows == r
            switched = on & (pfs_rows != r)
            old = self.rs_states[r]
            st_r = type(old)(*(
                torch.where(switched[:, None], zero, z) for z in old))
            x_mono = torch.cat([self.silk_prev[:, None], xs[:, :L - 1]],
                               dim=1)
            x = torch.where(sdel_rows[:, None], xs[:, :L], x_mono)
            up_r, rs_r = up48_step(x, st_r, self._consts()["up48"][r])
            up = torch.where(on[:, None], up_r, up)
            self.rs_states[r] = _masked(on, rs_r, old)
            new_prev = torch.where(on, xs[:, L - 1], new_prev)
        self.silk_prev = new_prev
        self.prev_fs = silk_fs
        return up

    def _step_core(self, backing, xd, any_lost, silk16, silk_fs, sdel,
                   sf=None, si=None, dev_mask=None):
        """The device step: CELT plan step with concealment, the
        device-SILK lane (silk_synthesis="device"), the three per-rate
        resamplers and the sum."""
        S = self.S
        k = self._consts()
        pcm, self.state, self.plc_state = plan_synthesis_step_plc(
            k["synthesis"], k["plc"], self.state, self.plc_state,
            backing, xd, k["mats"], any_lost=any_lost,
            channels=self.channels, frame=960, n_streams=S)
        xs = silk16.to(torch.float32)                      # (rows, 320)
        if sf is not None:
            with record_function("silk.synthesis"):
                xs = self._silk_lane(xs, sf, si, dev_mask)
        with record_function("silk.resample"):
            up = self._resample(xs, silk_fs, sdel)
        with record_function("mixed.sum"):
            if self.channels == 2:
                upc = up.reshape(S, 2, 960).transpose(1, 2)
            else:
                upc = up[:, :, None]
            return pcm + upc * (1.0 / 32768.0)

    # ------------------------------------------------------------------
    def push(self, s: int, packet: bytes | None) -> None:
        """Feeder mode: queue one packet (or None = one lost 20 ms tick)
        for stream s, then call tick() to decode 20 ms for all streams.

        Accepts multi-frame packets (codes 1-3) and 10/40/60 ms SILK
        frames: CELT and hybrid frames are 20 ms each and re-wrapped as
        code-0 packets; 40/60 ms SILK frames decode natively in one call
        at tick time and feed 20 ms chunks; 10 ms SILK frames pair up per
        tick (an unpaired half zero-pads its second 10 ms). 2.5-10 ms
        CELT and 10 ms hybrid frames are refused (the device step is
        fixed at 960 samples)."""
        if self._queues is None:
            self._queues = [deque() for _ in range(self.S)]
        q = self._queues[s]
        if packet is None:
            q.append(None)
            return
        toc = packet[0]
        config = toc >> 3
        frames = parse_packet(packet).frames
        toc0 = bytes([toc & 0xFC])  # same config + stereo bit, code 0
        if config >= 16:  # CELT: (config & 3) = 2.5/5/10/20 ms
            if (config & 3) != 3:
                raise ValueError("feeder supports 20 ms CELT frames only")
            q.extend(("f", toc0 + f) for f in frames)
        elif config >= 12:  # hybrid: 10/20 ms
            if (config & 1) != 1:
                raise ValueError("feeder supports 20 ms hybrid frames only")
            q.extend(("f", toc0 + f) for f in frames)
        else:  # SILK: 10/20/40/60 ms
            dur = (10, 20, 40, 60)[config & 3]
            fs = 8 if config < 4 else (12 if config < 8 else 16)
            if dur == 10:
                # half-tick frames: paired up at tick time (a steady
                # 10 ms stream delivers two packets per 20 ms tick)
                q.extend(("h", f, fs) for f in frames)
            elif dur == 20:
                q.extend(("f", toc0 + f) for f in frames)
            else:
                q.extend(("m", f, fs, dur) for f in frames)

    def tick(self):
        """Feeder mode: decode the next 20 ms for every stream from its
        queue (an empty queue underruns as a lost tick and is concealed).
        Returns a tensor (S, 960, channels) float32 on the device."""
        from .opus_host_native import SKIP

        if self._queues is None:
            raise ValueError("push() packets before tick()")
        packets = [None] * self.S
        fills = {}
        for s in range(self.S):
            q = self._queues[s]
            item = q.popleft() if q else None
            if item is None:
                continue
            if item[0] == "f":
                packets[s] = item[1]
                continue
            if item[0] == "h":  # 10 ms SILK half-tick frames, paired
                _, pay, fs = item
                half1 = self._silk_frames(s, pay, fs, 10)
                if q and q[0] is not None and q[0][0] == "h" \
                        and q[0][2] == fs:
                    _, pay2, _ = q.popleft()
                    half2 = self._silk_frames(s, pay2, fs, 10)
                else:
                    half2 = np.zeros(10 * fs, np.int16)  # half underrun
                chunk = np.concatenate([half1, half2])
            elif item[0] == "m":  # head of a 40/60 ms SILK frame
                _, pay, fs, dur = item
                pcm = self._silk_frames(s, pay, fs, dur)
                L = 20 * fs
                for k in range(dur // 20 - 1, 0, -1):
                    q.appendleft(("pcm", pcm[k * L:(k + 1) * L], fs))
                chunk = pcm[:L]
            else:  # buffered 20 ms chunk
                _, chunk, fs = item
            fills[s] = (chunk, fs)
            packets[s] = SKIP
        return self.step(packets, 960, _fills=fills)

    def _silk_frames(self, s: int, payload: bytes, fs: int, ms: int):
        """Stream s's SILK frames of `ms` ms decoded natively at once, by
        the native batch that holds the stream."""
        if self._shards is None:
            return self._native.decode_silk_frames(s, payload, fs, ms)
        shard = self._shards[s // self._shards[0].S]
        return shard._native.decode_silk_frames(s - shard._lo, payload, fs,
                                                ms)

    def _step_sharded(self, packets, fec_packets, fills):
        """Each shard steps its own streams; the feeder's fills go to the
        shard that holds their stream, at its index there."""
        pcms, modes = [], []
        for shard in self._shards:
            lo, hi = shard._lo, shard._lo + shard.S
            pcms.append(shard.step(
                packets[lo:hi], 960,
                None if fec_packets is None else fec_packets[lo:hi],
                {s - lo: v for s, v in (fills or {}).items()
                 if lo <= s < hi}))
            modes.append(shard.last_modes)
        self.last_modes = np.concatenate(modes)
        return streaming.gather(pcms, self.device)

    def step(self, packets: list, frame_size: int = 960,
             fec_packets: list | None = None, _fills: dict | None = None):
        """packets: S whole Opus packets (one 20 ms frame each); None
        entries are lost frames. fec_packets (optional): per lost stream,
        the NEXT packet, whose in-band LBRR replaces the loss when
        present (SILK/hybrid); otherwise the loss is concealed. Returns a
        tensor (S, 960, channels) float32 on the pipeline's device."""
        if frame_size != 960:
            # the native opus host plan path hard-codes 20 ms plane
            # offsets; any other frame size would corrupt the arena layout
            raise ValueError("OpusStreamPipeline supports 20 ms (960-sample) "
                             f"frames only, got {frame_size}")
        if self._shards is not None:
            return self._step_sharded(packets, fec_packets, _fills)
        self._h2d.wait()
        with record_function("host.opus_decode"):
            out = self._native.decode(packets, frame_size, fec_packets,
                                      silk_params=self._silk_device)
        arenas, aux, layout, silk16, modes, silk_fs, silk_stereo = out[:7]
        if self._silk_device:
            # loss scope guard: device-SILK streams keep their synthesis
            # state on the device, so the host concealment has no pcm
            # history for them
            concealed = np.isin(modes, (3, 4))
            bad = concealed & (self._last_real_mode == 5)
            if bad.any():
                raise ValueError(
                    "silk_synthesis='device' serves lossless SILK "
                    f"streams; stream {self._lo + int(np.argmax(bad))} lost "
                    "a frame (use the default host synthesis for lossy SILK)")
            self._last_real_mode = np.where(concealed,
                                            self._last_real_mode, modes)
        if _fills:
            for s, (chunk, fs) in _fills.items():
                silk16[s, :len(chunk)] = chunk
                if self.channels == 2:  # duplicate the mono chunk
                    silk16[s, 320:320 + len(chunk)] = chunk
                silk_fs[s] = fs
        rcs = aux["rcs"]
        if np.any(rcs < 0):
            bad = int(np.argmax(rcs < 0))
            raise ValueError(f"stream {self._lo + bad}: native opus host "
                             f"decode failed rc={rcs[bad]}")
        self.last_modes = modes
        # device CELT concealment only for concealed streams (rc 1), not
        # for FEC-recovered ones (rc 2: the LBRR frame replaces the loss);
        # the mask rides the arena copy (lost8 plane) and its host copy
        # gates the concealment
        lost = rcs == 1
        host_native.plane_of(arenas, layout, "lost8")[:] = lost
        any_direct = bool(
            host_native.plane_of(arenas, layout, "direct").any())
        to_dev = self._h2d.to_device
        xd = (to_dev(aux["x_direct"]) if any_direct
              else self._consts()["xd_zeros"])
        lane = {}
        if self._silk_device:
            lane = dict(sf=to_dev(out[7][0]), si=to_dev(out[7][1]),
                        dev_mask=to_dev(modes == 5))
        return self._step_core(
            self._h2d.arena_to_device(arenas["backing"]), xd,
            bool(lost.any()), to_dev(silk16.reshape(self._rows, 320)),
            to_dev(silk_fs), to_dev(silk_stereo != 0), **lane)

    def decode_stream(self, frames_iter, frame_size: int = 960):
        """Generator over frames of S packets; each yielded tensor is
        finished."""
        for packets in frames_iter:
            yield self._h2d.finish(self.step(packets, frame_size))


class _EncodeReadback:
    """Device-to-host copies of the front's outputs for the native symbol
    encoder: the spectrum, the (S, 6) integer and the (S, 3) float
    parameter planes of K frames.

    On a GPU the three planes land in page-locked host buffers, a ring of
    two sets allocated once (and again only for a larger chunk), through
    asynchronous copies followed by an event; `fetch` waits on that event
    before it hands the buffers out, so the bytes have landed when the
    native encoder reads them. A set is free again once its frames are
    encoded: a caller keeps at most two chunks in flight. On the CPU the
    tensors themselves are handed over.
    """

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        self._sets = [None, None]
        self._next = 0

    def _buffers(self, planes):
        held = self._sets[self._next]
        if held is None or any(
                h.shape[0] < p.shape[0] or h.shape[1:] != p.shape[1:]
                or h.dtype != p.dtype for h, p in zip(held, planes)):
            held = self._sets[self._next] = tuple(
                torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                for p in planes)
        self._next ^= 1
        return held

    def start(self, freq, iparams, fparams):
        """Begin the copy of (K, S, ...) planes; returns a ticket for
        `fetch`."""
        planes = (freq, iparams, fparams)
        if not self.cuda:
            return planes, None
        K = freq.shape[0]
        with record_function("host.d2h"):
            held = tuple(h[:K] for h in self._buffers(planes))
            for h, p in zip(held, planes):
                h.copy_(p, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return held, event

    @staticmethod
    def fetch(ticket):
        """The three planes as numpy arrays, once the copy is done."""
        planes, event = ticket
        if event is not None:
            with record_function("host.d2h"):
                event.synchronize()
        return tuple(p.numpy() for p in planes)


class CeltEncodePipeline:
    """Batched CELT encode: the device front half (preemphasis, tone
    detection, prefilter pitch search and application, transient
    analysis, forward MDCT: ops/encode_front.py) feeding S native symbol
    encoders (coarse/fine energy, allocation, PVQ search, range coding).
    Packets are standard CELT-only Opus frames (without the TOC byte),
    decodable by any conformant decoder. Constant bit rate: every frame
    gets the same byte budget.

    The symbol encoders are the native library's; there is no
    pure-Python back half, and a library that does not build raises here.
    """

    def __init__(self, n_streams: int, channels: int = 2,
                 bitrate: int = 128000, frame_size: int = 960, *, device):
        self.S = n_streams
        self.channels = channels
        self.frame = frame_size
        self.device = dev = _device.as_device(device)
        self.nbytes = max(12, int(bitrate * frame_size / (8 * 48000)))
        self._consts = make_front_consts(frame_size, dev)
        self._state = init_front_state(n_streams, channels, frame_size, dev)
        self._native = host_native.NativeCeltEncoderBatch(
            n_streams, channels=channels)
        self._nby = torch.full((n_streams,), self.nbytes, dtype=torch.int32,
                               device=dev)
        self._d2h = _EncodeReadback(dev)

    def _pcm(self, pcm, ndim: int):
        """pcm (array or tensor) as a float32 tensor on the device; its
        last three axes must be (S, frame, channels)."""
        pcm = torch.as_tensor(pcm, dtype=torch.float32)
        want = (self.S, self.frame, self.channels)
        if pcm.dim() != ndim or tuple(pcm.shape[-3:]) != want:
            raise ValueError(f"pcm {tuple(pcm.shape)}: expected {ndim} axes "
                             f"ending in {want}")
        return pcm.to(self.device)

    def _tapset(self):
        return torch.from_numpy(self._native.tapsets()).to(self.device)

    def front(self, pcm) -> dict:
        """The device half alone: one front step, state advanced; returns
        the analysis tensors on the device."""
        out, self._state = front_step(
            self._consts, self._state, self._pcm(pcm, 3), self._nby,
            self._tapset())
        return out

    def _params(self, out: dict):
        """The parameter planes of the native encoder, built on the
        device: (..., S, 6) int32 [silence, pf_on, pitch_index, qg,
        is_transient, nbytes] and (..., S, 3) float32 [tone_freq,
        toneishness, tf_estimate]."""
        i32 = torch.int32
        iparams = torch.stack(
            [out["silence"].to(i32), out["pf_on"].to(i32),
             out["pitch_index"], out["qg"], out["is_transient"].to(i32),
             self._nby.expand_as(out["qg"])], dim=-1)
        fparams = torch.stack([out["tone_freq"], out["toneishness"],
                               out["tf_estimate"]], dim=-1)
        return out["freq"], iparams, fparams

    def _native_back(self, freq, iparams, fparams) -> list:
        """One frame's native symbol encode from fetched planes."""
        if freq.dtype != np.float32:
            freq = freq.astype(np.float32)       # the compact f16 readback
        with record_function("host.celt_encode"):
            return self._native.encode(freq, iparams, fparams, self.frame)

    def _drain(self, ticket) -> list:
        freq, iparams, fparams = self._d2h.fetch(ticket)
        return [self._native_back(freq[k], iparams[k], fparams[k])
                for k in range(freq.shape[0])]

    def step(self, pcm) -> list:
        """pcm: (S, frame, channels) float in [-1, 1] (array or tensor)
        -> S packets."""
        planes = self._params(self.front(pcm))
        return self._drain(self._d2h.start(*(p[None] for p in planes)))[0]

    def _front_chunk(self, pcms):
        outs, self._state = front_scan(
            self._consts, self._state, self._pcm(pcms, 4), self._nby,
            self._tapset(), compact=True)
        return self._d2h.start(*self._params(outs))

    def step_chunk(self, pcms) -> list:
        """Encode K frames a stream with one read-back: pcms is
        (K, S, frame, channels) float in [-1, 1]; returns a list of K
        lists of S packets. The native encoder's tapset decision feeds
        back once a chunk (up to K frames of lag), and the spectra cross
        to the host as float16."""
        return self._drain(self._front_chunk(pcms))

    def encode_stream(self, pcms_iter):
        """Pipelined chunked encode: a generator over (K, S, frame,
        channels) chunks that yields one list of S packets per FRAME.
        The native symbol encode of chunk i runs while the device works
        on the front of chunk i+1: they share only the tapset feedback,
        which here lags up to 2K frames. The read-back of a chunk goes
        into one of two sets of page-locked buffers and is waited on, by
        its event, just before its frames are encoded."""
        pending = None
        for pcms in pcms_iter:
            ticket = self._front_chunk(pcms)
            if pending is not None:
                yield from self._drain(pending)
            pending = ticket
        if pending is not None:
            yield from self._drain(pending)


class SilkEncodePipeline:
    """Batched SILK encode with the device noise-shaping quantizer: S
    per-stream encoders (`hostcodec/`, the numpy host codec in forced
    SILK mode) run the analysis chain (Burg LPC, three-stage pitch
    search, shaping analysis) on host threads, and every quantizer round
    runs as ONE batched call on the device (ops/silk_nsq.py through
    parallel/nsq_batch.py). Packets are standard SILK mono Opus packets.
    The quantizer's lanes are independent, so a stream's packets do not
    depend on its batch.

    The batching engages for wide-band (16 kHz internal) 20 ms frames,
    the device quantizer's shape; other rates quantize on the host
    inline.
    """

    def __init__(self, n_streams: int, bitrate: int = 24000, *, device):
        from .hostcodec.bitstream.packet import Mode
        from .hostcodec.opus_encoder import APP_VOIP, OpusEncoder
        from .parallel.nsq_batch import NsqBatchExecutor

        self.S = n_streams
        self.device = _device.as_device(device)
        self._ex = NsqBatchExecutor(n_streams, device=self.device)
        self.encs = []
        for _ in range(n_streams):
            e = OpusEncoder(48000, 1, APP_VOIP)
            e.set_bitrate(bitrate)
            e.force_mode = Mode.SILK
            e.silk.nsq_fn = self._ex.hook
            self.encs.append(e)

    def step(self, pcm) -> list:
        """pcm: (S, 960) or (S, 960, 1) float in [-1, 1] -> S packets."""
        if isinstance(pcm, torch.Tensor):
            pcm = pcm.detach().cpu().numpy()
        pcm = np.asarray(pcm, np.float64)
        if pcm.ndim == 2:
            pcm = pcm[:, :, None]
        if pcm.shape[0] != self.S or pcm.shape[2] != 1:
            raise ValueError(f"pcm {pcm.shape}: expected ({self.S}, n, 1)")
        tasks = [
            (lambda s=s: self.encs[s].encode(pcm[s], pcm.shape[1]))
            for s in range(self.S)
        ]
        with record_function("silk.encode"):
            return self._ex.run(tasks)
