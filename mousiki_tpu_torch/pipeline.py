"""End-to-end batched CELT stream decoder in PyTorch (plan mode): port of
mousiki_tpu/pipeline.py CeltStreamPipeline(use_plan=True).

  S payloads --native symbol stage--> one packed int32 plan arena
             --blocking host-to-device copy--> device step
             (unpack + band plans + PLC + synthesis) --> (S, N, C) PCM

The host half is the port's own copy of the native C++ symbol decoder
(`celt/host_native.py`, built with g++ from `csrc/celt_host.cpp` at first
use); there is no Python-decoder fallback here.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _device
from .celt import host_native
from .celt.modes import MODE
from .ops.band_exec import plan_combo_mats, plan_synthesis_step_plc
from .ops.plc import init_plc_state, make_plc_consts
from .ops.synthesis import init_state, make_consts

# bench.py's serving plan profile: (leaf-tier slots, fills, fill pool)
SERVING_PROFILE = ((144, 40, 6), 2, 8)


def set_plan_profile(tiers=None, fills=None, pool=None) -> None:
    """Set the port's native host stage's plan capacities, process-wide
    (every pipeline of the port; the JAX package's library keeps its
    own). No arguments restore the full profile. A stream that
    overflows a tier falls back to the exact direct decoder, so the
    profile moves the arena size, not the output."""
    host_native.set_plan_profile(tiers, fills, pool)


class CeltStreamPipeline:
    """Decode S parallel CELT streams, one 48 kHz frame per step.

    Plan mode only: the native host decodes symbols into packed band
    plans; band reconstruction, concealment of lost packets and synthesis
    run on `device`. A payload of None marks that stream's packet lost.
    """

    def __init__(self, n_streams: int, channels: int = 2,
                 use_plan: bool = True, *, device):
        if not use_plan:
            raise ValueError("only plan mode is ported (use_plan=True)")
        self.S = n_streams
        self.channels = channels
        self.use_plan = True
        self.device = _device.as_device(device)
        self._native = host_native.NativeCeltHostBatch(
            n_streams, channels=channels, disable_inv=channels == 1)
        self.state = init_state(n_streams, channels, self.device)
        self.plc_state = init_plc_state(n_streams, channels, self.device)
        # per-frame-size constants (LM 0-3) and the all-zero x_direct,
        # which is shipped only when some stream fell back to the direct
        # decoder
        self._consts = {}
        self._mats = {}
        self._plc_consts = {}
        self._xd_zeros = {}

    def _frame_consts(self, frame_size: int):
        if frame_size not in self._consts:
            dev = self.device
            self._consts[frame_size] = make_consts(frame_size, dev)
            self._mats[frame_size] = plan_combo_mats(self.channels,
                                                     frame_size, dev)
            self._plc_consts[frame_size] = make_plc_consts(
                frame_size, MODE.window, dev)
            self._xd_zeros[frame_size] = torch.zeros(
                (self.S, self.channels, frame_size), dtype=torch.float32,
                device=dev)
        return (self._consts[frame_size], self._plc_consts[frame_size],
                self._mats[frame_size])

    def _plan_step(self, frame_size, state, backing, xd, any_lost):
        consts, plc_consts, mats = self._frame_consts(frame_size)
        pcm, new_state, self.plc_state = plan_synthesis_step_plc(
            consts, plc_consts, state, self.plc_state, backing, xd, mats,
            any_lost=any_lost, channels=self.channels, frame=frame_size,
            n_streams=self.S)
        return pcm, new_state

    # ------------------------------------------------------------------
    def _host_decode_plan(self, payloads: list, frame_size: int,
                          to_device: bool = True):
        """Plan-mode host stage: one packed arena (+ x_direct when some
        stream fell back to the direct decoder). to_device=False returns
        the host-side tuple for a later _plan_args_to_device call."""
        arenas, aux, layout = self._native.decode_plan_arenas(payloads,
                                                              frame_size)
        rcs = aux["rcs"]
        if np.any(rcs < 0):
            bad = int(np.argmax(rcs < 0))
            raise ValueError(
                f"stream {bad}: native celt plan decode failed rc={rcs[bad]}")
        name, off, shape = layout["direct"]
        any_direct = bool(arenas[name][off:off + shape[0]].any())
        # the lost mask rides the arena (lost8 plane); this host copy only
        # decides whether the concealment runs at all
        name, off, shape = layout["lost8"]
        any_lost = bool(arenas[name][off:off + shape[0]].any())
        host = (arenas, aux, any_direct, any_lost)
        if not to_device:
            return host
        return self._plan_args_to_device(host, frame_size)

    def _plan_args_to_device(self, host, frame_size: int):
        """Host-to-device half of the plan stage. The copies are blocking:
        the native decoder reuses its arena in place, so the copy must be
        done before the next native decode (and on the CPU it must be a
        copy, not an alias)."""
        arenas, aux, any_direct, any_lost = host
        self._frame_consts(frame_size)
        backing = torch.from_numpy(arenas["backing"]).to(self.device,
                                                         copy=True)
        if any_direct:
            xd = torch.from_numpy(aux["x_direct"]).to(self.device, copy=True)
        else:
            xd = self._xd_zeros[frame_size]
        return backing, xd, any_lost

    def step(self, payloads: list, frame_size: int = 960):
        """Decode one frame for every stream.

        payloads: S CELT payload byte strings (None = lost packet).
        Returns a tensor (S, frame_size, channels) on the pipeline's
        device, float32 in [-1, 1]."""
        args = self._host_decode_plan(payloads, frame_size)
        pcm, self.state = self._plan_step(frame_size, self.state, *args)
        return pcm

    def _finish(self, pcm):
        if pcm.device.type == "cuda":
            torch.cuda.synchronize(pcm.device)
        return pcm

    def decode_stream(self, frames_iter, frame_size: int = 960):
        """Generator over frames of S payloads: the native decode of frame
        k+1 runs on the host while the device works on frame k (launches
        are asynchronous); each yielded tensor is finished."""
        self._native.set_plan_buffers(1)
        it = iter(frames_iter)
        try:
            host = self._host_decode_plan(next(it), frame_size,
                                          to_device=False)
        except StopIteration:
            return
        for payloads in it:
            args = self._plan_args_to_device(host, frame_size)
            out, self.state = self._plan_step(frame_size, self.state, *args)
            host = self._host_decode_plan(payloads, frame_size,
                                          to_device=False)
            yield self._finish(out)
        args = self._plan_args_to_device(host, frame_size)
        out, self.state = self._plan_step(frame_size, self.state, *args)
        yield self._finish(out)
