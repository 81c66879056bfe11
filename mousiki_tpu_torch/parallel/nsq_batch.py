"""Thread-barrier batching of the SILK encoders' noise-shaping quantizer
calls into one device call a round: port of
mousiki_tpu/parallel/nsq_batch.py.

The noise-shaping quantizer is the per-sample hot loop of the SILK
encoder. The host analysis chain (pitch, Burg LPC, shaping analysis) is
per-stream Python (`hostcodec/silk/encoder.py`), but the quantizer has a
batched device form (ops/silk_nsq.py) whose lanes are independent
streams. This module lets S concurrent encoder workers share one device
call a quantizer round:

  * every worker runs its frame analysis on its own thread and, where
    the encoder would call its host quantizer, calls the injected hook;
  * the hook parks the thread on a barrier; when no worker is runnable
    (all parked or finished), the coordinator gathers the parked calls
    into one batch, moves it to the device in one copy (every parameter
    and state array packed into one byte buffer, `_Staging`), runs the
    quantizer once (one kernel launch on a GPU), reads pulses and state
    back in one copy, writes each lane's pulses and state back and
    releases the threads.

All device work happens on the coordinator's thread (the caller of
`run`), so one CUDA stream carries it. Calls outside the device
quantizer's shape (rates other than 16 kHz, 10 ms frames, LPC order
below 16) run the host quantizer inline: the batch only ever holds
(S, 320) wide-band lanes. Lanes are independent, so a stream's packets
are the same whether it is encoded alone or inside a batch.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
from torch.profiler import record_function

from .. import _device
from ..ops import silk_nsq

_FS_KHZ = 16
_L = _FS_KHZ * 20            # wide-band 20 ms frame
_M = _FS_KHZ * 20            # ltp_mem_length
_NB = 4
_SUB = _L // _NB
_ORDER = 24                  # shaping AR capacity (silk_nsq.SHAPE_ORDER)
_WARPING = 983 * _FS_KHZ / 65536.0

# a batch's arrays, (name, dtype, a lane's shape): the kernels' table
_PARAMS, _STATE = silk_nsq.PARAM_FIELDS, silk_nsq.STATE_FIELDS
# the unused lanes' values (harmless defaults; 0 elsewhere)
_DEFAULTS = {"gains": 1, "pitch_l": 64, "ltp_scale": 1, "prev_gain": 1}


def _nbytes(dtype: torch.dtype, shape) -> int:
    return int(np.prod(shape)) * dtype.itemsize


class _Staging:
    """The byte buffers of a device call. The parameter and state arrays
    lie in one buffer, field after field, each at a 16-byte boundary, and
    go to the device in one copy, as typed views of one device buffer; the
    outputs come back in one copy. On a GPU both host buffers are
    page-locked and kept; the copy to the device is asynchronous and
    records an event, and `host_arrays` waits on it before the buffer is
    written again (as pipeline._HostStaging does). On the CPU the device
    buffer is a copy, never an alias of the reused one."""

    def __init__(self, n_slots: int, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.fields = []        # (name, dtype, (S, ...), byte offset)
        off = 0
        for name, dtype, lane in (*_PARAMS, *_STATE):
            full = (n_slots, *lane)
            self.fields.append((name, dtype, full, off))
            off += -(-_nbytes(dtype, full) // 16) * 16
        self.host = torch.zeros(off, dtype=torch.uint8, pin_memory=self.cuda)
        self._event = None
        self._back = None       # the read-back buffer, kept

    @staticmethod
    def _views(buf: torch.Tensor, layout) -> dict:
        """Typed views of a byte tensor, (name, dtype, shape, offset)."""
        return {name: buf[off:off + _nbytes(dtype, shape)].view(dtype)
                .view(shape) for name, dtype, shape, off in layout}

    def host_arrays(self) -> dict:
        """Every field as a numpy view of the host buffer, set to the
        unused lanes' defaults, once the last copy out of it is done."""
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        views = {name: v.numpy()
                 for name, v in self._views(self.host, self.fields).items()}
        for name, v in views.items():
            v[...] = _DEFAULTS.get(name, 0)
        return views

    def to_device(self) -> dict:
        """Every field as a tensor on the device: views of one copy of the
        host buffer."""
        if self.cuda:
            dev = self.host.to(self.device, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(self.device))
        else:
            dev = self.host.clone()
        return self._views(dev, self.fields)

    def read_back(self, tensors) -> list:
        """The tensors as numpy arrays, through one device-side gather of
        their bytes and one copy to the host (valid until the next
        read_back)."""
        flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors])
        if self._back is None or self._back.numel() != flat.numel():
            self._back = torch.empty(flat.numel(), dtype=torch.uint8,
                                     pin_memory=self.cuda)
        self._back.copy_(flat)
        layout, off = [], 0
        for i, t in enumerate(tensors):
            layout.append((i, t.dtype, tuple(t.shape), off))
            off += _nbytes(t.dtype, t.shape)
        views = self._views(self._back, layout)
        return [views[i].numpy() for i in range(len(tensors))]


class NsqBatchExecutor:
    """Runs S encode tasks on threads, batching their quantizer calls.

    use_del_dec=True (the default) runs the (S, 4)-state
    delayed-decision trellis (ops/silk_nsq.nsq_del_dec_frame) with warped
    feedback, the device form of the encoder's default host quantizer;
    False selects the single-state quantizer (nsq_frame)."""

    def __init__(self, n_slots: int, use_del_dec: bool = True, *, device):
        self.S = n_slots
        self.use_del_dec = use_del_dec
        self.device = _device.as_device(device)
        self.dispatches = 0      # device quantizer calls so far
        # device quantizer calls that held each task's lane (task i of
        # every `run`), so far
        self.lane_dispatches = [0] * n_slots
        self._staging = _Staging(n_slots, self.device)
        self._task = threading.local()
        self._cv = threading.Condition()
        self._running = 0
        self._waiting = []       # parked requests

    # ---------------------------------------------------------------- hook
    def hook(self, x, st_nsq, ctl, **kw):
        """Drop-in replacement for the host encoder's quantizer call."""
        if (kw["frame_length"] != _L or kw["lpc_order"] != 16
                or kw["nb_subfr"] != _NB or kw["ltp_mem_length"] != _M
                or ctl.ar.shape[1] > _ORDER):
            if self.use_del_dec:
                from ..hostcodec.silk.nsq_del_dec import nsq_del_dec_best
                # the encoder's own warping, 983 * fs_kHz in Q16, at the
                # call's internal rate (ltp_mem_length is 20 ms of it):
                # 16 kHz's at 8 or 12 kHz wrecks the shaping (err16 6.9
                # against 0.7 at 8 kbit/s, QUALITY_SILK_TORCH.md)
                fs_khz = kw["ltp_mem_length"] // 20
                return nsq_del_dec_best(x, st_nsq, ctl, **kw, n_states=4,
                                        warping=983 * fs_khz / 65536.0)
            from ..hostcodec.silk.noise_shape import nsq_shaped
            return nsq_shaped(x, st_nsq, ctl, **kw)
        req = {"x": np.asarray(x, np.float64), "st": st_nsq, "ctl": ctl,
               "kw": kw, "event": threading.Event(), "pulses": None,
               "seed": None, "task": self._task.index}
        with self._cv:
            self._waiting.append(req)
            self._running -= 1
            self._cv.notify_all()
        # the coordinator re-increments _running for every released request
        # BEFORE setting its event, so the barrier can never observe a
        # "running == 0" window while a released thread is still resuming
        req["event"].wait()
        if self.use_del_dec:
            return req["pulses"], req["seed"]
        return req["pulses"]

    # ------------------------------------------------------------ dispatch
    def pack_requests(self, reqs):
        """Quantizer calls (dicts with the call's input "x", its state
        "st", its shaping control "ctl" and its keyword arguments "kw")
        as one batch of numpy arrays: (params dict, state dict), S lanes
        each, unused lanes at harmless defaults. The arrays are views of
        the executor's staging buffer, valid until the next call."""
        from ..hostcodec.silk import noise_shape as ns

        views = self._staging.host_arrays()
        P = {name: views[name] for name, *_ in _PARAMS}
        st = {name: views[name] for name, *_ in _STATE}
        for i, r in enumerate(reqs):
            kw, ctl, stn = r["kw"], r["ctl"], r["st"]
            P["x"][i] = r["x"]
            for h in range(2):
                P["a"][i, h] = np.asarray(kw["pred_coef_q12"][h],
                                          np.float64)[:16] / 4096.0
            P["b"][i] = np.asarray(kw["ltp_coef_q14"],
                                   np.float64).reshape(_NB, 5) / 16384.0
            P["ar_shp"][i, :, :ctl.ar.shape[1]] = ctl.ar
            P["harm"][i] = ctl.harm_shape_gain
            P["tilt"][i] = ctl.tilt
            P["lf_ma"][i] = ctl.lf_ma
            P["lf_ar"][i] = ctl.lf_ar
            P["gains"][i] = np.maximum(1, np.asarray(
                kw["gains_q16"], np.int64)) / 65536.0
            P["pitch_l"][i] = kw["pitch_l"]
            P["lam"][i] = ctl.lambda_
            voiced = kw["signal_type"] == 2
            P["voiced"][i] = voiced
            P["offset"][i] = ns._QUANT_OFFSETS[1 if voiced else 0][
                ctl.quant_offset_type]
            P["seed"][i] = kw["seed"]
            P["ltp_scale"][i] = kw["ltp_scale_q14"] / 16384.0
            P["interp"][i] = kw["nlsf_interp_flag"]
            st["xq"][i] = stn.xq[:_M]
            st["shp"][i] = stn.s_ltp_shp[:_M]
            st["s_lpc"][i] = stn.s_lpc[31:15:-1]
            st["s_ar2"][i] = stn.s_ar2[:_ORDER]
            st["s_lf_ar"][i] = stn.s_lf_ar
            st["s_diff"][i] = stn.s_diff
            st["lag_prev"][i] = stn.lag_prev
            st["prev_gain"][i] = stn.prev_gain
        return P, st

    def _dispatch(self, reqs):
        self.pack_requests(reqs)
        with record_function("nsq.h2d"):
            arrays = self._staging.to_device()
            params = silk_nsq.NsqParams(*(arrays[name]
                                          for name, *_ in _PARAMS))
            state = [arrays[name] for name, *_ in _STATE]
        self.dispatches += 1
        with record_function("nsq.quantize"):
            if self.use_del_dec:
                pulses, seed_used, new_state = silk_nsq.nsq_del_dec_frame(
                    params, silk_nsq.NsqDelDecState(*state), nb_subfr=_NB,
                    sub=_SUB, M=_M, n_states=4, warping=_WARPING)
                outs = [pulses, seed_used, *new_state]
            else:
                pulses, _, new_state = silk_nsq.nsq_frame(
                    params, silk_nsq.NsqDevState(*state), nb_subfr=_NB,
                    sub=_SUB, M=_M)
                outs = [pulses, *new_state]
        with record_function("nsq.d2h"):
            host = self._staging.read_back(outs)
        pulses = host[0]
        seed_used = host[1] if self.use_del_dec else None
        new = silk_nsq.NsqDevState(*host[2 if self.use_del_dec else 1:])
        for i, r in enumerate(reqs):
            self.lane_dispatches[r["task"]] += 1
            stn = r["st"]
            stn.xq[:_M] = new.xq[i]
            stn.xq[_M:] = 0.0
            stn.s_ltp_shp[:_M] = new.shp[i]
            stn.s_ltp_shp[_M:] = 0.0
            stn.s_lpc[:16] = 0.0
            stn.s_lpc[16:] = new.s_lpc[i][::-1]
            stn.s_ar2[:_ORDER] = new.s_ar2[i]
            stn.s_lf_ar = float(new.s_lf_ar[i])
            stn.s_diff = float(new.s_diff[i])
            stn.lag_prev = int(new.lag_prev[i])
            stn.prev_gain = float(new.prev_gain[i])
            r["pulses"] = [int(v) for v in pulses[i]]
            if seed_used is not None:
                r["seed"] = int(seed_used[i])
        with self._cv:
            self._running += len(reqs)
        for r in reqs:
            r["event"].set()

    # ----------------------------------------------------------------- run
    def run(self, tasks):
        """Run the callables on threads; returns their results in order.
        Quantizer calls made by the tasks (through `hook`) are batched."""
        results = [None] * len(tasks)
        errors = []
        self.lane_dispatches += [0] * (len(tasks) - len(self.lane_dispatches))

        def work(i, fn):
            self._task.index = i
            try:
                results[i] = fn()
            except Exception as e:      # surface in the caller
                errors.append((i, e))
            finally:
                with self._cv:
                    self._running -= 1
                    self._cv.notify_all()

        threads = []
        with self._cv:
            self._running = len(tasks)
        for i, fn in enumerate(tasks):
            t = threading.Thread(target=work, args=(i, fn), daemon=True)
            threads.append(t)
            t.start()
        while True:
            with self._cv:
                self._cv.wait_for(lambda: self._running == 0)
                reqs, self._waiting = self._waiting, []
            if not reqs:
                break
            try:
                for k in range(0, len(reqs), self.S):
                    self._dispatch(reqs[k:k + self.S])
            except Exception as e:
                # release every parked thread (they fail fast on pulses
                # None) so the barrier can't deadlock on a device error
                with self._cv:
                    self._running += sum(1 for r in reqs
                                         if not r["event"].is_set())
                for r in reqs:
                    r["event"].set()
                errors.append((-1, e))
        for t in threads:
            t.join()
        if errors:
            # a device error comes first: the workers' own errors follow
            # from it (they were released without pulses)
            errors.sort(key=lambda e: e[0] != -1)
            raise errors[0][1]
        return results
