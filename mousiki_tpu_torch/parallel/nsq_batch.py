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
    into one batch, moves it to the device once, runs the quantizer
    once, reads pulses and state back once, writes each lane's pulses and
    state back and releases the threads.

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
                return nsq_del_dec_best(x, st_nsq, ctl, **kw, n_states=4,
                                        warping=_WARPING)
            from ..hostcodec.silk.noise_shape import nsq_shaped
            return nsq_shaped(x, st_nsq, ctl, **kw)
        req = {"x": np.asarray(x, np.float64), "st": st_nsq, "ctl": ctl,
               "kw": kw, "event": threading.Event(), "pulses": None,
               "seed": None}
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
        each, unused lanes at harmless defaults."""
        from ..hostcodec.silk import noise_shape as ns

        S = self.S
        f32 = np.float32
        P = dict(x=np.zeros((S, _L), f32), a=np.zeros((S, 2, 16), f32),
                 b=np.zeros((S, _NB, 5), f32),
                 ar_shp=np.zeros((S, _NB, _ORDER), f32),
                 harm=np.zeros((S, _NB), f32), tilt=np.zeros((S, _NB), f32),
                 lf_ma=np.zeros((S, _NB), f32), lf_ar=np.zeros((S, _NB), f32),
                 gains=np.ones((S, _NB), f32),
                 pitch_l=np.full((S, _NB), 64, np.int32),
                 lam=np.zeros(S, f32), offset=np.zeros(S, f32),
                 voiced=np.zeros(S, bool), seed=np.zeros(S, np.int32),
                 ltp_scale=np.ones(S, f32), interp=np.zeros(S, bool))
        st = dict(xq=np.zeros((S, _M), f32), shp=np.zeros((S, _M), f32),
                  s_lpc=np.zeros((S, 16), f32),
                  s_ar2=np.zeros((S, _ORDER), f32),
                  s_lf_ar=np.zeros(S, f32), s_diff=np.zeros(S, f32),
                  lag_prev=np.zeros(S, np.int32), prev_gain=np.ones(S, f32))
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
        P, st = self.pack_requests(reqs)
        dev = self.device

        def to_dev(arrays):
            return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}

        with record_function("nsq.h2d"):
            params = silk_nsq.NsqParams(**to_dev(P))
            state = to_dev(st)
        self.dispatches += 1
        with record_function("nsq.quantize"):
            if self.use_del_dec:
                pulses, seed_used, new_state = silk_nsq.nsq_del_dec_frame(
                    params, silk_nsq.NsqDelDecState(**state), nb_subfr=_NB,
                    sub=_SUB, M=_M, n_states=4, warping=_WARPING)
            else:
                pulses, _, new_state = silk_nsq.nsq_frame(
                    params, silk_nsq.NsqDevState(**state), nb_subfr=_NB,
                    sub=_SUB, M=_M)
                seed_used = None
        with record_function("nsq.d2h"):
            pulses = pulses.cpu().numpy()
            if seed_used is not None:
                seed_used = seed_used.cpu().numpy()
            new = type(new_state)(*(v.cpu().numpy() for v in new_state))
        for i, r in enumerate(reqs):
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

        def work(i, fn):
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
