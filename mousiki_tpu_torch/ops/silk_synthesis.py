"""Batched SILK synthesis in PyTorch: port of
mousiki_tpu/ops/silk_synthesis_jax.py, the device half of the SILK decoder.

Float formulation of the SILK decode core over S concurrent streams.
Everything is computed in the output domain, which makes the fixed-point
decoder's gain-adjustment rescaling of carried state unnecessary (multiply
its recurrences through by the subframe gain and the gain_adj factors
cancel):

  * scale: e[n] = gain[subfr(n)] * exc[n]
  * LTP (voiced): r[n] = e[n] + sum_j b_j r[n - lag + 2 - j] over
    [rewhitened history | frame]. The feedback lag is >= pitch-2 >= 14
    samples, so the recurrence runs as a loop over chunks of 8 samples
    with per-stream lag gathers, the same trick as the CELT comb filter.
  * LPC: y[n] = r[n] + sum_j a_j y[n-1-j], an order-16 IIR: one step a
    sample, all streams wide, with an (S, 16) carry.

The reference compiles both loops into one program (`fori_loop`,
`lax.scan`). Here the step is `silk_synthesis_step`: one launch of a
hand-written CUDA kernel (csrc/silk_synthesis.cu) for CUDA tensors, its
plain version `silk_synthesis_step_reference` for CPU tensors, where the
loops are Python loops, 40 chunk steps and 320 sample steps a 20 ms frame
at 16 kHz, each a handful of small launches. PCM parity with the
bit-exact host decoder is float-level.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.profiler import record_function

from .. import _device
from . import _build

LTP_ORDER = 5
MAX_D = 16
CHUNK = 8    # feedback reach is lag-2 >= 14 even at the NB minimum lag
MAX_L = MAX_H = 320  # the kernel's longest frame and history (16 kHz)

# kernel launches made by `silk_synthesis_step` (not by the plain version)
silk_synthesis_launches = 0


def reset_launches() -> None:
    global silk_synthesis_launches
    silk_synthesis_launches = 0


class SilkFrameParams(NamedTuple):
    """Dense per-frame SILK parameters (leading axis = S streams)."""
    exc: torch.Tensor          # (S, L) float excitation (exc_q14 / 2^14)
    a: torch.Tensor            # (S, 2, 16) LPC coefs (a_q12 / 2^12) per half
    b: torch.Tensor            # (S, nb_subfr, 5) LTP taps (q14 / 2^14)
    pitch_l: torch.Tensor      # (S, nb_subfr) int lags (>= CHUNK+2 if voiced)
    gains: torch.Tensor        # (S, nb_subfr) linear gains (gains_q16 / 2^16)
    voiced: torch.Tensor       # (S,) bool
    ltp_scale: torch.Tensor    # (S,) float (ltp_scale_q14 / 2^14)
    interp: torch.Tensor = None  # (S,) bool: NLSF-interpolated halves
                                 # (the decode core's k == 2 rewhitening)


class SilkStreamState(NamedTuple):
    out_hist: torch.Tensor     # (S, H) previous output at the internal rate
    lpc_hist: torch.Tensor     # (S, 16) y[n-1], y[n-2], ... (output domain)


def init_silk_state(n_streams: int, fs_khz: int, device) -> SilkStreamState:
    dev = _device.as_device(device)
    H = 20 * fs_khz  # ltp_mem_length
    return SilkStreamState(
        torch.zeros((n_streams, H), dtype=torch.float32, device=dev),
        torch.zeros((n_streams, MAX_D), dtype=torch.float32, device=dev))


def _lpc_analysis_batched(x, a):
    """residual[n] = x[n] - sum_j a[j] x[n-1-j]; x: (S, T), a: (S, 16)."""
    T = x.shape[1]
    xp = torch.nn.functional.pad(x, (MAX_D, 0))
    acc = x
    for j in range(MAX_D):
        acc = acc - a[:, j:j + 1] * xp[:, MAX_D - 1 - j:MAX_D - 1 - j + T]
    return acc


def _ltp_chunks(r, params: SilkFrameParams, c_lo: int, c_hi: int,
                hist_len: int, nb_subfr: int, subfr_len: int):
    """Run the LTP recurrence over chunks c_lo..c_hi-1 of the frame, in
    place on r (S, hist + samples); chunk c_lo starts at r[:, hist_len]."""
    S = r.shape[0]
    dev = r.device
    tap_off = 2 - torch.arange(LTP_ORDER, device=dev)  # B0 at +2 .. B4 at -2
    pitch = params.pitch_l.long()
    voiced = params.voiced[:, None]
    zero = torch.zeros((), dtype=r.dtype, device=dev)
    for ci in range(c_lo, c_hi):
        n0 = hist_len + (ci - c_lo) * CHUNK
        n = n0 + torch.arange(CHUNK, device=dev)
        sub = min((ci * CHUNK) // subfr_len, nb_subfr - 1)
        lag = pitch[:, sub]                                   # (S,)
        bsub = params.b[:, sub, :]                            # (S, 5)
        idx = (n[None, :, None] - lag[:, None, None]
               + tap_off[None, None, :])                      # (S, CHUNK, 5)
        idx = torch.clamp(idx, 0, r.shape[1] - 1)
        past = torch.gather(r, 1, idx.reshape(S, -1)).reshape(
            S, CHUNK, LTP_ORDER)
        pred = (past * bsub[:, None, :]).sum(-1)
        r[:, n0:n0 + CHUNK] += torch.where(voiced, pred, zero)
    return r


def _lpc_scan(a, x, hist):
    """y[n] = x[n] + sum_j a[j] y[n-1-j], one step a sample; hist (S, 16)
    holds y[n-1], y[n-2], ... Returns (y (S, T), new hist)."""
    T = x.shape[1]
    # y laid out oldest first behind a 16-sample head: the carry of step n
    # is the reversed window y[n-16:n]
    buf = torch.cat([hist.flip(1), torch.empty_like(x)], dim=1)
    a_rev = a.flip(1)
    for n in range(T):
        buf[:, MAX_D + n] = x[:, n] + (buf[:, n:n + MAX_D] * a_rev).sum(-1)
    return buf[:, MAX_D:], buf[:, T:].flip(1)


def silk_synthesis_step_reference(params: SilkFrameParams,
                                  state: SilkStreamState,
                                  nb_subfr: int = 4, subfr_len: int = 80):
    """One SILK frame for all streams, eager torch (the plain version of
    the kernel); returns (out (S, L), new state)."""
    S, L = params.exc.shape
    H = state.out_hist.shape[1]
    dev = params.exc.device

    sub_idx = torch.clamp(torch.arange(L, device=dev) // subfr_len,
                          max=nb_subfr - 1)
    g = torch.gather(params.gains, 1, sub_idx[None, :].expand(S, L))
    e = params.exc * g

    half = (L // 2 // subfr_len) * subfr_len
    a0 = params.a[:, 0, :]
    a1 = params.a[:, 1, :]

    # -- first half: rewhiten history with half-0 LPC, scaled by ltp_scale
    # (the decode core's k == 0 rewhitening) --
    white = _lpc_analysis_batched(state.out_hist, a0) \
        * params.ltp_scale[:, None]
    r1 = torch.cat([white, e[:, :half]], dim=1)            # (S, H + half)
    with record_function("silk.ltp"):
        r1 = _ltp_chunks(r1, params, 0, half // CHUNK, H, nb_subfr,
                         subfr_len)
    with record_function("silk.lpc"):
        y1, h1 = _lpc_scan(a0, r1[:, H:], state.lpc_hist)

    # -- second half: NLSF-interpolated frames rewhiten [history | y1]
    # with the half-1 LPC (k == 2, no ltp_scale); otherwise the LTP
    # residual recurrence simply continues --
    if params.interp is None:
        r2_init = r1
    else:
        rew = _lpc_analysis_batched(
            torch.cat([state.out_hist, y1], dim=1), a1)
        r2_init = torch.where(params.interp[:, None], rew, r1)
    r2 = torch.cat([r2_init, e[:, half:]], dim=1)          # (S, H + L)
    with record_function("silk.ltp"):
        r2 = _ltp_chunks(r2, params, half // CHUNK, L // CHUNK, H + half,
                         nb_subfr, subfr_len)
    with record_function("silk.lpc"):
        y2, h2 = _lpc_scan(a1, r2[:, H + half:], h1)

    out = torch.cat([y1, y2], dim=1)
    new_hist = torch.cat([state.out_hist, out], dim=1)[:, -H:]
    return out, SilkStreamState(new_hist, h2)


# the kernel's inputs in SilkSynArg's order (csrc/silk_synthesis.h) and
# the dtype it reads each as
_INPUTS = (("exc", torch.float32), ("a", torch.float32),
           ("b", torch.float32), ("pitch_l", torch.int32),
           ("gains", torch.float32), ("voiced", torch.bool),
           ("ltp_scale", torch.float32), ("interp", torch.bool),
           ("out_hist", torch.float32), ("lpc_hist", torch.float32))


def _lane_shapes(L: int, H: int, nb_subfr: int) -> dict:
    """A stream's shape of each input."""
    return {"exc": (L,), "a": (2, MAX_D), "b": (nb_subfr, LTP_ORDER),
            "pitch_l": (nb_subfr,), "gains": (nb_subfr,), "voiced": (),
            "ltp_scale": (), "interp": (), "out_hist": (H,),
            "lpc_hist": (MAX_D,)}


_P, _INT = ctypes.c_void_p, ctypes.c_int
# each entry point's arguments: the pointer array, the stride array, S, L,
# H, nb_subfr, subfr_len (and the kernel's CUDA stream)
_ARGTYPES = {
    "mousiki_silk_synthesis": [_P, _P, _INT, _INT, _INT, _INT, _INT, _P],
    "silk_synthesis_host_step": [_P, _P, _INT, _INT, _INT, _INT, _INT],
}


def build_kernel() -> None:
    """Compile and load the kernel now (it is otherwise built on first
    launch)."""
    _build.load("silk_synthesis")


def _entry(lib, symbol: str):
    fn = getattr(lib, symbol)
    fn.argtypes = _ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return fn


def _lane_contiguous(t: torch.Tensor) -> bool:
    """Whether each stream's part of t (all axes but the first) is one
    contiguous row."""
    want = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size > 1 and stride != want:
            return False
        want *= size
    return True


def _check_shape(L: int, H: int, nb_subfr: int, subfr_len: int) -> None:
    half = (L // 2 // subfr_len) * subfr_len if subfr_len > 0 else 0
    if not (2 * MAX_D <= L <= MAX_L and 0 <= H <= MAX_H
            and 1 <= nb_subfr <= 4 and subfr_len >= 1 and L % CHUNK == 0
            and half % CHUNK == 0 and half >= MAX_D and L - half >= MAX_D):
        raise ValueError(
            f"the SILK synthesis kernel takes frames of whole 8-sample "
            f"chunks in both halves, L <= {MAX_L}, H <= {MAX_H}, up to 4 "
            f"subframes; got L={L}, H={H}, nb_subfr={nb_subfr}, "
            f"subfr_len={subfr_len}")


def _kernel_inputs(params: SilkFrameParams, state: SilkStreamState,
                   nb_subfr: int, subfr_len: int):
    """Check a call against what the kernel takes; returns the inputs in
    SilkSynArg's order (a stream's row contiguous: the tensor itself where
    it is, a strided view such as the mixed lane's among them, else one
    copy; pitch_l as int32; None for a missing interp) and the device."""
    S, L = params.exc.shape
    H = state.out_hist.shape[1]
    _check_shape(L, H, nb_subfr, subfr_len)
    dev = params.exc.device
    fields = {**params._asdict(), **state._asdict()}
    lanes = _lane_shapes(L, H, nb_subfr)
    out = []
    for name, dtype in _INPUTS:
        t = fields[name]
        if t is None and name == "interp":
            out.append(None)
            continue
        shape = (S, *lanes[name])
        if tuple(t.shape) != shape:
            raise TypeError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, exc on {dev}")
        if name == "pitch_l" and t.dtype in (torch.int32, torch.int64):
            t = t.to(torch.int32)
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        out.append(t if _lane_contiguous(t) else t.contiguous())
    return out, dev


def _run(params: SilkFrameParams, state: SilkStreamState, nb_subfr: int,
         subfr_len: int, host: bool):
    """One frame through the kernel, on CUDA tensors, or through the host
    build of its arithmetic, on CPU tensors (`host`); returns (out, new
    state)."""
    inputs, dev = _kernel_inputs(params, state, nb_subfr, subfr_len)
    if host != (dev.type == "cpu"):
        raise ValueError(f"the {'host build' if host else 'kernel'} does "
                         f"not take tensors on {dev}")
    S, L = params.exc.shape
    H = state.out_hist.shape[1]
    outs = [torch.empty(shape, dtype=torch.float32, device=dev)
            for shape in ((S, L), (S, H), (S, MAX_D))]
    if S == 0:
        return outs[0], SilkStreamState(*outs[1:])
    ptrs = (ctypes.c_void_p * (len(inputs) + 3))(
        *(0 if t is None else t.data_ptr() for t in inputs),
        *(t.data_ptr() for t in outs))
    strides = (ctypes.c_int64 * len(inputs))(
        *(0 if t is None else t.stride(0) for t in inputs))
    if host:
        symbol = "silk_synthesis_host_step"
        rc = _entry(_build.load_header_host("silk_synthesis"), symbol)(
            ptrs, strides, S, L, H, nb_subfr, subfr_len)
    else:
        symbol = "mousiki_silk_synthesis"
        fn = _entry(_build.load("silk_synthesis"), symbol)
        with torch.cuda.device(dev):
            rc = fn(ptrs, strides, S, L, H, nb_subfr, subfr_len,
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} failed: "
                           f"{'' if host else 'cuda error '}{rc}")
    return outs[0], SilkStreamState(*outs[1:])


def silk_synthesis_step(params: SilkFrameParams, state: SilkStreamState,
                        nb_subfr: int = 4, subfr_len: int = 80):
    """One SILK frame for all streams; returns (out (S, L), new state).

    CPU tensors take `silk_synthesis_step_reference`; CUDA tensors launch
    silk_synthesis_kernel once, and raise on a shape, dtype or device the
    kernel does not take. interp=None means no interpolated halves."""
    dev = params.exc.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the SILK synthesis runs on cpu or cuda, not {dev}")
    if dev.type == "cpu":
        return silk_synthesis_step_reference(params, state, nb_subfr,
                                             subfr_len)
    out = _run(params, state, nb_subfr, subfr_len, host=False)
    if params.exc.shape[0]:
        global silk_synthesis_launches
        silk_synthesis_launches += 1
    return out


def silk_synthesis_step_host(params: SilkFrameParams,
                             state: SilkStreamState, nb_subfr: int = 4,
                             subfr_len: int = 80):
    """`silk_synthesis_step` on CPU tensors through the host build of the
    kernel's arithmetic (csrc/silk_synthesis.h), the streams one after
    another."""
    return _run(params, state, nb_subfr, subfr_len, host=True)
