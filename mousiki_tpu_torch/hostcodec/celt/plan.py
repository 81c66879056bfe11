"""Band-reconstruction plans: the decode split that keeps only entropy
decoding on the host.

A *plan* is everything the CELT band loop (`bands.quant_all_bands`, decode
side) does to the signal, recorded as data while the host decodes symbols:
PVQ leaves carry the CWRS index (the walk index -> pulse vector is a pure
function, reference `src/celt/cwrs.rs` cwrsi), fold/noise leaves carry the
resolved source window and LCG seed, and each quant_band call carries the
small integers (tf_change, B, N) that determine its Hadamard/haar pre/post
transforms. Executing a plan reproduces the exact normalized spectrum the
direct decoder produces (reference semantics: `src/celt/bands.rs`
quant_all_bands:2575, vq.rs alg_unquant:1013, anti_collapse bands.rs:3220).

The point: a plan contains no sequential entropy work, so thousands of
streams' plans execute batched on the TPU (ops/band_exec_jax.py), cutting
the serial host stage to pure range decoding. `execute_plan` below is the
float64 NumPy reference executor the device kernel is validated against.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .cwrs import cwrsi
from .vq import alg_unquant_from_iy, exp_rotation, renormalise_vector

# Leaf kinds
PVQ = 0       # CWRS index -> pulse vector -> rotated shape
CONST = 1     # N == 1 sign leaf: X[dst] = val
FOLD = 2      # copy lowband window +- 1/256 LCG dither, renormalise
NOISE = 3     # LCG noise fill, renormalise

# Buffers fold sources can point into
BUF_NORM = 0
BUF_NORM2 = 1
BUF_SCRATCH = 2


@dataclass
class Leaf:
    kind: int
    dst: int          # absolute offset into the (C*frame,) X plane
    n: int
    k: int = 0        # PVQ: pulse count K
    b: int = 0        # PVQ: blocks at leaf (rotation + collapse mask)
    spread: int = 0
    gain: float = 1.0
    idx: int = 0      # PVQ: CWRS index
    val: float = 0.0  # CONST
    src_buf: int = 0  # FOLD
    src: int = 0      # FOLD: offset within src_buf
    seed: int = 0     # FOLD/NOISE: LCG state before this leaf


@dataclass
class Call:
    """One quant_band invocation's signal work."""
    dst: int                 # absolute X-plane offset of the band vector
    n: int                   # N0
    b0: int                  # B at entry
    tf_change: int
    has_lowband: bool = False
    lb_buf: int = BUF_NORM
    lb_src: int = 0          # offset of lowband within lb_buf
    used_scratch: bool = False
    norm_out: int = -1       # absolute offset into norm buffer, or -1
    norm_buf: int = BUF_NORM
    leaves: list = field(default_factory=list)
    n1: bool = False         # N == 1 call (no transforms)


@dataclass
class FramePlan:
    channels: int            # coded channels C (X plane is (C*frame,))
    frame: int               # frame_size N
    lm: int
    start: int
    end: int
    norm_offset: int
    norm_len: int
    short_blocks: bool
    ops: list = field(default_factory=list)   # ordered ('call',c)/('merge',..)
    direct: bool = False     # fallback: executor uses the shipped X plane
    # anti-collapse (recorded by the decoder when the AC bit is set)
    ac: dict | None = None


class PlanRecorder:
    """Hooks called from bands.py while the host decodes symbols."""

    def __init__(self, plan: FramePlan, x_base: np.ndarray,
                 norm: np.ndarray, norm2, scratch: np.ndarray):
        self.plan = plan
        # x_base may be a first-channel view; the plane spans C*frame floats
        xb = x_base.__array_interface__["data"][0]
        self._bufs = [("x", xb, plan.channels * plan.frame * x_base.itemsize,
                       x_base.itemsize)]
        for name, arr in (("norm", norm), ("norm2", norm2),
                          ("scratch", scratch)):
            if arr is None or (name == "norm2" and arr is norm):
                continue
            self._bufs.append((name, arr.__array_interface__["data"][0],
                               arr.nbytes, arr.itemsize))
        self._cur: Call | None = None

    def _locate(self, view: np.ndarray):
        ptr = view.__array_interface__["data"][0]
        for name, b0, nbytes, itemsize in self._bufs:
            if b0 <= ptr < b0 + nbytes:
                return name, (ptr - b0) // itemsize
        raise AssertionError("view not in any known buffer")

    def x_off(self, view) -> int:
        name, off = self._locate(view)
        assert name == "x", name
        return off

    def _src(self, view):
        name, off = self._locate(view)
        return {"norm": BUF_NORM, "norm2": BUF_NORM2,
                "scratch": BUF_SCRATCH}[name], off

    # -- calls ---------------------------------------------------------
    def open_call(self, X, N, B, tf_change, lowband, used_scratch,
                  lowband_out, n1=False):
        c = Call(dst=self.x_off(X), n=N, b0=B, tf_change=tf_change, n1=n1)
        if lowband is not None:
            c.has_lowband = True
            c.lb_buf, c.lb_src = self._src(lowband)
        c.used_scratch = used_scratch
        if lowband_out is not None:
            c.norm_buf, c.norm_out = self._src(lowband_out)
        self.plan.ops.append(("call", c))
        self._cur = c
        return c

    def close_call(self):
        self._cur = None

    # -- leaves --------------------------------------------------------
    def leaf_pvq(self, X, N, K, B, spread, gain, idx):
        self._cur.leaves.append(Leaf(PVQ, self.x_off(X), N, k=K, b=B,
                                     spread=spread, gain=gain, idx=idx))

    def leaf_const(self, X, val):
        self._cur.leaves.append(Leaf(CONST, self.x_off(X), 1, val=val))

    def leaf_noise(self, X, N, gain, seed):
        self._cur.leaves.append(Leaf(NOISE, self.x_off(X), N, gain=gain,
                                     seed=seed))

    def leaf_fold(self, X, N, lowband, gain, seed):
        buf, off = self._src(lowband)
        self._cur.leaves.append(Leaf(FOLD, self.x_off(X), N, gain=gain,
                                     src_buf=buf, src=off, seed=seed))

    # -- band-level ops --------------------------------------------------
    def op_merge(self, X, Y, N, mid, inv):
        self.plan.ops.append(("merge", (self.x_off(X), self.x_off(Y), N,
                                        float(mid), int(inv))))

    def op_theta2(self, X, Y, c_swap, sign, mid, side, inv):
        self.plan.ops.append(("theta2", (self.x_off(X), self.x_off(Y),
                                         int(c_swap), int(sign), float(mid),
                                         float(side), int(inv))))

    def op_avg_norm(self, upto):
        self.plan.ops.append(("avg", int(upto)))

    def op_hybrid_fold(self, n1, n2, dual):
        self.plan.ops.append(("hybrid", (int(n1), int(n2), int(dual))))


# ---------------------------------------------------------------- executor

def lcg_rand(seed: int) -> int:
    return (1664525 * seed + 1013904223) & 0xFFFFFFFF


def _haar1(X, n0, stride):
    from .bands import haar1
    haar1(X, n0, stride)


def _pre_needed(N: int, B: int, tf_change: int) -> bool:
    recombine = tf_change if tf_change > 0 else 0
    return bool(recombine or ((N // B) & 1) == 0 and tf_change < 0 or B > 1)


def _pre_transforms(lb: np.ndarray, N: int, B: int, tf_change: int) -> None:
    """Replay quant_band's lowband pre-transform (haar + deinterleave)."""
    from .bands import _deinterleave_hadamard, haar1
    N_B = N // B
    B0 = B
    long_blocks = B0 == 1
    recombine = tf_change if tf_change > 0 else 0
    for k in range(recombine):
        haar1(lb, N >> k, 1 << k)
    B >>= recombine
    N_B <<= recombine
    tf = tf_change
    while (N_B & 1) == 0 and tf < 0:
        haar1(lb, N_B, B)
        B <<= 1
        N_B >>= 1
        tf += 1
    if B > 1:
        _deinterleave_hadamard(lb, N_B >> recombine, B << recombine,
                               long_blocks)


def _post_transforms(X: np.ndarray, N: int, B_entry: int,
                     tf_change: int) -> None:
    """Replay quant_band's resynthesis transform (interleave + haar)."""
    from .bands import _interleave_hadamard, haar1
    N_B = N // B_entry
    long_blocks = B_entry == 1
    recombine = tf_change if tf_change > 0 else 0
    B = B_entry >> recombine
    N_B <<= recombine
    time_divide = 0
    tf = tf_change
    while (N_B & 1) == 0 and tf < 0:
        B <<= 1
        N_B >>= 1
        time_divide += 1
        tf += 1
    B0 = B
    N_B0 = N_B
    if B0 > 1:
        _interleave_hadamard(X, N_B >> recombine, B0 << recombine, long_blocks)
    N_B = N_B0
    B = B0
    for _ in range(time_divide):
        B >>= 1
        N_B <<= 1
        haar1(X, N_B, B)
    for k in range(recombine):
        haar1(X, N >> k, 1 << k)


def execute_plan(plan: FramePlan, x_direct: np.ndarray | None = None
                 ) -> np.ndarray:
    """Reference (float64 NumPy) plan executor; returns the X plane."""
    C, N = plan.channels, plan.frame
    X = np.zeros(C * N, np.float64)
    if plan.direct:
        assert x_direct is not None
        X[:] = x_direct.reshape(-1)
        return X
    norm = np.zeros(plan.norm_len, np.float64)
    norm2 = np.zeros(plan.norm_len, np.float64) if C == 2 else norm
    bufs = {BUF_NORM: norm, BUF_NORM2: norm2}
    scratch = np.zeros(plan.frame, np.float64)
    bufs[BUF_SCRATCH] = scratch

    for kind, op in plan.ops:
        if kind == "call":
            c: Call = op
            if c.has_lowband:
                src = bufs[c.lb_buf]
                if c.used_scratch:
                    scratch[:c.n] = src[c.lb_src:c.lb_src + c.n]
                    _pre_transforms(scratch[:c.n], c.n, c.b0, c.tf_change)
                elif _pre_needed(c.n, c.b0, c.tf_change):
                    # no scratch (last band): the direct decoder transforms
                    # the norm buffer in place — match it
                    _pre_transforms(src[c.lb_src:c.lb_src + c.n], c.n, c.b0,
                                    c.tf_change)
            for lf in c.leaves:
                seg = X[lf.dst:lf.dst + lf.n]
                if lf.kind == PVQ:
                    iy = cwrsi(lf.n, lf.k, lf.idx)
                    alg_unquant_from_iy(seg, iy, lf.n, lf.k, lf.spread,
                                        lf.b, lf.gain)
                elif lf.kind == CONST:
                    seg[0] = lf.val
                elif lf.kind == NOISE:
                    seed = lf.seed
                    for j in range(lf.n):
                        seed = lcg_rand(seed)
                        signed = seed - (1 << 32) if seed & 0x80000000 else seed
                        seg[j] = float(signed >> 20)
                    renormalise_vector(seg, lf.n, lf.gain)
                else:  # FOLD
                    lb = bufs[lf.src_buf]
                    seed = lf.seed
                    for j in range(lf.n):
                        seed = lcg_rand(seed)
                        tmp = 1.0 / 256
                        v = lb[lf.src + j]
                        seg[j] = v + tmp if seed & 0x8000 else v - tmp
                    renormalise_vector(seg, lf.n, lf.gain)
            if not c.n1:
                _post_transforms(X[c.dst:c.dst + c.n], c.n, c.b0, c.tf_change)
            if c.norm_out >= 0:
                nb = bufs[c.norm_buf]
                if c.n1:
                    nb[c.norm_out] = X[c.dst]
                else:
                    nb[c.norm_out:c.norm_out + c.n] = (
                        math.sqrt(c.n) * X[c.dst:c.dst + c.n])
        elif kind == "merge":
            xo, yo, n, mid, inv = op
            from .bands import _stereo_merge
            _stereo_merge(X[xo:xo + n], X[yo:yo + n], mid, n)
            if inv:
                X[yo:yo + n] = -X[yo:yo + n]
        elif kind == "theta2":
            xo, yo, c_swap, sign, mid, side, inv = op
            Xv = X[xo:xo + 2]
            Yv = X[yo:yo + 2]
            x2, y2 = (Yv, Xv) if c_swap else (Xv, Yv)
            y2[0] = -sign * x2[1]
            y2[1] = sign * x2[0]
            Xv[0] *= mid
            Xv[1] *= mid
            Yv[0] *= side
            Yv[1] *= side
            tmp = Xv[0]
            Xv[0] = tmp - Yv[0]
            Yv[0] = tmp + Yv[0]
            tmp = Xv[1]
            Xv[1] = tmp - Yv[1]
            Yv[1] = tmp + Yv[1]
            if inv:
                Yv[:] = -Yv
        elif kind == "avg":
            upto = op
            norm[:upto] = 0.5 * (norm[:upto] + norm2[:upto])
        elif kind == "hybrid":
            n1, n2, dual = op
            norm[n1:n2] = norm[2 * n1 - n2:n1]
            if dual:
                norm2[n1:n2] = norm2[2 * n1 - n2:n1]
        else:
            raise AssertionError(kind)

    if plan.ac is not None:
        from .bands import anti_collapse
        from .modes import opus_custom_mode
        a = plan.ac
        anti_collapse(opus_custom_mode(48000, 960), X, a["masks"], plan.lm,
                      C, N, plan.start, plan.end, a["logE"], a["prev1"],
                      a["prev2"], a["pulses"], a["seed"])
    return X
