"""The band assembly of the CELT band-plan executor (P3 of
band_exec.execute_packed) as a CUDA kernel and its plain PyTorch version.

For each band in order and each channel slot: the fold source gathered
from the norm buffers (the special-hybrid-folding duplicate, the lowband
blend), the pre operator, the fold / noise fills (counter-form LCG), the
post operator, the n_b = 1 sign path, the norm-buffer writes, the N = 2
stereo butterfly and the stereo merge; each band written into the X
plane. Port of the P3 band_body scan of band_exec_jax.execute_packed
(mousiki_tpu/ops/band_exec_jax.py:514, scan :643).

The reference compiles the 21 bands as one lax.scan; here a CUDA tensor
always goes to the hand-written kernel of csrc/band_assembly.cu (one
thread block a stream, one launch a call; the bands that no live fold
fill ties to an earlier one run at once, the rest in band order: see
`band_passes`), and a CPU tensor to the plain version, `band_assembly_reference`, the Python loop over the bands that
ran on every device before. There is no other route: `band_assembly`
raises on a device that is neither, on a dtype or a shape the kernel does
not take, and when the kernel cannot build or launch.

The X plane is float64 and updated in place; the operators hold the
reference's float32 values (_device.py), in the layout that
band_exec.plan_combo_mats gives for the device: dense stacks for the
plain version, their nonzeros (`packed_operators`) for the kernel. uint32
values are held in int64 tensors, as everywhere in the executor.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .. import _device
from ..celt.modes import MODE
from ..celt.plan import combos_for_m
from . import _build
from ._tables import (LCG_MAX, as_i32, lcg_at, lcg_tensors,
                      plan_combo_mats_np)

N_BANDS = 21
# fill slots a call the kernel takes: the lockstep plan emission's 8
# (ops/celt_lockstep_emit.FILL_SLOTS_LS; the host's profiles give at most 4)
MAX_FILL = 8
# (column, value) pairs a packed operator row: the most nonzeros a row of
# any combo block holds, at every LM (asserted where they are packed)
NZ = 8

# kernel launches made by `band_assembly` (not by the plain version)
band_assembly_launches = 0


def reset_launches() -> None:
    global band_assembly_launches
    band_assembly_launches = 0


# --------------------------------------------------------------- geometry

def _ebands():
    return [int(v) for v in MODE.ebands]


def norm_geometry(lm: int, start: int):
    """(norm_offset, norm_len, npad) of the norm buffers of a call."""
    eb = _ebands()
    M = 1 << lm
    norm_offset = M * eb[start]
    norm_len = M * eb[N_BANDS - 1] - norm_offset
    return norm_offset, norm_len, norm_len + 192


def _band_widths(lm: int):
    eb = _ebands()
    M = 1 << lm
    return [M * (eb[i + 1] - eb[i]) for i in range(N_BANDS)]


def _row_offsets(lm: int):
    """The first packed row of each band's combo 0, and the rows in all:
    NC x n_b rows a band with n_b > 1 (combo c's row m at offset + c n_b +
    m)."""
    nc = len(combos_for_m(1 << lm))
    offs, total = [], 0
    for n_b in _band_widths(lm):
        offs.append(total)
        if n_b > 1:
            total += nc * n_b
    return offs, total


# ------------------------------------------------------- plain version

def band_assembly_reference(p: dict, X, mats, *, channels: int, frame: int,
                            lm: int, start: int, end: int):
    """The plain version of the kernel: the bands start..end-1 in order,
    as batched torch ops. p: the executor's plan planes
    (band_exec._normalize_plan); X (S, channels*frame) float64, updated in
    place and returned; mats: (pre, post), the (21, NC, NBMAX, NBMAX)
    float64 stacks of band_exec.plan_combo_mats on the CPU."""
    dev = X.device
    eb = _ebands()
    M = 1 << lm
    norm_offset, norm_len, npad = norm_geometry(lm, start)
    S = X.shape[0]
    A_J, C_J = lcg_tensors(dev)
    pre_stack, post_stack = mats
    NBMAX = 22 * M
    f64 = torch.float64
    norm = torch.zeros((S, npad), dtype=f64, device=dev)
    norm2 = torch.zeros((S, npad), dtype=f64, device=dev)
    zero64 = torch.zeros((), dtype=f64, device=dev)
    posb = torch.arange(NBMAX, device=dev)

    for i in range(start, end):
        n_b = M * (eb[i + 1] - eb[i])
        boff = M * eb[i]
        nwoff = boff - norm_offset
        nw_ok = nwoff >= 0 and nwoff + n_b <= norm_len
        nwoff = min(max(nwoff, 0), max(0, npad - NBMAX))
        scale = float(np.float32(math.sqrt(n_b))) if n_b > 1 else 1.0
        valid = (posb < n_b)[None, :]
        bx = []
        for slot in range(channels):
            x0 = slot * frame + boff
            cur = X[:, x0:x0 + NBMAX]
            if n_b == 1:
                # the n1 sign path replaces the whole band
                n1 = (p["n1_active"][:, i, slot][:, None]
                      & (posb == 0)[None])
                bx.append(torch.where(
                    n1, p["n1_val"][:, i, slot][:, None], cur))
                continue
            act = p["call_active"][:, i, slot]
            gidx = p["call_lb_src"][:, i, slot][:, None] + posb[None, :]
            gc = torch.clamp(gidx, 0, npad - 1)
            nv = torch.gather(norm, 1, gc)
            n2v = torch.gather(norm2, 1, gc)
            # special_hybrid_folding (bands.rs): window-local duplicate of
            # the first band's folding data before the gather is consumed
            dup = p["call_dup"][:, i, slot]
            d_rel = posb[None, :] - dup[:, 0:1]
            in_dup = (d_rel >= 0) & (d_rel < dup[:, 2:3])
            sidx = torch.clamp(dup[:, 1:2] + d_rel, 0, n_b - 1)
            nv = torch.where(in_dup, torch.gather(nv, 1, sidx), nv)
            n2v = torch.where(in_dup, torch.gather(n2v, 1, sidx), n2v)
            blend = gidx < p["call_blend_upto"][:, i, slot][:, None]
            lbuf2 = (p["call_lb_buf"][:, i, slot] == 1)[:, None]
            base = torch.where(lbuf2, n2v, nv)
            scr = torch.where(blend, 0.5 * (nv + n2v), base)
            pre_m = pre_stack[i][p["call_pre"][:, i, slot]]  # (S, N, N)
            scr = torch.bmm(pre_m, scr[:, :, None])[..., 0]
            # fold/noise fills: all fill slots at once (windows disjoint)
            fa = p["fill_active"][:, i, slot, :] & act[:, None]
            d = posb[None, None, :] - p["fill_off"][:, i, slot, :, None]
            inw = (d >= 0) & (d < p["fill_n"][:, i, slot, :, None])
            dc = torch.clamp(d + 1, 0, LCG_MAX - 1)
            seeds = lcg_at(A_J, C_J, dc, p["fill_seed"][:, i, slot, :, None])
            plus = (seeds & 0x8000) != 0
            fold_v = torch.where(plus, scr[:, None, :] + 1.0 / 256,
                                 scr[:, None, :] - 1.0 / 256)
            noise_v = (as_i32(seeds) >> 20).to(f64)
            vals = torch.where(p["fill_fold"][:, i, slot, :, None],
                               fold_v, noise_v)
            vals = torch.where(inw, vals, zero64)
            E = 1e-15 + (vals * vals).sum(dim=2)
            g = p["fill_gain"][:, i, slot, :] / torch.sqrt(E)
            live = fa[:, :, None] & inw
            contrib = torch.where(live, vals * g[:, :, None], zero64)
            covered = live.any(dim=1)
            sl = torch.where(covered, contrib.sum(dim=1), cur)
            post_m = post_stack[i][p["call_post"][:, i, slot]]
            bx.append(torch.bmm(post_m, sl[:, :, None])[..., 0])
        # norm writes (pre-merge, as in quant_band)
        if nw_ok:
            for slot in range(channels):
                nw = (p["call_norm_write"][:, i, slot]
                      & p["call_active"][:, i, slot])
                tobuf2 = p["call_norm_buf"][:, i, slot] == 1
                val = scale * bx[slot]
                win = slice(nwoff, nwoff + NBMAX)
                norm[:, win] = torch.where((nw & ~tobuf2)[:, None] & valid,
                                           val, norm[:, win])
                norm2[:, win] = torch.where((nw & tobuf2)[:, None] & valid,
                                            val, norm2[:, win])
        if channels == 2 and n_b == 2:
            # N == 2 stereo butterfly
            ta = p["theta2_active"][:, i]
            sgn = p["theta2_sign"][:, i]
            cs = p["theta2_cswap"][:, i]
            x0, x1 = bx
            der0 = torch.stack([-sgn * x1[:, 1], sgn * x1[:, 0]], dim=1)
            der1 = torch.stack([-sgn * x0[:, 1], sgn * x0[:, 0]], dim=1)
            nx = torch.where(cs[:, None], der0, x0[:, :2])
            ny = torch.where(cs[:, None], x1[:, :2], der1)
            nx = nx * p["theta2_mid"][:, i][:, None]
            ny = ny * p["theta2_side"][:, i][:, None]
            ox = nx - ny
            oy = nx + ny
            oy = torch.where(p["theta2_inv"][:, i][:, None], -oy, oy)
            ox_f = torch.cat([ox, x0[:, 2:]], dim=1)
            oy_f = torch.cat([oy, x1[:, 2:]], dim=1)
            bx = [torch.where(ta[:, None], ox_f, x0),
                  torch.where(ta[:, None], oy_f, x1)]
        if channels == 2 and n_b > 2:
            # stereo merge
            ma = p["merge_active"][:, i]
            mmid = p["merge_mid"][:, i]
            x0, x1 = bx
            x0v = torch.where(valid, x0, zero64)
            x1v = torch.where(valid, x1, zero64)
            xp = (x0v * x1v).sum(dim=1) * mmid
            sd = (x1v * x1v).sum(dim=1)
            el = mmid * mmid + sd - 2 * xp
            er = mmid * mmid + sd + 2 * xp
            degen = (er < 6e-4) | (el < 6e-4)
            lg = 1.0 / torch.sqrt(torch.clamp(el, min=1e-20))
            rg = 1.0 / torch.sqrt(torch.clamp(er, min=1e-20))
            lpart = mmid[:, None] * x0
            mx = lg[:, None] * (lpart - x1)
            my = rg[:, None] * (lpart + x1)
            mx = torch.where(degen[:, None], x0, mx)
            my = torch.where(degen[:, None], x0, my)
            inv = p["merge_inv"][:, i]
            my = torch.where(inv[:, None], -my, my)
            x1k = torch.where(inv[:, None], -x1, x1)
            bx = [torch.where(ma[:, None], mx, x0),
                  torch.where(ma[:, None], my, x1k)]
        for slot in range(channels):
            x0 = slot * frame + boff
            X[:, x0:x0 + NBMAX] = torch.where(valid, bx[slot],
                                              X[:, x0:x0 + NBMAX])
    return X


# ---------------------------------------------------------------- kernel

# the planes the kernel reads, in the order of csrc/band_assembly.cu's
# BandPlanes: (key, dtype, trailing shape after (S, 21); "F" = fill slots)
PLANES = (
    ("call_active", torch.bool, (2,)),
    ("call_norm_write", torch.bool, (2,)),
    ("call_lb_src", torch.int64, (2,)),
    ("call_lb_buf", torch.int64, (2,)),
    ("call_blend_upto", torch.int64, (2,)),
    ("call_pre", torch.int64, (2,)),
    ("call_post", torch.int64, (2,)),
    ("call_norm_buf", torch.int64, (2,)),
    ("call_dup", torch.int64, (2, 3)),
    ("fill_active", torch.bool, (2, "F")),
    ("fill_fold", torch.bool, (2, "F")),
    ("fill_off", torch.int64, (2, "F")),
    ("fill_n", torch.int64, (2, "F")),
    ("fill_gain", torch.float32, (2, "F")),
    ("fill_seed", torch.int64, (2, "F")),
    ("merge_active", torch.bool, ()),
    ("merge_inv", torch.bool, ()),
    ("merge_mid", torch.float32, ()),
    ("theta2_active", torch.bool, ()),
    ("theta2_cswap", torch.bool, ()),
    ("theta2_inv", torch.bool, ()),
    ("theta2_sign", torch.float32, ()),
    ("theta2_mid", torch.float32, ()),
    ("theta2_side", torch.float32, ()),
    ("n1_active", torch.bool, (2,)),
    ("n1_val", torch.float32, (2,)),
)
PLANE_KEYS = tuple(key for key, _, _ in PLANES)


class _Plane(ctypes.Structure):
    """csrc/band_assembly.cu's Plane: a plane's data and its stream
    stride in elements."""
    _fields_ = [("data", ctypes.c_void_p), ("stride", ctypes.c_int64)]


class _BandPlanes(ctypes.Structure):
    _fields_ = [(key, _Plane) for key in PLANE_KEYS]


class _BandTable(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int * N_BANDS),
                ("boff", ctypes.c_int * N_BANDS),
                ("nwoff", ctypes.c_int * N_BANDS),
                ("row_off", ctypes.c_int * N_BANDS),
                ("scale", ctypes.c_double * N_BANDS)]


@lru_cache(maxsize=None)
def _band_table(lm: int, start: int) -> _BandTable:
    """The kernel's per-band constants, as the plain version derives
    them: width, offset, norm write offset (-1 where it writes none),
    first packed operator row and the norm write's scale."""
    norm_offset, norm_len, _ = norm_geometry(lm, start)
    M = 1 << lm
    eb = _ebands()
    widths = _band_widths(lm)
    offs, _ = _row_offsets(lm)
    t = _BandTable()
    for i, n_b in enumerate(widths):
        nwoff = M * eb[i] - norm_offset
        t.n[i] = n_b
        t.boff[i] = M * eb[i]
        t.nwoff[i] = nwoff if nwoff >= 0 and nwoff + n_b <= norm_len else -1
        t.row_off[i] = offs[i]
        t.scale[i] = float(np.float32(math.sqrt(n_b))) if n_b > 1 else 1.0
    return t


class SparseOperators(NamedTuple):
    """One operator stack (pre or post) as the kernel reads it: each row
    of every band's combo blocks as NZ (column, value) pairs, columns in
    ascending order, padded with (0, 0.0)."""
    cols: torch.Tensor     # (rows, NZ) uint8
    vals: torch.Tensor     # (rows, NZ) float32, the reference's values


def _sparse_rows(block: np.ndarray):
    """The rows of a (rows, n_b) block as (columns, values), NZ a row."""
    nz = block != 0
    k = int(nz.sum(axis=1).max())
    assert k <= NZ, f"an operator row holds {k} nonzeros, the kernel {NZ}"
    rows, n_b = block.shape
    order = np.argsort(~nz, axis=1, kind="stable")[:, :NZ]
    keep = np.take_along_axis(nz, order, axis=1)
    cols = np.zeros((rows, NZ), np.uint8)
    vals = np.zeros((rows, NZ), np.float32)
    w = order.shape[1]
    cols[:, :w] = np.where(keep, order, 0)
    vals[:, :w] = np.where(keep, np.take_along_axis(block, order, axis=1), 0)
    return cols, vals


@lru_cache(maxsize=None)
def _packed_np(frame: int):
    """(pre, post) of plan_combo_mats_np(frame) packed for the kernel:
    for each band with n_b > 1, its NC blocks' rows in turn, each row's
    nonzeros as (columns, values) (`_sparse_rows`)."""
    lm = {120: 0, 240: 1, 480: 2, 960: 3}[frame]
    out = []
    for stack in plan_combo_mats_np(frame):
        parts = [_sparse_rows(stack[i, :, :n_b, :n_b].reshape(-1, n_b))
                 for i, n_b in enumerate(_band_widths(lm)) if n_b > 1]
        out.append(tuple(np.concatenate(a) for a in zip(*parts)))
    assert out[0][0].shape == (_row_offsets(lm)[1], NZ)
    return tuple(out)


def packed_operators(frame: int, device):
    """The pre and post combo operators as the kernel reads them: two
    SparseOperators (the reference's float32 values) on `device`."""
    dev = _device.as_device(device)
    return tuple(SparseOperators(*(torch.as_tensor(a, device=dev)
                                   for a in pair))
                 for pair in _packed_np(frame))


def band_passes(p: dict, *, channels: int, lm: int, start: int, end: int):
    """The kernel's schedule of each stream's bands, in numpy (the kernel
    works it out itself; tests and reports read this): (S, 21) int8, 0
    outside start..end-1, 2 the ordered pass, 1 the parallel pass. A band
    is ordered when a call of it has a live fold fill (fill_active &
    fill_fold & call_active, n_b > 1), or when it writes the norm buffers
    (norm_write & call_active where the band has a norm region) inside
    the source window [lb_src, lb_src + n_b - 1] (clamped to the
    buffers) of a live fold call of an earlier band."""
    q = {k: p[k].cpu().numpy() for k in
         ("call_active", "call_norm_write", "call_lb_src", "fill_active",
          "fill_fold")}
    _, _, npad = norm_geometry(lm, start)
    t = _band_table(lm, start)
    n = np.array(t.n)
    nwoff = np.array(t.nwoff)
    C = channels
    act = q["call_active"][:, :, :C]
    live = ((q["fill_active"] & q["fill_fold"]).any(axis=3)[:, :, :C]
            & act & (n > 1)[None, :, None])
    src = q["call_lb_src"][:, :, :C]
    fold = live.any(axis=2)
    rlo = np.where(live, np.clip(src, 0, npad - 1), npad).min(axis=2)
    rhi = np.where(live, np.clip(src + n[None, :, None] - 1, 0, npad - 1),
                   -1).max(axis=2)
    writes = (nwoff >= 0)[None] & (q["call_norm_write"][:, :, :C]
                                   & act).any(axis=2)
    wlo, whi = nwoff, nwoff + n - 1
    earlier = np.tril(np.ones((N_BANDS, N_BANDS), bool), -1)  # [k, j]: j < k
    hits = (fold[:, None, :] & earlier[None]
            & (rlo[:, None, :] <= whi[None, :, None])
            & (rhi[:, None, :] >= wlo[None, :, None])).any(axis=2)
    ordered = fold | (writes & hits)
    run = np.zeros(N_BANDS, bool)
    run[start:end] = True
    return np.where(run[None], 1 + ordered, 0).astype(np.int8)


def _kernel():
    lib = _build.load("band_assembly")
    fn = lib.mousiki_band_assembly
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def build_kernel() -> None:
    """Compile and load the kernel now (it is otherwise built on first
    launch)."""
    _kernel()


def _check(p: dict, X, channels: int, frame: int, lm: int, start: int,
           end: int):
    """Dtype, shape and device checks of both routes; returns the
    device."""
    if channels not in (1, 2) or lm not in range(4) or frame != 120 << lm:
        raise ValueError(f"band_assembly takes channels 1 or 2 and frame "
                         f"120 << lm, got {channels}, {frame}, lm {lm}")
    if not 0 <= start < end <= N_BANDS:
        raise ValueError(f"band_assembly: bad band range {start}..{end}")
    if X.dtype != torch.float64:
        raise TypeError(f"band_assembly: X must be torch.float64, got "
                        f"{X.dtype}")
    if X.dim() != 2 or X.shape[1] != channels * frame:
        raise ValueError(f"band_assembly: bad shape of X: {tuple(X.shape)} "
                         f"(channels {channels}, frame {frame})")
    dev, S = X.device, X.shape[0]
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"band_assembly runs on cpu or cuda, not {dev}")
    F = p["fill_active"].shape[-1] if p["fill_active"].dim() == 4 else 0
    for key, dtype, tail in PLANES:
        t = p[key]
        want = (S, N_BANDS) + tuple(F if d == "F" else d for d in tail)
        if t.dtype != dtype:
            raise TypeError(f"band_assembly: {key} must be {dtype}, got "
                            f"{t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"band_assembly: bad shape of {key}: "
                             f"{tuple(t.shape)}, not {want}")
        if t.device != dev:
            raise ValueError(f"band_assembly: {key} is on {t.device}, X on "
                             f"{dev}")
    return dev


def _check_kernel(p: dict, X, mats, frame: int, lm: int) -> int:
    """What the kernel takes beyond _check: 1 to MAX_FILL fill slots a
    call, a contiguous X, each plane's rows contiguous (streams any
    stride apart), the packed operators on X's device. Returns F."""
    F = p["fill_active"].shape[-1]
    if not 1 <= F <= MAX_FILL:
        raise ValueError(f"band_assembly takes 1 to {MAX_FILL} fill slots a "
                         f"call, got {F}")
    if not X.is_contiguous():
        raise ValueError("band_assembly needs a contiguous X")
    for key in PLANE_KEYS:
        if X.shape[0] and not p[key][0].is_contiguous():
            raise ValueError(f"band_assembly needs contiguous rows of each "
                             f"plane ({key})")
    rows = _row_offsets(lm)[1]
    for op in mats:
        ok = (isinstance(op, SparseOperators)
              and all(isinstance(a, torch.Tensor) and a.is_contiguous()
                      and tuple(a.shape) == (rows, NZ)
                      and a.device == X.device and a.data_ptr() % 16 == 0
                      for a in op)
              and op.cols.dtype == torch.uint8
              and op.vals.dtype == torch.float32)
        if not ok:
            raise ValueError(
                f"band_assembly on {X.device} takes the packed operators "
                f"(packed_operators({frame})): SparseOperators of ({rows}, "
                f"{NZ}) uint8 columns and float32 values on {X.device}")
    return F


def band_assembly(p: dict, X, mats, *, channels: int, frame: int, lm: int,
                  start: int, end: int):
    """Assemble the bands start..end-1 of S plans into the X plane.

    p: the executor's plan planes (band_exec._normalize_plan; the keys
    of PLANES are read); X (S, channels*frame) float64, holding the
    gathered leaves, updated in place and returned; mats: the operators
    of band_exec.plan_combo_mats on X's device. CPU tensors take
    `band_assembly_reference`; CUDA tensors launch the kernel once."""
    dev = _check(p, X, channels, frame, lm, start, end)
    if dev.type == "cpu":
        return band_assembly_reference(p, X, mats, channels=channels,
                                       frame=frame, lm=lm, start=start,
                                       end=end)
    F = _check_kernel(p, X, mats, frame, lm)
    S = X.shape[0]
    if S == 0:
        return X
    planes = _BandPlanes(*(_Plane(p[k].data_ptr(), p[k].stride(0))
                           for k in PLANE_KEYS))
    pre, post = mats
    _, _, npad = norm_geometry(lm, start)
    fn = _kernel()
    with torch.cuda.device(dev):
        rc = fn(ctypes.addressof(planes),
                ctypes.addressof(_band_table(lm, start)), X.data_ptr(),
                pre.cols.data_ptr(), pre.vals.data_ptr(),
                post.cols.data_ptr(), post.vals.data_ptr(),
                len(combos_for_m(1 << lm)), S, channels, frame, npad,
                22 << lm, start, end, F,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"band_assembly kernel launch failed: cuda "
                           f"error {rc}")
    global band_assembly_launches
    band_assembly_launches += 1
    return X
