"""The PVQ leaf stage of the CELT band-plan executor (P1, P2 and the
pool -> X gather of band_exec.execute_packed) as CUDA kernels and their
plain PyTorch versions.

  leaf_stage  every leaf of the three tiers: CWRS index -> pulse vector
              (libopus cwrsi), iy normalised to the leaf's gain, the
              spreading rotation exp_rotation(dir = -1), and the values
              written into the X plane at the leaf's pvq_dst span; port of
              band_exec_jax.cwrs_walk (mousiki_tpu/ops/band_exec_jax.py:
              150), rotate_leaves (:280) with the normalisation before it
              (:425-430), and execute_packed's pool -> X gather
              (:432-456);
  cwrs_walk   the walk alone over one tier's leaves (the lockstep plan
              emission's).

The reference compiles these as XLA loops (a lax.scan over the walk's
steps, log-step doubling scans for the rotation's Givens chains) and a
gather map; here a CUDA plan always goes to the hand-written kernels of
csrc/pvq_leaves.cu (one launch of pvq_leaf_stage_kernel an executor call,
one of cwrs_walk_kernel a walk) and a CPU plan to the plain versions,
`leaf_stage_reference` (the walk, the values and the gather map in batched
torch ops, as every device ran them before) and `cwrs_walk_reference`.
There is no other route: the wrappers raise on a device that is neither,
on a dtype, a shape or a layout the kernels do not take, and when a kernel
cannot build or launch.

A leaf stands alone (no sum across leaves), so a stream's values do not
depend on the batch it shares. uint32 values are held in int64 tensors,
as everywhere in the executor; iy is int32.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import numpy as np
import torch
from torch.profiler import record_function

from ..celt.plan import TIERS
from . import _build
from ._tables import SPREAD_FACTOR, U_K, U_N, u_table

# kernel launches made by the wrappers (not by the plain versions)
cwrs_walk_launches = 0
leaf_stage_launches = 0
# the widest tier the kernels take: the U table's last row
NMAX_LIMIT = U_N - 1
# words of row offsets ahead of the packed table's entries (csrc kHeader:
# U_N + 1 offsets, padded to 16 bytes)
HEADER_WORDS = 212
# the executor's leaf planes (pvq_<name>, a tensor a tier) the stage reads
STAGE_PLANES = (("active", torch.bool), ("n", torch.int64),
                ("k", torch.int64), ("idx", torch.int64),
                ("gain", torch.float32), ("b", torch.int64),
                ("spread", torch.int64), ("dst", torch.int64))


def reset_launches() -> None:
    global cwrs_walk_launches, leaf_stage_launches
    cwrs_walk_launches = 0
    leaf_stage_launches = 0


# ------------------------------------------------------------------ consts

@lru_cache(maxsize=None)
def _u_table_t(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(u_table().astype(np.int64), device=device)


@lru_cache(maxsize=None)
def _u_table_u32(device: torch.device) -> torch.Tensor:
    """The saturated u32 table as the kernel reads it (int32 bits)."""
    return torch.as_tensor(u_table().view(np.int32), device=device)


@lru_cache(maxsize=None)
def _spread_factor_t(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(SPREAD_FACTOR, device=device)


@lru_cache(maxsize=None)
def packed_u_table():
    """The part of the U table a valid leaf's descent reads, packed row by
    row as libopus lays out CELT_PVQ_U_DATA. V(n, k) = U(n, k) +
    U(n, k + 1) < 2^32 caps k at kmax(n), which never grows with n, so
    the descent of a leaf (n, k <= kmax(n)) reads rows <= n at columns
    <= kmax(n) + 1. Returns (kmax (U_N,), off (U_N + 1,), entries): row
    r >= 1 holds columns 0 .. min(kmax(r) + 2, U_K) - 1 at entries[off[r]
    ..], row 0 none; kmax int64, off int64, entries uint32."""
    U = u_table()
    V = U[:, :-1].astype(np.int64) + U[:, 1:]
    fits = V < 1 << 32
    kmax = np.where(fits.all(axis=1), U_K - 2, fits.argmin(axis=1) - 1)
    if (np.diff(kmax[1:]) > 0).any():
        raise AssertionError("kmax(n) must not grow with n")
    cols = np.minimum(kmax + 2, U_K)
    cols[0] = 0
    off = np.concatenate([[0], np.cumsum(cols)]).astype(np.int64)
    entries = np.concatenate([U[r, :cols[r]] for r in range(U_N)])
    return kmax.astype(np.int64), off, entries.astype(np.uint32)


def packed_words(rows: int) -> int:
    """The words of the packed table that hold rows 0..rows: the header and
    their entries, rounded up to 16 bytes (the bulk copy's unit)."""
    _, off, _ = packed_u_table()
    return -(-(HEADER_WORDS + int(off[rows + 1])) // 4) * 4


@lru_cache(maxsize=None)
def _packed_u_t(device: torch.device) -> torch.Tensor:
    """The packed table as the kernels stage it: HEADER_WORDS words of row
    offsets (int32), then the entries (u32 bits), padded to 16 bytes."""
    _, off, entries = packed_u_table()
    head = np.zeros(HEADER_WORDS, np.int32)
    head[:len(off)] = off
    words = np.concatenate([head, entries.view(np.int32)])
    pad = np.zeros(packed_words(U_N - 1) - len(words), np.int32)
    return torch.as_tensor(np.concatenate([words, pad]), device=device)


# ------------------------------------------------------------------ P1 walk

# loop steps beyond nmax: windowed retry descents (pending) take extra
# steps that do not advance the position
_WALK_SLACK = 12

def cwrs_walk_reference(active, n, k0, idx, nmax: int):
    """The plain version of the walk kernel: cwrsi batched over leaves as
    a windowed search of the U table, nmax + _WALK_SLACK steps of torch
    ops. active bool, n/k0 int64, idx u32 in int64 -> iy (B, nmax)
    int32."""
    dev = n.device
    U = _u_table_t(dev)
    ar16 = torch.arange(16, device=dev)
    arn = torch.arange(nmax, device=dev)

    j = torch.zeros_like(n)
    k = k0.clone()
    kj = k0.clone()
    idxv = idx.clone()
    pending = torch.zeros_like(active)
    psign = torch.zeros_like(active)
    done = ~active
    iy = torch.zeros((n.shape[0], nmax), dtype=torch.int64, device=dev)
    for _ in range(nmax + _WALK_SLACK):
        m = n - j
        last = j >= n - 1
        work = active & ~done
        mm = torch.clamp(m, 0, U_N - 1)

        p1 = U[mm, torch.clamp(k + 1, 0, U_K - 1)]
        new_sign = idxv >= p1
        idx_sub = torch.where(work & ~last & ~pending & new_sign,
                              idxv - p1, idxv)
        sgn = torch.where(pending, psign, new_sign)

        lo = torch.clamp(k - 15, min=0)
        colidx = lo[:, None] + ar16[None, :]
        rows = U[mm[:, None], torch.clamp(colidx, 0, U_K - 1)]
        cand = (rows <= idx_sub[:, None]) & (colidx <= k[:, None])
        found = cand.any(dim=1)
        kidx = torch.where(cand, colidx, -1).amax(dim=1)
        pval = U[mm, torch.clamp(kidx, 0, U_K - 1)]
        q = kj - kidx
        yval = torch.where(sgn, -q, q)

        # k can only short-circuit the tail to zeros when it reached 0
        # through a resolution; during a windowed retry descent (pending)
        # k == 0 still needs resolving (q = kj pulses at j)
        resolve = work & ~last & ((k > 0) | pending) & found
        retry = work & ~last & (k > 0) & ~found
        fin_zero = work & ~last & (k == 0) & ~pending
        fin_last = work & last

        klast = torch.where(idxv != 0, -k, k)
        val = torch.where(fin_last, klast, yval)
        wpos = torch.where(fin_last, torch.clamp(n - 1, 0, nmax - 1),
                           torch.clamp(j, 0, nmax - 1))
        do_write = resolve | fin_last
        onehot = (arn[None, :] == wpos[:, None]) & do_write[:, None]
        iy = torch.where(onehot, val[:, None], iy)

        j = torch.where(resolve, j + 1, j)
        k_next = torch.where(resolve, kidx, torch.where(retry, lo - 1, k))
        kj = torch.where(resolve, kidx, kj)
        idxv = torch.where(resolve, idx_sub - pval, idx_sub)
        psign = torch.where(work & ~last, sgn, psign)
        pending = retry
        done = done | fin_last | fin_zero
        k = k_next
    return iy.to(torch.int32)


# ------------------------------------------------------------ P2 rotation

def _affine_scan(A, Bv):
    """x_t = A_t * x_{t-1} + B_t along axis 1 (x_{-1} irrelevant when
    A_0 = 0), by Hillis-Steele doubling."""
    Q = A.shape[1]
    pos = torch.arange(Q, device=A.device)[None, :]
    for level in range(max(1, (Q - 1).bit_length())):
        s = 1 << level
        valid = pos >= s
        Ash = torch.roll(A, s, dims=1)
        Bsh = torch.roll(Bv, s, dims=1)
        Bv = torch.where(valid, Bv + A * Bsh, Bv)
        A = torch.where(valid, A * Ash, A)
    return Bv


def _rot1_contig(x, valid, first, lastm, c, s):
    """One rot1 pass over chain-contiguous data.

    x: (B, Q) values; valid mask; first/last-in-chain masks; c, s (B, 1).
    Returns the transformed values (invalid positions pass through).
    """
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    b = torch.where(valid, x, zero)
    # forward: a_t = c*b_t + s*a_{t-1}, a_0 = b_0 per chain
    A = torch.where(first | ~valid, zero, s)
    Bv = torch.where(first, b, c * b)
    Bv = torch.where(valid, Bv, zero)
    a = _affine_scan(A, Bv)
    b_next = torch.roll(b, -1, dims=1)
    out_f = torch.where(lastm, a, c * a - s * b_next)
    y = torch.where(valid, out_f, x)
    # backward on flipped chains: d'_v = c*y'_v + (-s)*d'_{v-1}, start v=1
    yf = torch.flip(torch.where(valid, y, zero), dims=(1,))
    validf = torch.flip(valid, dims=(1,))
    firstf = torch.flip(lastm, dims=(1,))   # chain-last becomes flipped-first
    lastf = torch.flip(first, dims=(1,))
    # position-within-flipped-chain == 1 marker: previous is flipped-first
    prev_first = torch.roll(firstf, 1, dims=1)
    prev_first[:, 0] = False
    A2 = torch.where(firstf | prev_first | ~validf, zero, -s)
    B2 = torch.where(prev_first, yf, c * yf)
    B2 = torch.where(validf, B2, zero)
    d = _affine_scan(A2, B2)
    y_next = torch.roll(yf, -1, dims=1)
    out_b = c * d + s * y_next
    out_b = torch.where(firstf, yf, torch.where(lastf, d, out_b))
    yb = torch.flip(torch.where(validf, out_b, yf), dims=(1,))
    return torch.where(valid, yb, x)


def rotate_leaves(vals, active, n, k, b_blocks, spread, nmax: int):
    """exp_rotation(dir=-1) batched over leaves. vals (B, nmax)."""
    dev = vals.device
    fK = k.to(torch.float32)
    fn = n.to(torch.float32)
    factor = _spread_factor_t(dev)[torch.clamp(spread, 0, 3)]
    gain = fn / (fn + factor * fK)
    theta = 0.5 * gain * gain
    c = torch.cos(0.5 * math.pi * theta)[:, None]
    s = torch.cos(0.5 * math.pi * (1.0 - theta))[:, None]
    do_rot = active & (2 * k < n) & (spread != 0)

    stride = torch.clamp(b_blocks, min=1)
    seglen = n // stride
    # stride2 per reference vq.rs exp_rotation
    v = torch.arange(1, 15, device=dev)
    cond = ((v[None, :] * v[None, :] + v[None, :]) * stride[:, None]
            + (stride[:, None] >> 2)) < n[:, None]
    st2 = 1 + cond.sum(dim=1)
    st2 = torch.where(n >= 8 * stride, st2, 0)

    pos = torch.arange(nmax, device=dev)[None, :]
    sl = torch.clamp(seglen, min=1)
    seg = pos // sl[:, None]
    r = pos - seg * sl[:, None]
    in_range = pos < (stride * seglen)[:, None]

    out = vals
    # ---- pass A: stride2 chains (only when st2 > 0) ------------------
    # Chain-contiguous arrangement: each chain gets a fixed CLmax-slot
    # run; q decodes as (seg, chain, t) -> src = seg*seglen + chain +
    # t*st2. Q is padded so seg_count * st2 * CLmax always fits.
    Q = nmax + 128
    stA = torch.clamp(st2, min=1)
    clmax = (sl + stA - 1) // stA           # (B,)
    span = torch.clamp(stA * clmax, min=1)   # slots per segment
    clm = torch.clamp(clmax, min=1)
    qpos = torch.arange(Q, device=dev)[None, :]
    segq = qpos // span[:, None]
    remq = qpos - segq * span[:, None]
    chainq = remq // clm[:, None]
    tq = remq - chainq * clm[:, None]
    srcq = segq * sl[:, None] + chainq + tq * stA[:, None]
    validq = ((segq < stride[:, None])
              & (chainq + tq * stA[:, None] < sl[:, None]))
    xa = torch.gather(out, 1, torch.clamp(srcq, 0, nmax - 1))
    clenq = (sl[:, None] - chainq + stA[:, None] - 1) // stA[:, None]
    firstA = validq & (tq == 0)
    lastA = validq & (tq == clenq - 1)
    # rot1(seg, seglen, st2, s, c): coefficient args swapped
    ya = _rot1_contig(xa, validq, firstA, lastA, s, c)
    # gather back: position p -> q(p)
    qs = (seg * span[:, None] + (r % stA[:, None]) * clm[:, None]
          + r // stA[:, None])
    outA = torch.gather(ya, 1, torch.clamp(qs, 0, Q - 1))
    out = torch.where(do_rot[:, None] & (st2 > 0)[:, None] & in_range,
                      outA, out)
    # ---- pass B: stride-1 chains == segments (already contiguous) ----
    firstB = in_range & (r == 0)
    lastB = in_range & (r == sl[:, None] - 1)
    yb = _rot1_contig(out, in_range, firstB, lastB, c, s)
    return torch.where(do_rot[:, None] & in_range, yb, out)


def pvq_leaf_values_reference(iy, active, n, k, gain, b, spread, nmax: int):
    """The plain version of the values kernel: vals = iy * gain /
    sqrt(sum iy^2) (0 where iy is all zero), then `rotate_leaves`.
    iy (B, nmax) integer, gain float32 -> (B, nmax) float32."""
    f32 = torch.float32
    ryy = (iy * iy).to(f32).sum(dim=1)
    g = torch.where(ryy > 0, gain / torch.sqrt(ryy),
                    torch.zeros((), dtype=f32, device=iy.device))
    vals = iy.to(f32) * g[:, None]
    return rotate_leaves(vals, active, n, k, b, spread, nmax)




# ------------------------------------------------------------- the stage

def _stage_tiers(p: dict) -> tuple:
    """(nmax, slots) of each tier: nmax fixed, the slot count from the
    plane shapes (the host may run a shrunk serving profile)."""
    return tuple((TIERS[t][0], int(p["pvq_active"][t].shape[1]))
                 for t in range(len(TIERS)))


def leaf_stage_reference(p: dict, *, channels: int, frame: int,
                         pulses: bool = False):
    """The plain version of the stage kernel: for each tier the walk and
    the values of every slot (`cwrs_walk_reference`,
    `pvq_leaf_values_reference`) into a pool, then the pool -> X gather
    map built from the per-slot leaf offsets (pvq_dst), as execute_packed
    ran them. p: the executor's planes (band_exec._normalize_plan).
    Returns X (S, channels * frame) float64, and with `pulses` also each
    tier's iy (S * slots, nmax) int32."""
    dev = p["direct"].device
    S = p["direct"].shape[0]
    tiers = _stage_tiers(p)
    offs = [1]
    for nmax, slots in tiers:
        offs.append(offs[-1] + nmax * slots)
    f32 = torch.float32
    iys = []
    parts = [torch.zeros((S, 1), dtype=f32, device=dev)]
    for t, (nmax, slots) in enumerate(tiers):
        act, n, k, idx, gain, b, spread = (
            p[f"pvq_{key}"][t].reshape(-1).contiguous()
            for key in ("active", "n", "k", "idx", "gain", "b", "spread"))
        with record_function("plan.cwrs_walk"):
            iy = cwrs_walk_reference(act, n, k, idx, nmax)
        with record_function("plan.leaf_values"):
            vals = pvq_leaf_values_reference(iy, act, n, k, gain, b, spread,
                                             nmax)
        iys.append(iy)
        parts.append(vals.reshape(S, slots * nmax))
    pool = torch.cat(parts, dim=1).double()

    # ---- pool -> X gather map from the per-slot leaf offsets (pvq_dst):
    # spans are disjoint, so a difference-array cumsum gives
    # map[c] = base + (c - dst) inside each slot's [dst, dst+n) span and 0
    # (the pool's zero cell) elsewhere. Out-of-range points land in a pad
    # column that is sliced off (the reference drops them).
    with record_function("plan.gather_map"):
        Cf = channels * frame
        d1 = torch.zeros((S, Cf + 1), dtype=torch.int64, device=dev)
        d2 = torch.zeros((S, Cf + 1), dtype=torch.int64, device=dev)
        for t, (nmax, slots) in enumerate(tiers):
            base_t = offs[t] + torch.arange(slots, device=dev) * nmax
            act = p["pvq_active"][t].to(torch.int64)
            dst = p["pvq_dst"][t]
            on = act > 0
            lo = torch.where(on, dst, Cf).clamp(0, Cf)
            hi = torch.where(on, dst + p["pvq_n"][t], Cf).clamp(0, Cf)
            v = torch.where(on, base_t[None, :] - dst, 0)
            d1.scatter_add_(1, lo, act).scatter_add_(1, hi, -act)
            d2.scatter_add_(1, lo, v).scatter_add_(1, hi, -v)
        ind = torch.cumsum(d1[:, :Cf], dim=1)
        cs2 = torch.cumsum(d2[:, :Cf], dim=1)
        map_dev = ind * torch.arange(Cf, device=dev)[None, :] + cs2
        X = torch.gather(pool, 1, map_dev)                  # (S, C*frame)
    return (X, iys) if pulses else X


# ---------------------------------------------------------------- kernels

class _Plane(ctypes.Structure):
    """csrc/pvq_leaves.cu's Plane: a plane's data and its stream and slot
    strides in elements."""
    _fields_ = [("data", ctypes.c_void_p), ("stride", ctypes.c_int64),
                ("slot_stride", ctypes.c_int64)]


class _Tier(ctypes.Structure):
    _fields_ = ([(name, _Plane) for name, _ in STAGE_PLANES]
                + [("iy", ctypes.c_void_p), ("slots", ctypes.c_int),
                   ("nmax", ctypes.c_int), ("G", ctypes.c_int),
                   ("tasks", ctypes.c_int)])


class _Stage(ctypes.Structure):
    _fields_ = [("tier", _Tier * len(TIERS)), ("tiers", ctypes.c_int),
                ("S", ctypes.c_int), ("packed", ctypes.c_void_p),
                ("u", ctypes.c_void_p), ("X", ctypes.c_void_p),
                ("cols", ctypes.c_int64), ("packed_words", ctypes.c_int),
                ("row_words", ctypes.c_int)]


def _kernels():
    lib = _build.load("pvq_leaves")
    stage, walk = lib.mousiki_pvq_leaf_stage, lib.mousiki_cwrs_walk
    if walk.argtypes is None:
        stage.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        stage.restype = ctypes.c_int
        walk.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                         + [ctypes.c_void_p] * 2
                         + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        walk.restype = ctypes.c_int
    return stage, walk


def build_kernel() -> None:
    """Compile and load the kernels now (they are otherwise built on first
    launch)."""
    _kernels()


def _check(name: str, planes: dict, nmax: int):
    """Dtype, shape, device and layout checks; returns the device."""
    if not 1 <= nmax <= NMAX_LIMIT:
        raise ValueError(f"{name} takes nmax in [1, {NMAX_LIMIT}], "
                         f"got {nmax}")
    dev = None
    leaves = None
    for key, (t, dtype, ndim) in planes.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} must be {dtype}, got {t.dtype}")
        if t.dim() != ndim or (ndim == 2 and t.shape[1] != nmax):
            raise ValueError(f"{name}: bad shape of {key}: "
                             f"{tuple(t.shape)} (nmax {nmax})")
        if leaves is None:
            leaves, dev = t.shape[0], t.device
        if t.shape[0] != leaves or t.device != dev:
            raise ValueError(f"{name}: {key} has {t.shape[0]} leaves on "
                             f"{t.device}, not {leaves} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous planes ({key})")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    return dev


def _launch(name: str, fn, dev, *args) -> None:
    """fn(*args, stream) on `dev`'s current stream, with `dev` current
    (a launch onto another device's stream fails); raises on a nonzero
    cudaError."""
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cuda error {rc}")


def cwrs_walk(active, n, k0, idx, nmax: int):
    """CWRS index -> PVQ pulse vector for every leaf of one tier.

    active (B,) bool; n, k0, idx (B,) int64 (idx a u32 value). Returns iy
    (B, nmax) int32: libopus's cwrsi(n, k0, idx) in positions 0..n-1,
    zero past n and for inactive leaves. CPU tensors take
    `cwrs_walk_reference`; CUDA tensors launch cwrs_walk_kernel once
    (nmax a multiple of 4)."""
    dev = _check("cwrs_walk", {"active": (active, torch.bool, 1),
                               "n": (n, torch.int64, 1),
                               "k": (k0, torch.int64, 1),
                               "idx": (idx, torch.int64, 1)}, nmax)
    if dev.type == "cpu":
        return cwrs_walk_reference(active, n, k0, idx, nmax)
    if nmax % 4:
        raise ValueError(f"the cwrs_walk kernel takes nmax a multiple of 4 "
                         f"(its rows move 16 bytes a lane), got {nmax}")
    iy = torch.empty((n.shape[0], nmax), dtype=torch.int32, device=dev)
    if n.shape[0] == 0:
        return iy
    _, walk = _kernels()
    _launch("cwrs_walk", walk, dev, active.data_ptr(), n.data_ptr(),
            k0.data_ptr(), idx.data_ptr(), _packed_u_t(dev).data_ptr(),
            packed_words(nmax), _u_table_u32(dev).data_ptr(), iy.data_ptr(),
            iy.shape[0], nmax)
    global cwrs_walk_launches
    cwrs_walk_launches += 1
    return iy


def _check_stage(p: dict, channels: int, frame: int):
    """Dtype, shape and device checks of both routes; returns (device,
    S)."""
    if channels not in (1, 2) or frame < 1:
        raise ValueError(f"leaf_stage takes channels 1 or 2 and a frame of "
                         f"at least 1, got {channels}, {frame}")
    dev, S = p["direct"].device, p["direct"].shape[0]
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"leaf_stage runs on cpu or cuda, not {dev}")
    for name, dtype in STAGE_PLANES:
        key = f"pvq_{name}"
        if len(p[key]) != len(TIERS):
            raise ValueError(f"leaf_stage: {key} holds {len(p[key])} tiers, "
                             f"not {len(TIERS)}")
        for t, plane in enumerate(p[key]):
            if plane.dtype != dtype:
                raise TypeError(f"leaf_stage: {key} must be {dtype}, got "
                                f"{plane.dtype}")
            want = (S, p["pvq_active"][t].shape[-1])
            if plane.dim() != 2 or tuple(plane.shape) != want:
                raise ValueError(f"leaf_stage: bad shape of {key} tier {t}: "
                                 f"{tuple(plane.shape)}, not {want}")
            if plane.device != dev:
                raise ValueError(f"leaf_stage: {key} is on {plane.device}, "
                                 f"the plan on {dev}")
    return dev, S


def leaf_stage(p: dict, *, channels: int, frame: int, pulses: bool = False):
    """The X plane of S packed band plans before their band assembly: each
    active leaf's n values (its walk, normalisation and rotation) at
    columns pvq_dst .. pvq_dst + n - 1 of its stream's row, those inside
    [0, channels * frame); 0.0 elsewhere.

    p: the executor's planes (band_exec._normalize_plan; the pvq_ planes
    of STAGE_PLANES are read, a (S, slots) tensor a tier). Returns X (S,
    channels * frame) float64, and with `pulses` also each tier's pulse
    vectors iy (S * slots, nmax) int32. CPU planes take
    `leaf_stage_reference`; CUDA planes launch pvq_leaf_stage_kernel once
    (X zeroed by one torch.zeros before it)."""
    dev, S = _check_stage(p, channels, frame)
    if dev.type == "cpu":
        return leaf_stage_reference(p, channels=channels, frame=frame,
                                    pulses=pulses)
    tiers = _stage_tiers(p)
    X = torch.zeros((S, channels * frame), dtype=torch.float64, device=dev)
    iys = [torch.zeros((S * slots, nmax), dtype=torch.int32, device=dev)
           for nmax, slots in tiers] if pulses else None
    if S == 0:
        return (X, iys) if pulses else X
    stage = _Stage(tiers=len(tiers), S=S,
                   packed=_packed_u_t(dev).data_ptr(),
                   u=_u_table_u32(dev).data_ptr(), X=X.data_ptr(),
                   cols=X.shape[1],
                   packed_words=packed_words(max(t[0] for t in tiers)))
    # the widest tier first: its longest chains start first
    for i, t in enumerate(reversed(range(len(tiers)))):
        tier = stage.tier[i]
        for name, _ in STAGE_PLANES:
            plane = p[f"pvq_{name}"][t]
            setattr(tier, name, _Plane(plane.data_ptr(), *plane.stride()))
        tier.iy = iys[t].data_ptr() if pulses else None
        tier.nmax, tier.slots = tiers[t]
    fn, _ = _kernels()
    _launch("pvq_leaf_stage", fn, dev, ctypes.addressof(stage))
    global leaf_stage_launches
    leaf_stage_launches += 1
    return (X, iys) if pulses else X
