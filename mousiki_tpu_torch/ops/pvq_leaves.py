"""The PVQ leaf stage of the CELT band-plan executor (P1 and P2 of
band_exec.execute_packed) as two CUDA kernels and their plain PyTorch
versions.

  cwrs_walk        CWRS index -> pulse vector iy, one leaf at a time
                   (libopus cwrsi); port of band_exec_jax.cwrs_walk
                   (mousiki_tpu/ops/band_exec_jax.py:150);
  pvq_leaf_values  iy normalised to the leaf's gain, then the spreading
                   rotation exp_rotation(dir = -1); port of the three
                   lines before band_exec_jax.rotate_leaves in its
                   execute_packed and of rotate_leaves itself (:280).

The reference compiles both as XLA loops (a lax.scan over the walk's
steps, log-step doubling scans for the rotation's Givens chains); here a
CUDA tensor always goes to the hand-written kernels of
csrc/pvq_leaves.cu, a group of lanes a leaf, and a CPU tensor to the plain
versions, `cwrs_walk_reference` and `pvq_leaf_values_reference`, the
batched torch ops that ran on every device before. There is no other
route: the wrappers raise on a device that is neither, on a dtype or a
shape the kernels do not take, and when a kernel cannot build or launch.

A leaf stands alone in both (no sum across leaves), so a stream's values
do not depend on the batch it shares. uint32 values are held in int64
tensors, as everywhere in the executor; iy is int32.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import numpy as np
import torch

from . import _build
from ._tables import SPREAD_FACTOR, U_K, U_N, u_table

# kernel launches made by the wrappers (not by the plain versions)
cwrs_walk_launches = 0
pvq_leaf_values_launches = 0
# the widest tier the kernels take: the U table's last row
NMAX_LIMIT = U_N - 1


def reset_launches() -> None:
    global cwrs_walk_launches, pvq_leaf_values_launches
    cwrs_walk_launches = 0
    pvq_leaf_values_launches = 0


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


# ---------------------------------------------------------------- kernels

def _kernels():
    lib = _build.load("pvq_leaves")
    walk, values = lib.mousiki_cwrs_walk, lib.mousiki_pvq_leaf_values
    if walk.argtypes is None:
        walk.argtypes = ([ctypes.c_void_p] * 6
                         + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        walk.restype = ctypes.c_int
        values.argtypes = ([ctypes.c_void_p] * 8
                           + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        values.restype = ctypes.c_int
    return walk, values


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
    `cwrs_walk_reference`; CUDA tensors launch the kernel once."""
    dev = _check("cwrs_walk", {"active": (active, torch.bool, 1),
                               "n": (n, torch.int64, 1),
                               "k": (k0, torch.int64, 1),
                               "idx": (idx, torch.int64, 1)}, nmax)
    if dev.type == "cpu":
        return cwrs_walk_reference(active, n, k0, idx, nmax)
    iy = torch.empty((n.shape[0], nmax), dtype=torch.int32, device=dev)
    if n.shape[0] == 0:
        return iy
    walk, _ = _kernels()
    _launch("cwrs_walk", walk, dev, active.data_ptr(), n.data_ptr(),
            k0.data_ptr(), idx.data_ptr(), _u_table_u32(dev).data_ptr(),
            iy.data_ptr(), iy.shape[0], nmax)
    global cwrs_walk_launches
    cwrs_walk_launches += 1
    return iy


def pvq_leaf_values(iy, active, n, k, gain, b, spread, nmax: int):
    """The leaves' values: iy * gain / sqrt(sum iy^2), then
    exp_rotation(dir = -1) with the leaf's k, b blocks and spread.

    iy (B, nmax) int32 from `cwrs_walk`; active (B,) bool; n, k, b,
    spread (B,) int64; gain (B,) float32. Returns (B, nmax) float32, zero
    past n. CPU tensors take `pvq_leaf_values_reference`; CUDA tensors
    launch the kernel once."""
    dev = _check("pvq_leaf_values", {
        "iy": (iy, torch.int32, 2), "active": (active, torch.bool, 1),
        "n": (n, torch.int64, 1), "k": (k, torch.int64, 1),
        "gain": (gain, torch.float32, 1), "b": (b, torch.int64, 1),
        "spread": (spread, torch.int64, 1)}, nmax)
    if dev.type == "cpu":
        return pvq_leaf_values_reference(iy, active, n, k, gain, b, spread,
                                         nmax)
    out = torch.empty((iy.shape[0], nmax), dtype=torch.float32, device=dev)
    if iy.shape[0] == 0:
        return out
    _, values = _kernels()
    _launch("pvq_leaf_values", values, dev, iy.data_ptr(), active.data_ptr(),
            n.data_ptr(), k.data_ptr(), gain.data_ptr(), b.data_ptr(),
            spread.data_ptr(), out.data_ptr(), out.shape[0], nmax)
    global pvq_leaf_values_launches
    pvq_leaf_values_launches += 1
    return out
