"""Batched CELT band-plan executor in PyTorch: port of
mousiki_tpu/ops/band_exec_jax.py.

For S streams at once, everything `bands.quant_all_bands` (decode side)
does to the signal after the symbols are known:

  P1  CWRS index -> pulse vector walk (cwrs.rs cwrsi), a Python loop over
      coefficient positions with a windowed search of the saturated u32
      U(n,k) table.
  P2  PVQ spreading rotation (vq.rs exp_rotation): each Givens-chain pass
      is a first-order affine recurrence, solved by log-step doubling.
  P3  Band assembly in band order (a Python loop over the 21 bands):
      gather from the leaf pool, fold/noise fills (counter-form LCG),
      per-stream pre/post transform operators, norm-buffer upkeep, stereo
      merge and the N == 2 butterfly.
  P4  anti_collapse (bands.rs:3220) with host-computed r and device LCG.

uint32 arithmetic runs in int64 holding values in [0, 2^32): torch has
almost no uint32 ops. Everything else is float32.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
from torch.profiler import record_function

from .. import _device
from ..celt import host_native
from ..celt.modes import MODE
from ..celt.plan import TIERS
from ._tables import (LCG_MAX, SPREAD_FACTOR, U_K, U_N, lcg_jump,
                      plan_combo_mats_np, u_table)

_M32 = 0xFFFFFFFF


# ------------------------------------------------------------------ consts

@lru_cache(maxsize=None)
def _u_table_t(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(u_table().astype(np.int64), device=device)


@lru_cache(maxsize=None)
def _lcg_t(device: torch.device):
    A, Cc = lcg_jump()
    return (torch.as_tensor(A.astype(np.int64), device=device),
            torch.as_tensor(Cc.astype(np.int64), device=device))


@lru_cache(maxsize=None)
def _spread_factor_t(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(SPREAD_FACTOR, device=device)


def plan_combo_mats(channels: int, frame: int, device):
    """Stacked per-band pre/post combo operators, identity-padded to
    NBMAX: (21, NC, NBMAX, NBMAX) float32 each, on `device`."""
    dev = _device.as_device(device)
    pre_all, post_all = plan_combo_mats_np(frame)
    return (torch.as_tensor(pre_all, device=dev),
            torch.as_tensor(post_all, device=dev))


def _lcg(A_J, C_J, d, seed):
    """lcg^d(seed) mod 2^32 for u32 `seed` (int64 tensors). The 32x32-bit
    product is split on seed's 16-bit halves so no product reaches 2^48."""
    a = A_J[d]
    lo = seed & 0xFFFF
    hi = seed >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16) + C_J[d]) & _M32


def _as_i32(u):
    """Signed reinterpretation of u32 values held in int64."""
    return u - ((u >> 31) << 32)


# ------------------------------------------------------------------ P1 walk

# loop steps beyond nmax: windowed retry descents (pending) take extra
# steps that do not advance the position
_WALK_SLACK = 12

def cwrs_walk(active, n, k0, idx, nmax: int):
    """Batched cwrsi walk. active bool, n/k0 int64, idx u32 in int64 ->
    iy (B, nmax) int64."""
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
    return iy


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


# ------------------------------------------------------ P3/P4: full executor

_BOOL_PLANES = ("direct", "pvq_active", "call_active", "call_has_lb",
                "call_norm_write", "fill_active", "fill_fold",
                "merge_active", "merge_inv", "theta2_active", "theta2_cswap",
                "theta2_inv", "n1_active", "ac_on")
_U32_PLANES = ("pvq_idx", "fill_seed", "ac_seed")
_F32_PLANES = ("pvq_gain", "fill_gain", "merge_mid", "theta2_sign",
               "theta2_mid", "theta2_side", "n1_val", "ac_r")

# Keys of the packed-plan dict consumed by execute_packed.
PLAN_KEYS = (
    "direct", "pvq_active", "pvq_n", "pvq_k", "pvq_b", "pvq_spread",
    "pvq_gain", "pvq_idx", "pvq_dst", "call_active", "call_has_lb",
    "call_lb_src", "call_lb_buf", "call_blend_upto", "call_pre", "call_post",
    "call_norm_write", "call_norm_buf", "fill_active", "fill_fold",
    "fill_off", "fill_n", "fill_gain", "fill_seed", "merge_active",
    "merge_mid", "merge_inv", "theta2_active", "theta2_cswap", "theta2_sign",
    "theta2_mid", "theta2_side", "theta2_inv", "n1_active", "n1_val",
    "ac_on", "ac_masks", "ac_r", "ac_seed", "call_dup")


def _normalize_plan(p: dict) -> dict:
    """Cast plan planes to the executor's dtypes: bool for flags, float32,
    int64 for integers and for u32 values (masked to 32 bits). `~` on an
    integer plane would be a bitwise not, so flags become bool first."""
    def cast(key, v):
        v = torch.as_tensor(v)
        if key in _BOOL_PLANES:
            return v if v.dtype == torch.bool else v != 0
        if key in _U32_PLANES:
            return v.to(torch.int64) & _M32
        if key in _F32_PLANES:
            return v.to(torch.float32)
        return v.to(torch.int64)
    return {k: ([cast(k, t) for t in p[k]] if isinstance(p[k], list)
                else cast(k, p[k])) for k in PLAN_KEYS}


@lru_cache(maxsize=None)
def _p4_consts(lm: int, start: int, end: int, device: torch.device):
    """Static index maps of the anti-collapse pass."""
    eb = [int(v) for v in MODE.ebands]
    nb = MODE.num_ebands
    M = 1 << lm
    nbins = M * eb[end]
    band_of = np.full(nbins, -1, np.int64)
    basep = np.zeros(nbins, np.int64)
    for i in range(start, end):
        band_of[M * eb[i]:M * eb[i + 1]] = i
        basep[M * eb[i]:M * eb[i + 1]] = M * eb[i]
    qpos = np.arange(nbins)
    valid = band_of >= 0
    n0 = np.array([eb[i + 1] - eb[i] for i in range(nb)], np.int64)
    ind = np.zeros((nbins, nb), np.float32)
    ind[qpos[valid], band_of[valid]] = 1.0
    in_rng = np.zeros(nb, np.int64)
    in_rng[start:end] = 1

    def t(a):
        return torch.as_tensor(a, device=device)

    return {"nbins": nbins, "bmap": t(np.where(valid, band_of, 0)),
            "kmap": t((qpos - basep) & (M - 1)),
            "jmap": t((qpos - basep) >> lm),
            "vmask": t(valid), "n0": t(n0), "ind": t(ind), "in_rng": t(in_rng)}


def execute_packed(p: dict, x_direct, mats, *, channels: int, frame: int,
                   lm: int, start: int, end: int):
    """Run S packed band plans; returns the X plane (S, channels*frame) f32.

    x_direct: (S, channels, frame) fallback spectra for direct streams.
    mats: (pre, post) from plan_combo_mats(channels, frame)
    """
    p = _normalize_plan(p)
    dev = p["direct"].device
    eb = [int(v) for v in MODE.ebands]
    nb = MODE.num_ebands
    M = 1 << lm
    norm_offset = M * eb[start]
    norm_len = M * eb[nb - 1] - norm_offset
    npad = norm_len + 192
    S = p["direct"].shape[0]
    # tier slot counts come from the plane shapes (the host may run a
    # shrunk serving profile); nmax per tier is fixed
    tiers = tuple((TIERS[t][0], int(p["pvq_active"][t].shape[1]))
                  for t in range(3))
    offs = [1]
    for nmax, slots in tiers:
        offs.append(offs[-1] + nmax * slots)
    A_J, C_J = _lcg_t(dev)
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)

    # ---- P1 + P2: PVQ leaves per tier -> pool ------------------------
    with record_function("plan.leaves"):
        parts = [torch.zeros((S, 1), dtype=f32, device=dev)]
        for t, (nmax, slots) in enumerate(tiers):
            act = p["pvq_active"][t].reshape(-1)
            n = p["pvq_n"][t].reshape(-1)
            k = p["pvq_k"][t].reshape(-1)
            with record_function("plan.cwrs_walk"):
                iy = cwrs_walk(act, n, k, p["pvq_idx"][t].reshape(-1), nmax)
            ryy = (iy * iy).to(f32).sum(dim=1)
            g = torch.where(ryy > 0, p["pvq_gain"][t].reshape(-1)
                            / torch.sqrt(ryy), zero)
            vals = iy.to(f32) * g[:, None]
            with record_function("plan.rotate_leaves"):
                vals = rotate_leaves(vals, act, n, k,
                                     p["pvq_b"][t].reshape(-1),
                                     p["pvq_spread"][t].reshape(-1), nmax)
            parts.append(vals.reshape(S, slots * nmax))
        pool = torch.cat(parts, dim=1)

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

    # ---- P3: band assembly, in band order (fold lowbands read bands
    # decoded before them) --------------------------------------------
    with record_function("plan.bands"):
        pre_stack, post_stack = mats
        NBMAX = 22 * M
        norm = torch.zeros((S, npad), dtype=f32, device=dev)
        norm2 = torch.zeros((S, npad), dtype=f32, device=dev)
        posb = torch.arange(NBMAX, device=dev)
        rows = torch.arange(S, device=dev)

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
                seeds = _lcg(A_J, C_J, dc, p["fill_seed"][:, i, slot, :, None])
                plus = (seeds & 0x8000) != 0
                fold_v = torch.where(plus, scr[:, None, :] + 1.0 / 256,
                                     scr[:, None, :] - 1.0 / 256)
                noise_v = (_as_i32(seeds) >> 20).to(f32)
                vals = torch.where(p["fill_fold"][:, i, slot, :, None],
                                   fold_v, noise_v)
                vals = torch.where(inw, vals, zero)
                E = 1e-15 + (vals * vals).sum(dim=2)
                g = p["fill_gain"][:, i, slot, :] / torch.sqrt(E)
                live = fa[:, :, None] & inw
                contrib = torch.where(live, vals * g[:, :, None], zero)
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
                x0v = torch.where(valid, x0, zero)
                x1v = torch.where(valid, x1, zero)
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

    # ---- P4: anti-collapse (whole plane at once) -----------------------
    # The per-(band, channel) LCG draw counts are known up front, so every
    # position's seed comes from one closed-form jump (A_J/C_J); band
    # energies for the renormalise come from one indicator product.
    with record_function("plan.anti_collapse"):
        q = _p4_consts(lm, start, end, dev)
        nbins, bmap, kmap = q["nbins"], q["bmap"], q["kmap"]
        vmask = q["vmask"]
        ac_on = p["ac_on"]
        kk = torch.arange(M, device=dev)
        cl = ((~p["ac_masks"][:, :, :, None]) >> kk[None, None, None, :]) & 1
        cl = cl * q["in_rng"][None, :, None, None]          # (S, nb, 2, M)
        prefc = torch.cumsum(cl, dim=3) - cl                # cleared below k
        cnt = cl.sum(dim=3) * q["n0"][None, :, None]
        cntC = cnt[:, :, :channels].reshape(S, -1)          # i-major, c-minor
        cum_prior = (torch.cumsum(cntC, dim=1) - cntC).reshape(S, nb, channels)
        n0q = q["n0"][bmap]
        for c in range(channels):
            prefq = prefc[:, bmap, c, kmap]                      # (S, nbins)
            clrq = cl[:, bmap, c, kmap] == 1
            ddraw = prefq * n0q[None, :] + q["jmap"][None, :] + 1
            dd = torch.clamp(cum_prior[:, :, c][:, bmap] + ddraw, 0,
                             LCG_MAX - 1)
            seeds = _lcg(A_J, C_J, dd, p["ac_seed"][:, None])
            rq = p["ac_r"][:, c, :][:, bmap]
            val = torch.where((seeds & 0x8000) != 0, rq, -rq)
            xplane = X[:, c * frame:c * frame + nbins]
            inject = clrq & ac_on[:, None] & vmask[None, :]
            x2 = torch.where(inject, val, xplane)
            Eb = 1e-15 + torch.matmul(x2 * x2, q["ind"])
            gb = 1.0 / torch.sqrt(Eb)
            anyb = (cnt[:, :, c] > 0) & ac_on[:, None]           # (S, nb)
            gq = torch.where(anyb[:, bmap] & vmask[None, :], gb[:, bmap],
                             torch.ones((), dtype=f32, device=dev))
            X[:, c * frame:c * frame + nbins] = x2 * gq

    return torch.where(p["direct"][:, None], x_direct.reshape(S, -1), X)


# ------------------------------------------------------- arenas -> planes

def split_backing(backing, *, channels: int, frame: int, n_streams: int):
    """The a32 | a16 | a8 arenas inside ONE int32 backing buffer
    (host_native.alloc_plan_arenas), as same-width views."""
    n32, o16, n16, o8, n8, _ = host_native.arena_word_layout(
        n_streams, channels, frame)
    a32 = backing[:n32]
    a16 = backing[o16:o16 + (n16 + 1) // 2].view(torch.int16)[:n16]
    a8 = backing[o8:o8 + (n8 + 3) // 4].view(torch.uint8)[:n8]
    return a32, a16, a8


def unpack_plan_arenas(a32, a16, a8, *, channels: int, frame: int):
    """Reconstruct the LOGICAL plan-plane dict from the three packed arenas
    (wire format v4; the JAX package's numpy twin is
    mousiki_tpu/celt/host_native.wire_to_logical).

    f32 planes are same-width bitcasts of the int32 arena; u32 values are
    returned in int64. Sequential 12-byte PVQ leaf records are scattered
    into the tier planes here; scatter targets the reference drops (out
    of range) go to a pad slot that is sliced off. Returns
    (p, ble (S, 2, 21) f32, pf_gain (S,) f32, iflags (S, 4) int32)."""
    arenas = {"a8": a8, "a16": a16, "a32": a32}
    dev = a32.device
    # every arena plane scales linearly with S: recover S from a8's length
    _, sizes1 = host_native.plan_arena_layout(1, channels, frame)
    S = a8.shape[0] // sizes1["a8"]
    layout, _ = host_native.plan_arena_layout(S, channels, frame)
    tiers = host_native._TIERS
    FILL, POOL = host_native._FILL, host_native._POOL

    def plane(key):
        name, off, shape = layout[key]
        dt = np.dtype(host_native._PLANE_DTYPES[key])
        v = arenas[name][off:off + math.prod(shape)]
        if dt == np.float32:
            v = v.view(torch.float32)
        elif dt in (np.uint32, np.uint16):
            # unsigned values stored in signed arena words
            v = v.to(torch.int64) & ((1 << (8 * dt.itemsize)) - 1)
        else:
            v = v.to(torch.int64)
        return v.reshape(shape)

    p = {"direct": plane("direct")}
    for key in ("pvq_active", "pvq_n", "pvq_k", "pvq_b", "pvq_spread",
                "pvq_gain", "pvq_idx", "pvq_dst"):
        p[key] = []
    # sequential leaf records -> tier planes; the slot within a tier is a
    # running count of same-tier records (the host's emission order)
    rec = plane("pvq_rec")                          # (S, R, 3) u32
    cnt = plane("pvq_cnt")                          # (S,)
    spread_s = plane("spread8")                     # (S,) frame-wide
    R = rec.shape[1]
    w0r = rec[..., 0]
    validr = torch.arange(R, device=dev)[None, :] < cnt[:, None]
    tierr = torch.where(validr, (w0r >> 19) & 3, -1)
    rows = torch.arange(S, device=dev)[:, None]
    for t, (_, slots) in enumerate(tiers):
        sel = tierr == t
        pos = torch.cumsum(sel.to(torch.int64), dim=1) - 1
        j = torch.where(sel & (pos < slots), pos, slots)
        rt = torch.zeros((S, slots + 1, 3), dtype=torch.int64, device=dev)
        rt[rows, j] = rec
        rt = rt[:, :slots]
        w0 = rt[..., 0]
        k = (w0 >> 8) & 0xFF
        act = (k > 0).to(torch.int64)               # scatter hit == active
        p["pvq_active"].append(act)
        p["pvq_n"].append(w0 & 0xFF)
        p["pvq_k"].append(k)
        p["pvq_b"].append(torch.where(act == 1, 1 << ((w0 >> 16) & 7), 0))
        p["pvq_spread"].append(spread_s[:, None] * act)
        p["pvq_gain"].append(rt[..., 1].to(torch.int32).view(torch.float32))
        p["pvq_idx"].append(rt[..., 2])
        p["pvq_dst"].append((w0 >> 21) & 0x7FF)

    cf = plane("call_flags")
    p["call_active"] = cf & 1
    p["call_has_lb"] = (cf >> 1) & 1
    p["call_lb_buf"] = (cf >> 2) & 1
    p["call_norm_write"] = (cf >> 3) & 1
    p["call_norm_buf"] = (cf >> 4) & 1
    combo = plane("call_combo")
    p["call_pre"] = combo
    p["call_post"] = combo
    p["call_lb_src"] = plane("call_lb_src")
    p["call_blend_upto"] = plane("call_blend_upto")

    # dup pool -> dense (S, 21, 2, 3); invalid entries go to the pad row
    dp = plane("dup_pool")                           # (S, _DUP, 4)
    cid = dp[:, :, 0]
    didx = torch.where((dp[:, :, 3] > 0) & (cid >= 0) & (cid < 42), cid, 42)
    dup = torch.zeros((S, 43, 3), dtype=torch.int64, device=dev)
    dup[rows, didx] = dp[:, :, 1:4]
    p["call_dup"] = dup[:, :42].reshape(S, 21, 2, 3)

    # fill pool -> dense (S, 21, 2, F): scatter by call id with an
    # occurrence index among same-call entries (pool order == call order)
    cid8 = plane("fill_cid")                          # (S, POOL)
    fact = cid8 & 1
    fcid = cid8 >> 2
    tri = torch.tril(torch.ones((POOL, POOL), dtype=torch.bool, device=dev),
                     -1)
    eq = (fcid[:, :, None] == fcid[:, None, :]) & (fact[:, None, :] == 1)
    occ = (eq & tri[None]).sum(dim=2)                 # (S, POOL)
    fidx = fcid * FILL + torch.clamp(occ, max=FILL - 1)
    fidx = torch.where((fact == 1) & (fidx < 42 * FILL), fidx, 42 * FILL)
    f4 = (S, 21, 2, FILL)

    def scat(v):
        out = torch.zeros((S, 42 * FILL + 1), dtype=v.dtype, device=dev)
        out[rows, fidx] = v
        return out[:, :42 * FILL].reshape(f4)

    p["fill_active"] = scat(fact)
    p["fill_fold"] = scat((cid8 >> 1) & 1)
    p["fill_off"] = scat(plane("fill_off"))
    p["fill_n"] = scat(plane("fill_n"))
    p["fill_gain"] = scat(plane("fill_gain"))
    p["fill_seed"] = scat(plane("fill_seed"))

    bf = plane("bm_flags")
    mid = plane("bm_mid")
    one = torch.ones((), dtype=torch.float32, device=dev)
    p["merge_active"] = bf & 1
    p["merge_inv"] = (bf >> 1) & 1
    p["merge_mid"] = mid
    p["theta2_active"] = (bf >> 2) & 1
    p["theta2_cswap"] = (bf >> 3) & 1
    p["theta2_inv"] = (bf >> 4) & 1
    p["theta2_sign"] = torch.where(((bf >> 5) & 1) != 0, -one, one)
    p["theta2_mid"] = mid
    p["theta2_side"] = plane("bm_side")

    n1 = plane("n1_as")
    p["n1_active"] = n1 & 1
    p["n1_val"] = torch.where(((n1 >> 1) & 1) != 0, -one, one)

    for key in ("ac_on", "ac_masks", "ac_r", "ac_seed", "lost8"):
        p[key] = plane(key)
    return (p, plane("ble32"), plane("pf32"),
            plane("iflags").to(torch.int32))


# ---------------------------------------------------------- fused step

def plan_plc_core(consts, plc_consts, state, plc_state, a32, a16, a8,
                  x_direct, mats, *, any_lost: bool, channels: int = 2,
                  frame: int = 960):
    """Arena-level decode step: unpack + band plans + PLC + synthesis.

    The lost mask is the arena's lost8 plane; `any_lost` is the host's
    copy of lost8.any(), so the PLC gate costs no device-to-host sync.
    Lost streams ignore their (stale) plan rows and take the PLC re-entry
    spectrum; their postfilter params coast at the current state values.
    Returns (pcm (S, frame, C), new StreamState, new PlcState)."""
    from .plc import PlcState, celt_plc_freq
    from .synthesis import COMB_MIN, FrameDesc, synthesis_step

    lm = {120: 0, 240: 1, 480: 2, 960: 3}[frame]
    with record_function("plan.unpack"):
        p, ble, pf_gain, iflags = unpack_plan_arenas(a32, a16, a8,
                                                     channels=channels,
                                                     frame=frame)
    with record_function("plan.execute_packed"):
        X = execute_packed(p, x_direct, mats, channels=channels, frame=frame,
                           lm=lm, start=0, end=21)
    ble_pad = torch.nn.functional.pad(ble[:, :channels, :], (0, 1),
                                      value=-28.0)
    transient = iflags[:, 0] != 0
    silence = iflags[:, 1] != 0
    pf_pitch = iflags[:, 2]
    pf_tapset = iflags[:, 3]
    if any_lost:
        lost = p["lost8"] != 0
        with record_function("plan.plc"):
            freq_plc, new_plc = celt_plc_freq(plc_consts, state, plc_state,
                                              lost, channels=channels,
                                              frame=frame)
        transient = transient & ~lost
        silence = silence & ~lost
        pf_pitch = torch.where(
            lost, torch.clamp(state.pf_period, min=COMB_MIN), pf_pitch)
        pf_gain = torch.where(lost, state.pf_gain, pf_gain)
        pf_tapset = torch.where(lost, state.pf_tapset, pf_tapset)
    else:
        lost = freq_plc = None
        new_plc = PlcState(loss_count=torch.zeros_like(plc_state.loss_count),
                           plc_pitch=plc_state.plc_pitch, lpc=plc_state.lpc)
    desc = FrameDesc(x=X.reshape(-1, channels, frame), band_log_e=ble_pad,
                     transient=transient, silence=silence, pf_pitch=pf_pitch,
                     pf_gain=pf_gain, pf_tapset=pf_tapset)
    with record_function("plan.synthesis"):
        pcm, new_state = synthesis_step(consts, state, desc, n=frame,
                                        lost=lost, freq_plc=freq_plc)
    return pcm, new_state, new_plc


def plan_synthesis_step_plc(consts, plc_consts, state, plc_state, backing,
                            x_direct, mats, *, any_lost: bool,
                            channels: int = 2, frame: int = 960,
                            n_streams: int):
    """plan_plc_core over ONE int32 backing buffer holding all three
    arenas (one host-to-device copy per step)."""
    a32, a16, a8 = split_backing(backing, channels=channels, frame=frame,
                                 n_streams=n_streams)
    return plan_plc_core(consts, plc_consts, state, plc_state, a32, a16, a8,
                         x_direct, mats, any_lost=any_lost,
                         channels=channels, frame=frame)


def plan_synthesis_scan(consts, plc_consts, state, plc_state, backings,
                        x_directs, mats, *, any_lost, channels: int = 2,
                        frame: int = 960, n_streams: int):
    """plan_synthesis_step_plc over K stacked frames.

    backings: (K, total_words) int32, K packed plan arenas; x_directs:
    (K, S, C, frame) direct-fallback spectra, or one (S, C, frame) tensor
    shared by every frame (the all-zero one when no stream fell back);
    any_lost: K bools, the host's copy of each frame's lost8.any().

    The reference scans with lax.scan inside one program; in eager
    PyTorch this is a loop over K that threads `state` and `plc_state`
    through the same step, so its output equals K single steps exactly.
    Returns ((K, S, frame, channels) pcm, state, plc_state).
    """
    K = backings.shape[0]
    if len(any_lost) != K:
        raise ValueError(f"{len(any_lost)} loss flags for {K} frames")
    pcms = []
    for k in range(K):
        xd = x_directs if x_directs.dim() == 3 else x_directs[k]
        pcm, state, plc_state = plan_synthesis_step_plc(
            consts, plc_consts, state, plc_state, backings[k], xd, mats,
            any_lost=any_lost[k], channels=channels, frame=frame,
            n_streams=n_streams)
        pcms.append(pcm)
    return torch.stack(pcms), state, plc_state
