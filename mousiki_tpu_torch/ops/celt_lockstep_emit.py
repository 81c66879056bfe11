"""Lockstep CELT decode, pass 2, in PyTorch: port of
mousiki_tpu/ops/celt_lockstep_emit.py. Resolves the signal-plan planes
from the walk's emissions.

The walk (celt_lockstep_walk) consumes the symbol stream and emits node
records (splits with theta, PVQ leaves with CWRS indices, fill leaves with
visit ranks). This pass resolves everything that depends on decoded pulse
data rather than symbols: collapse masks (reference bands.rs
extract_collapse_mask / the cm folds in quant_band), fold-vs-noise-vs-zero
fill typing, the LCG seed chain, the anti-collapse inputs. It assembles
the packed plan-plane dict consumed by `band_exec.execute_packed`.

Every scatter here writes each real (lane, slot) at most once (a node is
visited once a frame, a PVQ leaf has one rank in its tier, a fill leaf
one visit rank); the records of iterations that emit nothing all go to a
dummy column that is sliced off, so the order in which duplicates land
there does not matter (tests/test_torch_celt_lockstep.py checks both).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..celt.plan import TIERS, combos_for_m
from ..hostcodec.celt.modes import BITRES
from ._tables import lcg_at, lcg_jump
from .band_exec import cwrs_walk
from .celt_lockstep import _tables
from .celt_lockstep_walk import NPB, _bitexact_cos, walk_layout

_BIT_INTERLEAVE = np.array([0, 1, 1, 1, 2, 3, 3, 3, 2, 3, 3, 3, 2, 3, 3, 3],
                           np.int32)
_BIT_DEINTERLEAVE = np.array(
    [0x00, 0x03, 0x0C, 0x0F, 0x30, 0x33, 0x3C, 0x3F,
     0xC0, 0xC3, 0xCC, 0xCF, 0xF0, 0xF3, 0xFC, 0xFF], np.int32)

FILL_SLOTS_LS = 8
SPREAD_AGGRESSIVE = 3
RMAX = 640           # fill visit ranks the seed chain resolves
_I64 = torch.int64


@lru_cache(maxsize=8)
def _tier_map(lm: int, C: int):
    """Static map of VALID node slots -> tiers; returns per-tier index
    arrays (into the (C*nslot,) padded slot axis) + static n/dst."""
    lay = walk_layout(lm)
    tb = _tables(lm, C)
    M = 1 << lm
    frame = 120 << lm
    eb = tb.ebands
    idxs = [[], [], []]
    ns = [[], [], []]
    dst = [[], [], []]
    for ch in range(C):
        for band in range(21):
            for nid in range(1, int(lay.nnodes[band]) + 1):
                sl = band * NPB + nid - 1
                n = int(lay.s_n[sl])
                if n < 2:
                    continue
                t = 0 if n <= TIERS[0][0] else (1 if n <= TIERS[1][0]
                                                else 2)
                idxs[t].append(ch * lay.nslot + sl)
                ns[t].append(n)
                dst[t].append(ch * frame + M * int(eb[band])
                              + int(lay.s_off[sl]))
    return ([np.asarray(a, np.int32) for a in idxs],
            [np.asarray(a, np.int32) for a in ns],
            [np.asarray(a, np.int32) for a in dst])


@lru_cache(maxsize=8)
def _combo_lut(lm: int):
    """(2, 7) combo-id lookup: [b0 == M][tf+3] per plan.combos_for_m."""
    combos = combos_for_m(1 << lm)
    cid = {bt: i for i, bt in enumerate(combos)}
    out = np.zeros((2, 7), np.int32)
    for row, b0 in enumerate((1, 1 << lm)):
        for tf in range(-3, 4):
            out[row, tf + 3] = cid.get((b0, tf), 0)
    return out


@lru_cache(maxsize=8)
def _emit_consts(lm: int, C: int, device: torch.device) -> dict:
    lay = walk_layout(lm)
    tb = _tables(lm, C)
    M = 1 << lm

    def t(a):
        return torch.as_tensor(np.asarray(a).astype(np.int64), device=device)

    tier_idx, tier_n, tier_dst = _tier_map(lm, C)
    sdep_all = np.concatenate([lay.s_depth] * C)
    sband_all = np.concatenate([lay.s_band] * C)
    n0 = (tb.ebands[1:] - tb.ebands[:-1]).astype(np.int64)
    A, Cc = lcg_jump()
    return {
        "nbands": t(tb.nbands), "edges": t(M * tb.ebands),
        "arj": torch.arange(21, device=device),
        "ar8": torch.arange(8, device=device),
        "inter": t(_BIT_INTERLEAVE), "deinter": t(_BIT_DEINTERLEAVE),
        "tier_idx": [t(a) for a in tier_idx],
        "tier_n": [t(a) for a in tier_n], "tier_dst": [t(a) for a in tier_dst],
        "tier_dep": [t(sdep_all[a]) for a in tier_idx],
        "tier_band": [t(sband_all[a]) for a in tier_idx],
        "s_n_all": t(np.concatenate([lay.s_n] * C)),
        "offs4": t(lay.s_off.reshape(21, NPB)),
        "ns4": t(lay.s_n.reshape(21, NPB)),
        "combo": t(_combo_lut(lm)), "n0": t(n0),
        "sqrt_1": torch.as_tensor((1.0 / np.sqrt((n0 << lm).astype(
            np.float64))).astype(np.float32), device=device),
        "lcg": (t(A), t(Cc)),
    }


def _scatter_nodes(emits, S, C_nslot):
    """Scatter walk emission records into (S, C_nslot) node planes."""
    cc = torch.where(emits.slot >= 0, emits.slot, C_nslot).T   # (S, T)

    def put(fill, val, dtype):
        buf = torch.full((S, C_nslot + 1), fill, dtype=dtype,
                         device=cc.device)
        return buf.scatter_(1, cc, val.T.to(dtype))[:, :C_nslot]

    return (put(False, emits.split, torch.bool),
            put(False, (emits.slot >= 0) & ~emits.split, torch.bool),
            put(0, emits.itheta, _I64), put(0, emits.k, _I64),
            put(0, emits.idx, _I64), put(0.0, emits.gain, torch.float32),
            put(-1, emits.rank, _I64))


def _scatter_bands(emits, S):
    cc = torch.where(emits.band >= 0, emits.band, 21).T

    def put(fill, val, dtype):
        buf = torch.full((S, 22), fill, dtype=dtype, device=cc.device)
        return buf.scatter_(1, cc, val.T.to(dtype))[:, :21]

    return (put(0, emits.b_band, _I64), put(-1, emits.btheta, _I64),
            put(False, emits.binv, torch.bool))


def _collapse_from_iy(iy, n, b_leaf, nmax, ar8):
    """extract_collapse_mask (vq.rs): bit j set iff any pulse in block j.

    iy (R, nmax); n, b_leaf (R,) (b_leaf in 1/2/4/8)."""
    pos = torch.arange(nmax, device=iy.device)[None, :]
    n0 = n // b_leaf.clamp(min=1)
    blk = (pos // n0.clamp(min=1)[:, None]).clamp(0, 7)
    nz = (iy != 0) & (pos < n[:, None])
    hit = (nz[:, None, :] & (blk[:, None, :] == ar8[None, :, None])).any(dim=2)
    bits = (hit.to(_I64) << ar8[None, :]).sum(dim=1)
    return torch.where(b_leaf > 1, bits, nz.any(dim=1).to(_I64))


def _tree_resolve(spl, lef, it, kk, cmp_, tree_fill, has_lb, Bp_i, td_i,
                  rc_i, transient, M, k):
    """Resolve one band's tree for all lanes: fill words down, collapse
    masks up (bands.rs quant_partition fill/cm flow). All args (S, NPB)
    or (S,); returns (band_cm, fill_nonzero (S,NPB), fill_fold)."""
    inter, deinter = k["inter"], k["deinter"]
    one = torch.ones_like(Bp_i)
    # pre-transforms of the fill word (quant_band entry)
    f = tree_fill
    Bw = torch.where(transient, M, 1)
    for r in range(3):
        go = rc_i > r
        f = torch.where(go, inter[f & 0xF]
                        | (inter[(f >> 4).clamp(0, 15)] << 2), f)
        Bw = torch.where(go, Bw >> 1, Bw)
    for r in range(3):
        go = td_i > r
        f = torch.where(go, f | (f << Bw), f)
        Bw = torch.where(go, Bw << 1, Bw)
    # descent (heap ids 1..31; depth static per id)
    fills = [None] * 32
    fills[1] = f
    for nid in range(1, 16):
        d = nid.bit_length() - 1
        B_nd = (Bp_i + (1 << d) - 1) >> d
        fv = fills[nid]
        f1 = torch.where(B_nd == 1, (fv & 1) | (fv << 1), fv)
        Bc = (B_nd + 1) >> 1
        msk = (one << Bc) - 1
        itn = it[:, nid - 1]
        sm = spl[:, nid - 1]
        f2 = torch.where(sm & (itn == 0), f1 & msk, f1)
        f2 = torch.where(sm & (itn == 16384), f1 & (msk << Bc), f2)
        fills[2 * nid] = f2
        fills[2 * nid + 1] = f2 >> Bc
    # leaves + ascent
    cms = [None] * 32
    fnz = [None] * NPB
    ffo = [None] * NPB
    zero = torch.zeros_like(Bp_i)
    for nid in range(31, 0, -1):
        d = nid.bit_length() - 1
        B_nd = (Bp_i + (1 << d) - 1) >> d
        cm_mask = (one << B_nd) - 1
        lm_ = lef[:, nid - 1]
        ff = fills[nid] & cm_mask
        kq = kk[:, nid - 1]
        pvq_m = lm_ & (kq > 0)
        nz_m = lm_ & (kq == 0) & (ff != 0)
        cm_leaf = torch.where(pvq_m, cmp_[:, nid - 1],
                              torch.where(nz_m & has_lb, ff,
                                          torch.where(nz_m, cm_mask, 0)))
        if 2 * nid + 1 <= 31:
            child = cms[2 * nid] | (cms[2 * nid + 1] << (B_nd >> 1))
        else:
            child = zero
        cms[nid] = torch.where(lm_, cm_leaf, child)
        fnz[nid - 1] = nz_m
        ffo[nid - 1] = nz_m & has_lb
    fnz[NPB - 1] = ffo[NPB - 1] = torch.zeros_like(has_lb)
    # root post folds (quant_band resynth tail)
    cm = cms[1]
    Bv = Bp_i
    for r in range(3):
        go = td_i > r
        Bv = torch.where(go, Bv >> 1, Bv)
        cm = torch.where(go, cm | (cm >> Bv), cm)
    for r in range(3):
        cm = torch.where(rc_i > r, deinter[cm.clamp(0, 15)], cm)
    cm = cm & ((one << (Bv << rc_i)) - 1)
    return cm, torch.stack(fnz, dim=1), torch.stack(ffo, dim=1)


DEFAULT_CAPS = (160, 48, 12)   # per-tier active-leaf slots (<=256 kbps)


def emit_plan(emits, *, C: int, lm: int, hdr, tf_res, spread, alloc,
              seed0, ac_on, final_energy, prev1, prev2,
              start: int = 0, end: int = 21, caps=DEFAULT_CAPS):
    """Resolve plan planes from walk emissions.

    Returns (p, seed_final, collapse_masks, fill_overflow). seed0: (S,)
    u32 LCG seed entering the frame (previous frame's EC range value).
    final_energy: (S, C, 21) post-finalise energies; prev1/prev2:
    (S, 2, 21) oldLogE/oldLogE2 (anti-collapse inputs). caps: per-tier
    compact slot capacities; lanes with more active leaves in a tier
    overflow (ok=False, the caller falls back). The default covers
    <=256 kbps with margin; pass a wider profile for higher rates.
    """
    lay = walk_layout(lm)
    tb = _tables(lm, C)
    dev = emits.slot.device
    k = _emit_consts(lm, C, dev)
    S = emits.slot.shape[1]
    nsl = lay.nslot
    M = 1 << lm
    eb = tb.ebands
    nbv, edges, arj = k["nbands"], k["edges"], k["arj"]
    transient = hdr.transient

    (n_split, n_leaf, n_itheta, n_k, n_idx, n_gain, n_rank) = \
        _scatter_nodes(emits, S, C * nsl)
    b_band, btheta, binv = _scatter_bands(emits, S)

    # ---- per-band B', recombine, time_divide --------------------------
    b_ent = torch.where(transient[:, None], M, 1)           # (S, 1)
    rc = tf_res.clamp(min=0)
    Bq = b_ent >> rc
    NBq = (nbv[None, :] // b_ent) << rc
    tfq = tf_res
    td = torch.zeros_like(tf_res)
    for _ in range(3):
        go = ((NBq & 1) == 0) & (tfq < 0)
        Bq = torch.where(go, Bq << 1, Bq)
        NBq = torch.where(go, NBq >> 1, NBq)
        tfq = torch.where(go, tfq + 1, tfq)
        td = torch.where(go, td + 1, td)
    band_bp = Bq

    # ---- lowband offset chain -----------------------------------------
    lo = torch.zeros(S, dtype=_I64, device=dev)
    upd = torch.ones(S, dtype=torch.bool, device=dev)
    lo_cols = [lo] * 21
    for i in range(start, end):
        if (M * int(eb[i]) - int(tb.nbands[i]) >= M * int(eb[start])
                or i == start + 1):
            lo = torch.where(upd | (lo == 0), i, lo)
        lo_cols[i] = lo
        upd = b_band[:, i] > (int(tb.nbands[i]) << BITRES)

    # ---- compact PVQ leaves into serving-profile tier slots -------------
    # Active leaves are compacted on the device into the same small tier
    # shapes the native serving profile uses; overflowing lanes get
    # ok=False (the caller falls back).
    cm_slot = torch.zeros((S, C * nsl), dtype=_I64, device=dev)
    overflow = torch.zeros(S, dtype=torch.bool, device=dev)
    leaf_k = torch.where(n_leaf, n_k, 0)
    comp = []   # per tier: dict of compact planes
    for t in range(3):
        idx = k["tier_idx"][t]
        CAP = caps[t]
        nmax = TIERS[t][0]
        W = idx.shape[0]
        kt = leaf_k[:, idx]
        act = kt > 0
        dep = k["tier_dep"][t]
        bp = band_bp[:, k["tier_band"][t]]
        bl = (bp + (1 << dep) - 1) >> dep
        rank = torch.cumsum(act.to(_I64), dim=1) - 1
        overflow = overflow | (act & (rank >= CAP)).any(dim=1)
        kept = act & (rank < CAP)
        tgt = torch.where(kept, rank, CAP)

        def compact(val, dtype):
            buf = torch.zeros((S, CAP + 1), dtype=dtype, device=dev)
            return buf.scatter_(1, tgt, val.expand(S, W).to(dtype))[:, :CAP]

        c = {"active": compact(act, torch.bool),
             "n": compact(k["tier_n"][t][None, :], _I64),
             "k": compact(kt, _I64), "idx": compact(n_idx[:, idx], _I64),
             "gain": compact(n_gain[:, idx], torch.float32),
             "dst": compact(k["tier_dst"][t][None, :], _I64),
             "b": compact(bl, _I64)}
        iy = cwrs_walk(c["active"].reshape(-1), c["n"].reshape(-1),
                       c["k"].reshape(-1), c["idx"].reshape(-1), nmax)
        cm_c = _collapse_from_iy(iy, c["n"].reshape(-1), c["b"].reshape(-1),
                                 nmax, k["ar8"]).reshape(S, CAP)
        cm_back = torch.gather(cm_c, 1, rank.clamp(0, CAP - 1))
        cm_slot[:, idx] = torch.where(kept, cm_back, 0)
        comp.append(c)

    # ---- band loop: fill/cm resolution ----------------------------------
    dual_dec = alloc.dual_stereo
    intensity = alloc.intensity

    def bm(x):
        """(S, C*nsl) plane -> (S, C, 21, NPB)."""
        return x.reshape(S, C, 21, NPB)

    spl4, lef4, it4 = bm(n_split), bm(n_leaf), bm(n_itheta)
    kk4, cmp4 = bm(n_k), bm(cm_slot)
    B_ent_v = torch.where(transient, M, 1)
    one = torch.ones_like(B_ent_v)
    full = (one << B_ent_v) - 1
    masksC = torch.zeros((S, 21, 2), dtype=_I64, device=dev)
    fnz_b, ffo_b, has_lb_b, eff_b = [], [], [], []
    ar8 = k["ar8"]
    for i in range(21):
        N_i = int(tb.nbands[i])
        lo_i = lo_cols[i]
        Bp_i = band_bp[:, i]
        can_fold = (lo_i != 0) & ((spread != SPREAD_AGGRESSIVE)
                                  | (B_ent_v > 1) | (tf_res[:, i] < 0))
        eff = (edges[lo_i.clamp(0, 21)] - N_i).clamp(min=0)
        fold_start = (edges[None, :21] <= eff[:, None]).sum(dim=1) - 1
        cand = (arj[None, :] >= lo_i[:, None]) & (
            (arj[None, :] >= i) | (edges[None, :21] >= (eff + N_i)[:, None]))
        fold_end = torch.argmax(cand.to(torch.int8), dim=1)
        hi_m = torch.maximum(fold_end, fold_start + 1)
        rng_m = (arj[None, :] >= fold_start[:, None]) & \
            (arj[None, :] < hi_m[:, None]) & (arj[None, :] < i)
        # OR of the (8-bit) masks over the fold window, bit by bit
        bits = (((masksC[:, :, :, None] >> ar8) & 1).to(torch.bool)
                & rng_m[:, :, None, None]).any(dim=1)      # (S, 2, 8)
        ors = (bits.to(_I64) << ar8).sum(dim=2)            # (S, 2)
        x_cm = torch.where(can_fold, ors[:, 0], full)
        y_cm = torch.where(can_fold, ors[:, 1], full)
        has_lb = can_fold

        def resolve(c, fill, lb):
            return _tree_resolve(spl4[:, c, i], lef4[:, c, i], it4[:, c, i],
                                 kk4[:, c, i], cmp4[:, c, i], fill, lb,
                                 Bp_i, td[:, i], rc[:, i], transient, M, k)

        if C == 1:
            cm1, fnz, ffo = resolve(0, x_cm | y_cm, has_lb)
            bandx = bandy = cm1
            fnz_o, ffo_o = fnz[:, None, :], ffo[:, None, :]
        else:
            joint = ~((dual_dec == 1) & (i < intensity))
            itb = btheta[:, i]
            fj = x_cm | y_cm
            fj = torch.where(joint & (itb == 0), fj & full, fj)
            fj = torch.where(joint & (itb == 16384), fj & (full << B_ent_v),
                             fj)
            fx = torch.where(joint, fj, x_cm)
            fy = torch.where(joint, fj >> B_ent_v, y_cm)
            cmx, fnzx, ffox = resolve(0, fx, has_lb)
            cmy, fnzy, ffoy = resolve(1, fy, has_lb & ~joint)
            bandx = torch.where(joint, cmx | cmy, cmx)
            bandy = torch.where(joint, cmx | cmy, cmy)
            fnz_o = torch.stack([fnzx, fnzy], dim=1)
            ffo_o = torch.stack([ffox, ffoy], dim=1)
        masksC[:, i] = torch.stack([bandx, bandy], dim=1)
        fnz_b.append(fnz_o)
        ffo_b.append(ffo_o)
        has_lb_b.append(has_lb)
        eff_b.append(torch.where(has_lb, eff, -1))
    fill_nonzero = torch.stack(fnz_b, dim=2).reshape(S, C * nsl)
    fill_fold = torch.stack(ffo_b, dim=2).reshape(S, C * nsl)
    has_lb_x = torch.stack(has_lb_b, dim=1)                 # (S, 21)
    eff_lb = torch.stack(eff_b, dim=1)

    # ---- seed chain -----------------------------------------------------
    A_J, C_J = k["lcg"]
    rank_c = n_rank.clamp(-1, RMAX - 1)
    is_fill_slot = n_rank >= 0
    draws = torch.where(is_fill_slot & fill_nonzero, k["s_n_all"][None, :], 0)
    dr = torch.zeros((S, RMAX + 1), dtype=_I64, device=dev).scatter_add_(
        1, torch.where(is_fill_slot, rank_c, RMAX), draws)
    cum = torch.cumsum(dr[:, :RMAX], dim=1) - dr[:, :RMAX]
    seed_rank = lcg_at(A_J, C_J, cum.clamp(0, A_J.shape[0] - 1),
                     seed0[:, None])
    seed_slot = torch.gather(seed_rank, 1, rank_c.clamp(0, RMAX - 1))
    seed_final = lcg_at(A_J, C_J, draws.sum(dim=1).clamp(0, A_J.shape[0] - 1),
                      seed0)

    # ---- assemble plan planes (compact tier slots) ----------------------
    p = {}
    p["direct"] = torch.zeros(S, dtype=torch.bool, device=dev)
    for key in ("active", "n", "k", "b"):
        p["pvq_" + key] = [comp[t][key] for t in range(3)]
    p["pvq_spread"] = [spread[:, None].expand(S, caps[t]) for t in range(3)]
    for key in ("gain", "idx", "dst"):
        p["pvq_" + key] = [comp[t][key] for t in range(3)]

    # fills: compact each (band, tree) padded node row into FILL_SLOTS_LS
    F = FILL_SLOTS_LS
    act4 = (n_leaf & (n_k == 0) & fill_nonzero).reshape(S, C, 21, NPB)
    fold4 = fill_fold.reshape(S, C, 21, NPB)
    gain4 = n_gain.reshape(S, C, 21, NPB)
    seed4 = seed_slot.reshape(S, C, 21, NPB)
    ordpos = torch.cumsum(act4.to(_I64), dim=3) - 1
    overflow = overflow | (act4 & (ordpos >= F)).any(dim=3).any(
        dim=2).any(dim=1)
    onehot = (ordpos[..., None] == torch.arange(F, device=dev)) \
        & act4[..., None]                                  # (S,C,21,NPB,F)
    oh_i = onehot.to(_I64)

    def to_plane(x, fillval):
        """(S, C, 21, F) -> (S, 21, 2, F) with the slot axis padded to 2,
        each stream's row contiguous (the band assembly kernel's layout,
        as in the host's arena)."""
        x = x.permute(0, 2, 1, 3)
        if C == 1:
            x = torch.cat([x, torch.full_like(x, fillval)], dim=2)
        return x.contiguous()

    p["fill_active"] = to_plane(onehot.any(dim=3), False)
    p["fill_fold"] = to_plane((onehot & fold4[..., None]).any(dim=3), False)
    p["fill_off"] = to_plane((oh_i * k["offs4"][None, None, :, :, None])
                             .sum(dim=3), 0)
    p["fill_n"] = to_plane((oh_i * k["ns4"][None, None, :, :, None])
                           .sum(dim=3), 0)
    p["fill_gain"] = to_plane(torch.where(onehot, gain4[..., None], 0.0)
                              .sum(dim=3), 1)
    p["fill_seed"] = to_plane(torch.where(onehot, seed4[..., None], 0)
                              .sum(dim=3), 0)

    # calls
    combo = k["combo"][transient.to(_I64)[:, None],
                       (tf_res + 3).clamp(0, 6)]           # (S, 21)
    in_rng = ((arj >= start) & (arj < end))[None, :].expand(S, 21)
    not_last = (arj < end - 1)[None, :]
    zb = torch.zeros_like(in_rng)
    zi = torch.zeros_like(combo)

    def pair(a, b):
        return torch.stack([a, b], dim=2)

    lb_src = eff_lb.clamp(min=0)
    if C == 1:
        p["call_active"] = pair(in_rng, zb)
        p["call_has_lb"] = pair(has_lb_x, zb)
        p["call_lb_src"] = pair(lb_src, zi)
        p["call_lb_buf"] = pair(zi, zi)
        p["call_blend_upto"] = pair(zi - 1, zi - 1)
        p["call_pre"] = p["call_post"] = pair(combo, zi)
        p["call_norm_write"] = pair(in_rng & not_last, zb)
        p["call_norm_buf"] = pair(zi, zi)
    else:
        dual_b = (dual_dec == 1)[:, None] & (arj[None, :]
                                             < intensity[:, None])
        p["call_active"] = pair(in_rng, in_rng)
        p["call_has_lb"] = pair(has_lb_x, has_lb_x & dual_b)
        p["call_lb_src"] = pair(lb_src, torch.where(dual_b, lb_src, 0))
        p["call_lb_buf"] = pair(zi, dual_b.to(_I64))
        # blend: after the dual->joint transition the norm buffer below
        # M*eb[intensity] holds the 0.5*(norm+norm2) average
        avg_m = (dual_dec == 1)[:, None] & (arj[None, :]
                                            >= intensity[:, None])
        upto = edges[intensity.clamp(0, 21)]
        p["call_blend_upto"] = pair(
            torch.where(avg_m & has_lb_x, upto[:, None], -1), zi - 1)
        p["call_pre"] = p["call_post"] = pair(combo, combo)
        p["call_norm_write"] = pair(in_rng & not_last,
                                    in_rng & not_last & dual_b)
        p["call_norm_buf"] = pair(zi, dual_b.to(_I64))
    p["call_dup"] = torch.zeros((S, 21, 2, 3), dtype=_I64, device=dev)

    # band stereo ops
    zf = torch.zeros((S, 21), dtype=torch.float32, device=dev)
    if C == 2:
        joint_b = in_rng & ~dual_b
        mid_b = torch.where(btheta == 0, 32767,
                            torch.where(btheta == 16384, 0,
                                        _bitexact_cos(btheta)))
        p["merge_active"] = joint_b
        p["merge_mid"] = torch.where(
            joint_b, mid_b.to(torch.float32) / 32768.0, 0.0)
        p["merge_inv"] = binv & joint_b
    else:
        p["merge_active"] = zb
        p["merge_mid"] = zf
        p["merge_inv"] = zb
    p["theta2_active"] = p["theta2_cswap"] = p["theta2_inv"] = zb
    p["theta2_sign"] = p["theta2_mid"] = p["theta2_side"] = zf
    p["n1_active"] = pair(zb, zb)
    p["n1_val"] = pair(zf, zf)

    # anti-collapse
    p["ac_on"] = ac_on
    p["ac_masks"] = masksC
    p["ac_seed"] = seed_final
    depth_b = ((1 + alloc.pulses) // k["n0"][None, :]) >> lm
    thresh = 0.5 * torch.exp2(-0.125 * depth_b.to(torch.float32))
    ac_r = [zf, zf]
    for c in range(C):
        p1 = prev1[:, c, :]
        p2 = prev2[:, c, :]
        if C == 1:
            p1 = torch.maximum(p1, prev1[:, 1, :])
            p2 = torch.maximum(p2, prev2[:, 1, :])
        ediff = (final_energy[:, c, :] - torch.minimum(p1, p2)).clamp(min=0.0)
        r = 2.0 * torch.exp2(-ediff)
        if lm == 3:
            r = r * 1.41421356
        ac_r[c] = torch.minimum(thresh, r) * k["sqrt_1"][None, :]
    p["ac_r"] = torch.stack(ac_r, dim=1)
    return p, seed_final, masksC, overflow
