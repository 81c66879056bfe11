"""Batched CELT band-plan executor in PyTorch: port of
mousiki_tpu/ops/band_exec_jax.py.

For S streams at once, everything `bands.quant_all_bands` (decode side)
does to the signal after the symbols are known:

  P1  CWRS index -> pulse vector walk (cwrs.rs cwrsi), and
  P2  normalisation and PVQ spreading rotation (vq.rs exp_rotation),
      each leaf's values placed in the X plane at its pvq_dst span:
      ops/pvq_leaves.leaf_stage, one CUDA kernel a call on the card (the
      plain torch walk, values and gather map on the CPU).
  P3  Band assembly in band order: fold/noise fills (counter-form LCG),
      per-stream pre/post transform operators, norm-buffer upkeep, stereo
      merge and the N == 2 butterfly: ops/band_assembly.py, one CUDA
      kernel a call on the card (the plain loop over the 21 bands on the
      CPU).
  P4  anti_collapse (bands.rs:3220) with host-computed r and device LCG.

uint32 arithmetic runs in int64 holding values in [0, 2^32): torch has
almost no uint32 ops. The leaves are float32; from the pool on, the X
plane is float64 through P3 (norm buffers, operator products, fill
energies, stereo merges) and P4 (band energies) and is rounded to
float32 once, at the end, so that a stream's X does not depend on its
batch (_device.py). Mixing the two widths in one op is avoided: torch's
`where` casts a mismatched operand with a launch of its own.
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
from ._tables import LCG_MAX, lcg_at, lcg_tensors, plan_combo_mats_np
from .band_assembly import band_assembly, packed_operators
from .pvq_leaves import cwrs_walk, leaf_stage

_M32 = 0xFFFFFFFF


# ------------------------------------------------------------------ consts

def plan_combo_mats(channels: int, frame: int, device):
    """The per-band pre/post combo operators (the reference's float32
    values) that execute_packed takes as `mats`, in the layout its band
    assembly reads on `device`; the one place that picks the layout:

      * CPU: the stacks identity-padded to NBMAX, (21, NC, NBMAX, NBMAX)
        each, held in float64, for band_assembly_reference's gathers;
      * CUDA: the kernel's packing of their nonzeros, a
        band_assembly.SparseOperators each (packed_operators).

    Callers hand the pair to execute_packed on the same device."""
    dev = _device.as_device(device)
    if dev.type == "cuda":
        return packed_operators(frame, dev)
    pre_all, post_all = plan_combo_mats_np(frame)
    return (_device.operator64(pre_all, dev),
            _device.operator64(post_all, dev))


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
    ind = np.zeros((nbins, nb), np.float64)
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
    mats: (pre, post) from plan_combo_mats(channels, frame, device)
    """
    p = _normalize_plan(p)
    dev = p["direct"].device
    nb = MODE.num_ebands
    M = 1 << lm
    S = p["direct"].shape[0]
    A_J, C_J = lcg_tensors(dev)

    # ---- P1 + P2 and the pool -> X gather: the PVQ leaves' values at
    # their pvq_dst spans, 0.0 elsewhere: one kernel launch on the card --
    with record_function("plan.leaves"):
        X = leaf_stage(p, channels=channels, frame=frame)   # (S, C*frame)

    # ---- P3: band assembly, in band order (fold lowbands read bands
    # decoded before them): one kernel launch on the card --------------
    with record_function("plan.bands"):
        band_assembly(p, X, mats, channels=channels, frame=frame, lm=lm,
                      start=start, end=end)

    # ---- P4: anti-collapse (whole plane at once) -----------------------
    # The per-(band, channel) LCG draw counts are known up front, so every
    # position's seed comes from one closed-form jump (A_J/C_J); band
    # energies for the renormalise come from one indicator product.
    with record_function("plan.anti_collapse"):
        q = _p4_consts(lm, start, end, dev)
        nbins, bmap, kmap = q["nbins"], q["bmap"], q["kmap"]
        vmask = q["vmask"]
        ac_on = p["ac_on"]
        ac_r = p["ac_r"].double()
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
            seeds = lcg_at(A_J, C_J, dd, p["ac_seed"][:, None])
            rq = ac_r[:, c, :][:, bmap]
            val = torch.where((seeds & 0x8000) != 0, rq, -rq)
            xplane = X[:, c * frame:c * frame + nbins]
            inject = clrq & ac_on[:, None] & vmask[None, :]
            x2 = torch.where(inject, val, xplane)
            Eb = 1e-15 + torch.matmul(x2 * x2, q["ind"])
            gb = 1.0 / torch.sqrt(Eb)
            anyb = (cnt[:, :, c] > 0) & ac_on[:, None]           # (S, nb)
            gq = torch.where(anyb[:, bmap] & vmask[None, :], gb[:, bmap],
                             torch.ones((), dtype=torch.float64, device=dev))
            X[:, c * frame:c * frame + nbins] = x2 * gq

    return torch.where(p["direct"][:, None], x_direct.reshape(S, -1),
                       X.float())


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
