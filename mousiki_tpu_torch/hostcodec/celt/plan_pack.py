"""Pack recorded FramePlans into dense per-stream tensors for the device
band-reconstruction executor (ops/band_exec_jax.py).

Layout (S streams, all plans share static config C/N/LM/start/end):
  - PVQ leaves in three size tiers; each leaf = (dst, n, k, b, spread, gain,
    idx). The CWRS walk and rotation run on device, outputs land in a flat
    "pool"; the executor rebuilds the pool->X gather map on device from the
    per-slot dst offsets (difference-array cumsum over disjoint spans).
  - quant_band calls as (band, slot) entries carrying lowband source,
    transform combo ids, norm-write flags, and an intensity-blend boundary.
  - fold/noise leaves as per-call fill slots (window into the call's
    prepared scratch + LCG seed).
  - stereo merges / N==2 butterflies / anti-collapse inputs per band.

Any structure exceeding the static capacities marks the frame `direct`
(the executor then consumes the host-decoded spectrum for that stream).
"""

from __future__ import annotations

import numpy as np

from .modes import opus_custom_mode
from .plan import BUF_NORM, BUF_NORM2, BUF_SCRATCH, CONST, FOLD, NOISE, PVQ

# tier capacities: (max leaf n, number of slots); sized so even 510 kbps
# stereo frames (max splits, ~270 leaves) pack without direct fallback
TIERS = ((16, 224), (48, 48), (176, 16))
FILL_SLOTS = 4
POOL0 = 1  # reserved zero cell at pool index 0

# transform combos: (b0, tf_change); id 0 = identity (b0 == 1, tf == 0).
# B at a quant_band call is always 1 (long blocks) or M (short blocks).


def combos_for_m(M: int):
    out = [(1, 0)]
    for b0 in dict.fromkeys((1, M)):
        for tf in (-3, -2, -1, 0, 1, 2, 3):
            if (b0, tf) != (1, 0):
                out.append((b0, tf))
    return out


def pool_layout():
    """Flat pool offsets: [zero cell][tier0][tier1][tier2]."""
    offs = [POOL0]
    for nmax, slots in TIERS:
        offs.append(offs[-1] + nmax * slots)
    return offs  # len 4: start of t0, t1, t2, end


def _tier_of(n: int) -> int:
    for t, (nmax, _) in enumerate(TIERS):
        if n <= nmax:
            return t
    raise AssertionError(n)


class PackError(Exception):
    pass


def pack_plans(plans, channels: int, frame: int):
    """plans: list of S FramePlan (+ optional x fallback pairs).

    Returns a dict of numpy arrays. Streams whose plan is direct (or
    unpackable) get direct=True; caller supplies x_direct separately.
    """
    S = len(plans)
    mode = opus_custom_mode(48000, 960)
    nb = mode.num_ebands
    offs = pool_layout()

    out = {
        "direct": np.zeros(S, np.bool_),
        # PVQ leaves per tier
        "pvq_active": [np.zeros((S, TIERS[t][1]), np.bool_) for t in range(3)],
        "pvq_n": [np.zeros((S, TIERS[t][1]), np.int32) for t in range(3)],
        "pvq_k": [np.zeros((S, TIERS[t][1]), np.int32) for t in range(3)],
        "pvq_b": [np.zeros((S, TIERS[t][1]), np.int32) for t in range(3)],
        "pvq_spread": [np.zeros((S, TIERS[t][1]), np.int32) for t in range(3)],
        "pvq_gain": [np.ones((S, TIERS[t][1]), np.float32) for t in range(3)],
        "pvq_idx": [np.zeros((S, TIERS[t][1]), np.uint32) for t in range(3)],
        "pvq_dst": [np.zeros((S, TIERS[t][1]), np.int32) for t in range(3)],
        # calls (band, slot)
        "call_active": np.zeros((S, nb, 2), np.bool_),
        "call_has_lb": np.zeros((S, nb, 2), np.bool_),
        "call_lb_src": np.zeros((S, nb, 2), np.int32),
        "call_lb_buf": np.zeros((S, nb, 2), np.int32),   # 0 norm, 1 norm2
        "call_blend_upto": np.full((S, nb, 2), -1, np.int32),
        "call_pre": np.zeros((S, nb, 2), np.int32),      # combo id
        "call_post": np.zeros((S, nb, 2), np.int32),
        "call_norm_write": np.zeros((S, nb, 2), np.bool_),
        "call_norm_buf": np.zeros((S, nb, 2), np.int32),
        # fills (band, slot, fslot)
        "fill_active": np.zeros((S, nb, 2, FILL_SLOTS), np.bool_),
        "fill_fold": np.zeros((S, nb, 2, FILL_SLOTS), np.bool_),
        "fill_off": np.zeros((S, nb, 2, FILL_SLOTS), np.int32),
        "fill_n": np.zeros((S, nb, 2, FILL_SLOTS), np.int32),
        "fill_gain": np.ones((S, nb, 2, FILL_SLOTS), np.float32),
        "fill_seed": np.zeros((S, nb, 2, FILL_SLOTS), np.uint32),
        # band ops
        "merge_active": np.zeros((S, nb), np.bool_),
        "merge_mid": np.zeros((S, nb), np.float32),
        "merge_inv": np.zeros((S, nb), np.bool_),
        "theta2_active": np.zeros((S, nb), np.bool_),
        "theta2_cswap": np.zeros((S, nb), np.bool_),
        "theta2_sign": np.zeros((S, nb), np.float32),
        "theta2_mid": np.zeros((S, nb), np.float32),
        "theta2_side": np.zeros((S, nb), np.float32),
        "theta2_inv": np.zeros((S, nb), np.bool_),
        "n1_active": np.zeros((S, nb, 2), np.bool_),
        "n1_val": np.zeros((S, nb, 2), np.float32),
        # anti-collapse
        "ac_on": np.zeros(S, np.bool_),
        "ac_masks": np.zeros((S, nb, 2), np.int32),
        "ac_r": np.zeros((S, 2, nb), np.float32),
        "ac_seed": np.zeros(S, np.uint32),
        # special_hybrid_folding window-duplicate op: zero for start==0
        # plans (the Python recorder covers the CELT-only path)
        "call_dup": np.zeros((S, nb, 2, 3), np.int16),
    }

    for s, plan in enumerate(plans):
        try:
            if plan is None or plan.direct:
                raise PackError("direct")
            _pack_one(out, s, plan, channels, frame, mode, offs)
        except PackError:
            out["direct"][s] = True
    return out


def _pack_one(out, s, plan, channels, frame, mode, offs):
    if plan.channels != channels or plan.frame != frame:
        raise PackError("config mismatch")
    combo_id = {bt: i for i, bt in enumerate(combos_for_m(1 << plan.lm))}
    eb = mode.ebands
    M = 1 << plan.lm
    if M * mode.short_mdct_size != frame:
        raise PackError("lm mismatch")
    nb = mode.num_ebands
    band_start = [M * int(eb[i]) for i in range(nb + 1)]
    norm_offset = plan.norm_offset

    tier_used = [0, 0, 0]

    def band_slot_of(dst):
        ch = dst // frame
        off = dst - ch * frame
        for i in range(nb):
            if band_start[i] <= off < band_start[i + 1]:
                return i, ch, off - band_start[i]
        raise PackError(f"dst {dst} outside bands")

    pending_call = None  # (band, slot, call) while packing its leaves

    def avg_upto_now():
        return avg_state[0]

    avg_state = [-1]

    for kind, op in plan.ops:
        if kind == "call":
            c = op
            if c.n1:
                band, ch, rel = band_slot_of(c.dst)
                if rel != 0:
                    raise PackError("n1 not band aligned")
                for lf in c.leaves:
                    if lf.kind != CONST:
                        raise PackError("non-const in n1")
                    b2, ch2, rel2 = band_slot_of(lf.dst)
                    out["n1_active"][s, b2, ch2] = True
                    out["n1_val"][s, b2, ch2] = lf.val
                out["call_active"][s, band, ch] = True
                if c.norm_out >= 0:
                    out["call_norm_write"][s, band, ch] = True
                    out["call_norm_buf"][s, band, ch] = (
                        0 if c.norm_buf == BUF_NORM else 1)
                    if c.norm_out != band_start[band] - norm_offset:
                        raise PackError("n1 norm offset")
                continue
            band, ch, rel = band_slot_of(c.dst)
            if rel != 0 or c.n != band_start[band + 1] - band_start[band]:
                raise PackError("call not band aligned")
            slot = ch
            if out["call_active"][s, band, slot]:
                raise PackError("slot collision")
            out["call_active"][s, band, slot] = True
            out["call_has_lb"][s, band, slot] = c.has_lowband
            if c.has_lowband:
                if c.lb_buf == BUF_SCRATCH:
                    raise PackError("lowband in scratch")
                out["call_lb_src"][s, band, slot] = c.lb_src
                out["call_lb_buf"][s, band, slot] = (
                    0 if c.lb_buf == BUF_NORM else 1)
                if c.lb_buf == BUF_NORM:
                    out["call_blend_upto"][s, band, slot] = avg_upto_now()
            combo = combo_id.get((c.b0, c.tf_change))
            if combo is None:
                raise PackError(f"combo {(c.b0, c.tf_change)}")
            out["call_pre"][s, band, slot] = combo
            out["call_post"][s, band, slot] = combo
            if c.norm_out >= 0:
                if c.norm_out != band_start[band] - norm_offset:
                    raise PackError("norm offset mismatch")
                out["call_norm_write"][s, band, slot] = True
                out["call_norm_buf"][s, band, slot] = (
                    0 if c.norm_buf == BUF_NORM else 1)
            # leaves
            fslot = 0
            for lf in c.leaves:
                if lf.kind == PVQ:
                    t = _tier_of(lf.n)
                    # promote to a bigger tier when this one is full
                    while t < 3 and tier_used[t] >= TIERS[t][1]:
                        t += 1
                    if t == 3:
                        raise PackError("pvq tiers full")
                    j = tier_used[t]
                    tier_used[t] += 1
                    out["pvq_active"][t][s, j] = True
                    out["pvq_n"][t][s, j] = lf.n
                    out["pvq_k"][t][s, j] = lf.k
                    out["pvq_b"][t][s, j] = lf.b
                    out["pvq_spread"][t][s, j] = lf.spread
                    out["pvq_gain"][t][s, j] = lf.gain
                    out["pvq_idx"][t][s, j] = lf.idx & 0xFFFFFFFF
                    out["pvq_dst"][t][s, j] = lf.dst
                elif lf.kind in (FOLD, NOISE):
                    if fslot >= FILL_SLOTS:
                        raise PackError("fill slots full")
                    _, _, lrel = band_slot_of(lf.dst)
                    if lf.kind == FOLD:
                        # fold window must sit at the leaf's own offset
                        # within the call's prepared lowband (the device
                        # always reads through its scratch copy)
                        if not c.has_lowband:
                            raise PackError("fold without lowband")
                        if lf.src_buf == BUF_SCRATCH:
                            srel = lf.src
                        elif (lf.src_buf == BUF_NORM) == (c.lb_buf == BUF_NORM):
                            srel = lf.src - c.lb_src
                        else:
                            raise PackError("fold src buffer mismatch")
                        if srel != lrel:
                            raise PackError("fold src misaligned")
                    out["fill_active"][s, band, slot, fslot] = True
                    out["fill_fold"][s, band, slot, fslot] = lf.kind == FOLD
                    out["fill_off"][s, band, slot, fslot] = lrel
                    out["fill_n"][s, band, slot, fslot] = lf.n
                    out["fill_gain"][s, band, slot, fslot] = lf.gain
                    out["fill_seed"][s, band, slot, fslot] = lf.seed & 0xFFFFFFFF
                    fslot += 1
                else:
                    raise PackError("const outside n1")
        elif kind == "merge":
            xo, yo, n, mid, inv = op
            band, ch, rel = band_slot_of(xo)
            out["merge_active"][s, band] = True
            out["merge_mid"][s, band] = mid
            out["merge_inv"][s, band] = inv
        elif kind == "theta2":
            xo, yo, cswap, sign, mid, side, inv = op
            band, ch, rel = band_slot_of(xo)
            out["theta2_active"][s, band] = True
            out["theta2_cswap"][s, band] = bool(cswap)
            out["theta2_sign"][s, band] = float(sign)
            out["theta2_mid"][s, band] = mid
            out["theta2_side"][s, band] = side
            out["theta2_inv"][s, band] = inv
        elif kind == "avg":
            avg_state[0] = int(op)
        elif kind == "hybrid":
            n1f, n2f, _dual = op
            if n1f != n2f:
                # real hybrid folding (start > 0) — device op not built yet
                raise PackError("hybrid folding not packed yet")
            # start == 0: the special fold is a zero-length no-op
        else:
            raise PackError(kind)

    if plan.ac is not None:
        a = plan.ac
        out["ac_on"][s] = True
        masks = np.asarray(a["masks"], np.int32)
        C = plan.channels
        for i in range(mode.num_ebands):
            out["ac_masks"][s, i, 0] = masks[i * C + 0]
            out["ac_masks"][s, i, 1] = masks[i * C + C - 1]
        out["ac_seed"][s] = a["seed"] & 0xFFFFFFFF
        # host-side r computation (bands.anti_collapse preamble)
        logE, prev1, prev2 = a["logE"], a["prev1"], a["prev2"]
        pulses = a["pulses"]
        LM = plan.lm
        for i in range(plan.start, plan.end):
            N0 = int(eb[i + 1]) - int(eb[i])
            depth = ((1 + pulses[i]) // N0) >> LM
            thresh = 0.5 * (2.0 ** (-0.125 * depth))
            sqrt_1 = 1.0 / np.sqrt(N0 << LM)
            for ci in range(C):
                p1, p2 = prev1[ci, i], prev2[ci, i]
                if C == 1 and prev1.shape[0] > 1:
                    p1 = max(p1, prev1[1, i])
                    p2 = max(p2, prev2[1, i])
                ediff = max(0.0, float(logE[ci, i]) - min(float(p1), float(p2)))
                r = 2.0 * (2.0 ** (-ediff))
                if LM == 3:
                    r *= 1.41421356
                out["ac_r"][s, ci, i] = min(thresh, r) * sqrt_1
