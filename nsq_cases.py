"""Quantizer calls for the SILK noise-shaping quantizers (the port's
ops/silk_nsq.py): every wide-band call of a real encoder run (the port's
copy of the host SILK encoder on a seeded speech-like signal), batched as
the executor batches them, and lanes that tie (the executor's padded
lanes, zero input). Shared by the port's tests and chip_smoke.py; it is
not part of any installed package, and imports no JAX.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from mousiki_tpu_torch.ops import silk_nsq
from mousiki_tpu_torch.parallel.nsq_batch import NsqBatchExecutor

KW = dict(nb_subfr=4, sub=80, M=320)     # the executor's shape
WARPING = 983 * 16 / 65536.0             # the encoder's at 16 kHz
# on the lanes whose pulses all agree, how far a quantizer's frame and
# state may be from another's: this share of the lane's peak magnitude
STATE_TOL = 1e-4
# del_dec -> (wrapper, plain version, host build) of a quantizer
ROUTES = {False: (silk_nsq.nsq_frame, silk_nsq.nsq_frame_reference,
                  silk_nsq.nsq_frame_host),
          True: (silk_nsq.nsq_del_dec_frame,
                 silk_nsq.nsq_del_dec_frame_reference,
                 silk_nsq.nsq_del_dec_frame_host)}


def speechlike(n, seed=0, frame=320):
    """Alternating voiced / unvoiced resonator output at int16 scale (the
    signal of the quantizer tests)."""
    rng = np.random.default_rng(seed)
    out = np.zeros(n, np.float64)
    t = 0
    voiced = True
    while t < n:
        seg = min(n - t, 4 * frame)
        if voiced:
            exc = np.zeros(seg)
            exc[::rng.integers(40, 200)] = 1.0
            exc += rng.standard_normal(seg) * 0.02
        else:
            exc = rng.standard_normal(seg) * 0.3
        a = 1.8 * np.cos(2 * np.pi * rng.uniform(0.03, 0.12))
        y = np.zeros(seg)
        y1 = y2 = 0.0
        for i in range(seg):
            y[i] = exc[i] + a * y1 - 0.81 * y2
            y2, y1 = y1, y[i]
        out[t:t + seg] = y / (np.abs(y).max() + 1e-9)
        t += seg
        voiced = not voiced
    return out * 9000


def harvest(del_dec: bool, n_frames=16, bitrate=24000):
    """Every wide-band quantizer call of a real encoder run (the copied
    host SILK encoder on the speech-like signal), each with the quantizer
    state it started from, as the executor's request dicts."""
    from mousiki_tpu_torch.hostcodec.bitstream.entcode import RangeEncoder
    from mousiki_tpu_torch.hostcodec.silk import noise_shape, nsq_del_dec
    from mousiki_tpu_torch.hostcodec.silk.encoder import SilkEncoder

    module, name = ((nsq_del_dec, "nsq_del_dec_best") if del_dec
                    else (noise_shape, "nsq_shaped"))
    orig = getattr(module, name)
    calls = []

    def spy(x, st_nsq, ctl, **kw):
        req = {"x": np.asarray(x, np.float64).copy(),
               "st": copy.deepcopy(st_nsq), "ctl": ctl, "kw": dict(kw)}
        out = orig(x, st_nsq, ctl, **kw)
        if kw["frame_length"] == 320:
            calls.append(req)
        return out

    setattr(module, name, spy)
    try:
        enc = SilkEncoder()
        enc.use_del_dec = del_dec
        enc.set_fs(16, 16000, 4)
        sig = speechlike(320 * (n_frames + 1), seed=1)
        for f in range(n_frames):
            rc = RangeEncoder(1300)
            enc.encode_frame(rc, sig[f * 320:(f + 1) * 320], 4, bitrate)
            rc.done()
    finally:
        setattr(module, name, orig)
    return calls


def with_branches(calls):
    """The calls and, for each voiced call with NLSF interpolation, a copy
    without it. The harvested encoder run interpolates every voiced
    frame; a voiced frame without interpolation re-whitens the LTP memory
    once a frame instead of twice and does not flush the delayed decision
    at the third subframe, branches that the copies reach."""
    flat = [dict(c, kw=dict(c["kw"], nlsf_interp_flag=0)) for c in calls
            if c["kw"]["signal_type"] == 2 and c["kw"]["nlsf_interp_flag"]]
    return [*calls, *flat]


def batch(calls, S, device, del_dec, lanes=None):
    """Lane s holds call lanes[s] (default s % len(calls)); a lane of -1 is
    an unused lane at the executor's defaults. Returns (NsqParams, state)
    on `device`."""
    P, st = NsqBatchExecutor(max(len(calls), 1),
                             device="cpu").pack_requests(calls)
    lane = np.arange(S) % max(len(calls), 1) if lanes is None \
        else np.asarray(lanes)
    pad = NsqBatchExecutor(1, device="cpu").pack_requests([])

    def pick(v, name, group):
        rows = v[np.maximum(lane, 0)]
        rows[lane < 0] = group[name][0]
        return torch.from_numpy(rows).to(device)

    params = silk_nsq.NsqParams(**{k: pick(v, k, pad[0])
                                   for k, v in P.items()})
    cls = silk_nsq.NsqDelDecState if del_dec else silk_nsq.NsqDevState
    return params, cls(**{k: pick(v, k, pad[1]) for k, v in st.items()})


def tied_lanes(S, device, seed_offset: int = 0):
    """S lanes whose four trellis states tie at every sample: the
    executor's unused lanes (zero input and state) with frame seeds
    seed_offset + s, so that each seed & 3 orders the states' dither
    differently, and every other lane with a dead zone (lambda 2.5) and a
    quantization offset. Returns (NsqParams, state) for the delayed
    decision on `device`."""
    params, state = batch([], S, "cpu", True, lanes=[-1] * S)
    seed = torch.arange(seed_offset, seed_offset + S, dtype=torch.int32)
    dz = torch.arange(S) % 2 == 1
    params = params._replace(
        seed=seed, lam=torch.where(dz, 2.5, 0.0).to(torch.float32),
        offset=torch.where(dz, 0.3, 0.0).to(torch.float32))
    move = lambda t: t.to(device)  # noqa: E731
    return (silk_nsq.NsqParams(*map(move, params)),
            type(state)(*map(move, state)))


def flat(out) -> list:
    """A quantizer's outputs (pulses, xq_frame or seed_used, state) as one
    list of CPU tensors."""
    return [t.cpu() for t in (out[0], out[1], *out[2])]


def agreement(got, want) -> dict:
    """How one quantizer call's outputs `got` agree with `want`, each
    (pulses, xq_frame or seed_used, state) on any device: each lane's share
    of equal pulses ("share", a tensor), the lanes where every pulse is
    equal ("exact"), and on those lanes the largest difference of the
    frame and of each state field, over the lane's peak magnitude of that
    field or 1 ("state_err"), and whether the winning seeds are equal
    ("seeds_equal", None for the single state)."""
    share = (got[0].cpu() == want[0].cpu()).double().mean(1)
    exact = share == 1
    del_dec = got[1].dim() == 1
    pairs = list(zip(got[2], want[2]))
    if not del_dec:
        pairs.append((got[1], want[1]))
    err = 0.0
    for g, w in pairs:
        g = g.cpu().double()[exact].reshape(int(exact.sum()), -1)
        w = w.cpu().double()[exact].reshape(g.shape)
        if g.numel():
            peak = w.abs().amax(1).clamp(min=1.0)
            err = max(err, float(((g - w).abs().amax(1) / peak).max()))
    seeds = (torch.equal(got[1].cpu()[exact], want[1].cpu()[exact])
             if del_dec else None)
    return {"share": share, "exact": int(exact.sum()), "state_err": err,
            "seeds_equal": seeds}


def held(agree: dict, del_dec: bool) -> str | None:
    """Why an agreement misses the reference's bars, or None: pulses
    (tests/test_silk_nsq_jax.py: a lane's share >= 0.985 and the mean >=
    0.995 for the single state; mean >= 0.9 and half the lanes exact for
    the delayed decision), and on the exact lanes the frame and state
    within STATE_TOL and the seeds equal."""
    share, n = agree["share"], len(agree["share"])
    if del_dec and (float(share.mean()) < 0.9 or agree["exact"] < n // 2):
        return (f"mean share {float(share.mean()):.4f}, {agree['exact']} "
                f"of {n} lanes exact")
    if not del_dec and (float(share.min()) < 0.985
                        or float(share.mean()) < 0.995):
        return (f"least share {float(share.min()):.4f}, mean "
                f"{float(share.mean()):.4f}")
    if agree["state_err"] > STATE_TOL:
        return f"state {agree['state_err']:.3g} of the peak on exact lanes"
    if agree["seeds_equal"] is False:
        return "a seed differs on an exact lane"
    return None


def executor_requests(calls, S, use_del_dec, device):
    """An NsqBatchExecutor of S slots on `device` and S requests, lane s
    holding call s % len(calls) with its own copy of the state, as
    `NsqBatchExecutor.hook` parks them: `_dispatch(reqs)` runs one device
    call (each dispatch writes the new state back into the copies)."""
    import threading

    ex = NsqBatchExecutor(S, use_del_dec=use_del_dec, device=device)
    reqs = [dict(calls[s % len(calls)],
                 st=copy.deepcopy(calls[s % len(calls)]["st"]),
                 event=threading.Event(), task=s, pulses=None, seed=None)
            for s in range(S)]
    return ex, reqs
