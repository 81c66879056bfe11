"""The SILK quantizer kernels (csrc/silk_nsq.cu, arithmetic in
csrc/silk_nsq.h): the host build of the header against the plain versions
(ops/silk_nsq.nsq_frame_reference, nsq_del_dec_frame_reference) and the
JAX package's quantizers on the CPU, and, on the card, the kernels against
the plain versions.

The calls are every wide-band quantizer call of a real encoder run
(nsq_cases.harvest, 16 frames), harvested once a quantizer, and a copy of
each voiced call without NLSF interpolation (nsq_cases.with_branches).

(a) The host build against the plain version: nsq_frame at 24 and 12
    kbit/s, nsq_del_dec_frame at 24 kbit/s with the encoder's warping and
    with none. The header sums in the lane order of torch's CPU reduction,
    so every output of every lane is bit-equal; the calls reach every
    branch of the subframe prologue and of the flushes.
(b) The host build against the JAX package's quantizers at the bars of
    tests/test_silk_nsq_jax.py (a lane's share of equal pulses >= 0.985
    and the mean >= 0.995 for the single state; mean >= 0.9 and half the
    lanes exact for the delayed decision, its pulse energy within 2x of
    the reference's on every lane).
(c) Lanes that tie (the executor's unused lanes, zero input with and
    without a dead zone, frame seeds 0-7): pulses and seed_used exactly
    equal to the plain version's (ties go to the lowest state).
(d) A lane's pulses do not depend on its batch: the same calls alone, in
    another order and beside other lanes give the same pulses and seeds.
(e) The wrappers' routes and argument checks, and the field table in the
    order of the header's NsqArg.
(f) On the card (`cuda`): each kernel bit-equal to the host build, one
    launch a call; against the plain version on the card, whose sums run
    in CUDA's order, the pulses at (b)'s bars and, on the lanes whose
    pulses all agree, the frame and state within nsq_cases.STATE_TOL of
    the lane's peak and the seeds equal; unused and tied lanes exactly
    equal.
"""

import os
import re

import numpy as np
import pytest
import torch

import nsq_cases
from mousiki_tpu_torch.ops import silk_nsq as tnsq
from torch_threads import one_torch_thread  # noqa: F401

KW = nsq_cases.KW
WARP = nsq_cases.WARPING


@pytest.fixture(scope="module")
def calls():
    """The harvested calls with their branch copies: {"single": {rate:
    calls}, "dd": calls}, one encoder run each."""
    return {"single": {rate: nsq_cases.with_branches(
                nsq_cases.harvest(False, bitrate=rate))
                for rate in (24000, 12000)},
            "dd": nsq_cases.with_branches(nsq_cases.harvest(True))}


def _bit_equal(got, want, what):
    for name, g, w in zip(("pulses", "second", *tnsq.NsqDevState._fields),
                          nsq_cases.flat(got), nsq_cases.flat(want)):
        assert torch.equal(g, w), f"{what}: {name} differs"


def _reaches_every_branch(params, state):
    """Voiced lanes with and without interpolation, unvoiced lanes with
    and without a carried lag, subframes with and without a gain
    change."""
    v, it = params.voiced, params.interp
    lag = state.lag_prev
    prev = torch.cat([state.prev_gain[:, None], params.gains[:, :-1]], 1)
    changed = params.gains != prev
    for name, lanes in (("voiced, interpolated", v & it),
                        ("voiced, not interpolated", v & ~it),
                        ("unvoiced, no lag", ~v & (lag <= 0)),
                        ("unvoiced, a lag", ~v & (lag > 0)),
                        ("a gain change", changed.any(1)),
                        ("a subframe without one", (~changed).any(1))):
        assert bool(lanes.any()), f"no lane: {name}"


def _to_jax(params, state, del_dec):
    import jax.numpy as jnp
    from mousiki_tpu.ops import silk_nsq_jax as jnsq
    cls = jnsq.NsqDelDecState if del_dec else jnsq.NsqDevState
    return (jnsq.NsqParams(*(jnp.asarray(t.numpy()) for t in params)),
            cls(*(jnp.asarray(t.numpy()) for t in state)))


def _report(what, share):
    exact = int((share == 1.0).sum())
    print(f"{what}: lanes exactly equal {exact}/{len(share)}, mean share "
          f"{share.mean():.4f}, least {share.min():.4f}")


@pytest.mark.parametrize("bitrate", [24000, 12000])
def test_single_state_host_build(calls, bitrate):
    """(a) and (b) for nsq_frame."""
    pytest.importorskip("jax")
    from mousiki_tpu.ops import silk_nsq_jax as jnsq
    cs = calls["single"][bitrate]
    params, state = nsq_cases.batch(cs, len(cs), "cpu", False)
    _reaches_every_branch(params, state)
    got = tnsq.nsq_frame_host(params, state, **KW)
    _bit_equal(got, tnsq.nsq_frame_reference(params, state, **KW),
               f"nsq_frame {bitrate}")
    jpulses = np.asarray(jnsq.nsq_frame(*_to_jax(params, state, False),
                                        **KW)[0])
    share = (got[0].numpy() == jpulses).mean(1)
    _report(f"nsq_frame {bitrate}, host build vs JAX", share)
    assert share.min() >= 0.985 and share.mean() >= 0.995, share


@pytest.mark.parametrize("warping", [WARP, 0.0], ids=["encoder", "none"])
def test_delayed_decision_host_build(calls, warping):
    """(a) for nsq_del_dec_frame at both warpings; (b) at the encoder's."""
    cs = calls["dd"]
    params, state = nsq_cases.batch(cs, len(cs), "cpu", True)
    _reaches_every_branch(params, state)
    got = tnsq.nsq_del_dec_frame_host(params, state, **KW, warping=warping)
    _bit_equal(got, tnsq.nsq_del_dec_frame_reference(
        params, state, **KW, warping=warping),
        f"nsq_del_dec_frame w={warping}")
    if warping:
        pytest.importorskip("jax")
        from mousiki_tpu.ops import silk_nsq_jax as jnsq
        jpulses = np.asarray(jnsq.nsq_del_dec_frame(
            *_to_jax(params, state, True), **KW, n_states=4,
            warping=warping)[0])
        share = (got[0].numpy() == jpulses).mean(1)
        _report("nsq_del_dec_frame, host build vs JAX", share)
        assert share.mean() >= 0.9, share
        assert int((share == 1.0).sum()) >= len(share) // 2, share
        energy = ((got[0].double() ** 2).sum(1).numpy() + 1.0) \
            / ((jpulses.astype(np.float64) ** 2).sum(1) + 1.0)
        assert ((energy > 0.5) & (energy < 2.0)).all(), energy


def test_tied_and_unused_lanes_equal_the_plain_version(calls):
    """(c) The executor's unused lanes and zero-input lanes tie at every
    sample: state 0 wins, so seed_used is the frame seed & 3, exactly as
    in the plain version; mixed with real calls in one batch."""
    params, state = nsq_cases.batch(calls["dd"][:4], 8, "cpu", True,
                                    lanes=[0, -1, 1, -1, 2, -1, -1, 3])
    tied = nsq_cases.tied_lanes(8, "cpu")
    for p, s in ((params, state), tied):
        got = tnsq.nsq_del_dec_frame_host(p, s, **KW, warping=WARP)
        want = tnsq.nsq_del_dec_frame_reference(p, s, **KW, warping=WARP)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
    assert got[1].tolist() == [s & 3 for s in range(8)]
    p, s = nsq_cases.batch(calls["single"][24000][:3], 6, "cpu", False,
                           lanes=[-1, 0, -1, 1, -1, 2])
    assert torch.equal(tnsq.nsq_frame_host(p, s, **KW)[0],
                       tnsq.nsq_frame_reference(p, s, **KW)[0])


def test_lanes_do_not_depend_on_their_batch(calls):
    """(d) The same calls alone, reversed and beside unused lanes."""
    cs = calls["dd"][:6]
    n = len(cs)

    def run(lanes):
        p, s = nsq_cases.batch(cs, len(lanes), "cpu", True, lanes=lanes)
        return tnsq.nsq_del_dec_frame_host(p, s, **KW, warping=WARP)[:2]

    alone = run(list(range(n)))
    # call i sits in row rows[i]
    for lanes, rows in ((list(range(n))[::-1], list(range(n))[::-1]),
                        ([-1, *range(n), -1, -1], list(range(1, n + 1)))):
        pulses, seeds = run(lanes)
        assert torch.equal(pulses[rows], alone[0]), lanes
        assert torch.equal(seeds[rows], alone[1]), lanes
    single = calls["single"][24000][:4]
    p, s = nsq_cases.batch(single, 2 * len(single), "cpu", False)
    pulses = tnsq.nsq_frame_host(p, s, **KW)[0]
    assert torch.equal(pulses[:len(single)], pulses[len(single):])


def test_routes_and_argument_checks(calls):
    """(e) CPU tensors take the plain version (launching nothing); the
    kernels' checks refuse another shape, dtype, order or number of
    states; a device that is neither the CPU nor CUDA is refused. The
    field table follows NsqParams, the state and the header's NsqArg."""
    header = open(os.path.join(os.path.dirname(tnsq.__file__), "..", "csrc",
                               "silk_nsq.h")).read()
    enum = re.search(r"enum NsqArg \{(.*?)\};", header, re.S).group(1)
    args = [a.strip() for a in enum.split(",") if a.strip()]
    table = [name for name, *_ in (*tnsq.PARAM_FIELDS, *tnsq.STATE_FIELDS)]
    assert table == [*tnsq.NsqParams._fields, *tnsq.NsqDevState._fields]
    assert tnsq.NsqDevState._fields == tnsq.NsqDelDecState._fields
    outputs = [name for name, *_ in tnsq.OUTPUT_FIELDS]
    camel = [f"k{''.join(w.title() for w in n.split('_'))}" for n in
             (*table, "warp", "lw", *outputs[:3],
              *(f"o_{n}" for n in outputs[3:]))]
    assert args == [*camel, "kNsqArgs"]

    cs = calls["single"][24000][:3]
    p, s = nsq_cases.batch(cs, 3, "cpu", False)
    tnsq.reset_launches()
    got = tnsq.nsq_frame(p, s, **KW)
    want = tnsq.nsq_frame_reference(p, s, **KW)
    assert all(torch.equal(a, b) for a, b in zip(got[:2], want[:2]))
    assert tnsq.nsq_frame_launches == 0 and tnsq.nsq_del_dec_launches == 0
    with pytest.raises(ValueError, match="take"):
        tnsq.nsq_frame_host(p, s, nb_subfr=2, sub=80, M=320)
    with pytest.raises(ValueError, match="order"):
        tnsq.nsq_frame_host(p, s, **KW, order=25)
    with pytest.raises(TypeError, match="pitch_l"):
        tnsq.nsq_frame_host(p._replace(pitch_l=p.pitch_l.long()), s, **KW)
    with pytest.raises(TypeError, match="ar_shp"):
        tnsq.nsq_frame_host(p._replace(ar_shp=p.ar_shp[:, :, :16]), s, **KW)
    dd = nsq_cases.batch(cs, 3, "cpu", True)
    with pytest.raises(ValueError, match="states"):
        tnsq.nsq_del_dec_frame_host(*dd, **KW, n_states=2)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tnsq.nsq_frame(tnsq.NsqParams(*(t.to("meta") for t in p)), s, **KW)
    # an order under 24 on both routes; the s_ar2 columns past the order
    # keep the state's values
    short = tnsq.nsq_del_dec_frame_host(*dd, **KW, order=16, warping=WARP)
    _bit_equal(short, tnsq.nsq_del_dec_frame_reference(
        *dd, **KW, order=16, warping=WARP), "order 16")
    assert torch.equal(short[2].s_ar2[:, 16:], dd[1].s_ar2[:, 16:])


@pytest.mark.cuda
def test_kernels_on_the_card():
    """(f) Both kernels on the calls tiled to S = 256 with unused lanes
    among them (and, for the delayed decision, 8 tied lanes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    S = 256
    for del_dec in (False, True):
        cs = nsq_cases.with_branches(nsq_cases.harvest(del_dec))
        lanes = np.arange(S) % len(cs)
        lanes[::17] = -1
        args = [nsq_cases.batch(cs, S, d, del_dec, lanes=lanes)
                for d in (dev, "cpu")]
        kw = dict(KW, warping=WARP) if del_dec else KW
        kernel, plain, host = nsq_cases.ROUTES[del_dec]
        tnsq.reset_launches()
        got = kernel(*args[0], **kw)
        torch.cuda.synchronize()
        assert (tnsq.nsq_del_dec_launches if del_dec
                else tnsq.nsq_frame_launches) == 1
        _bit_equal(got, host(*args[1], **kw), "kernel vs host build")
        want = plain(*args[0], **kw)
        agree = nsq_cases.agreement(got, want)
        assert nsq_cases.held(agree, del_dec) is None, \
            nsq_cases.held(agree, del_dec)
        unused = torch.as_tensor(lanes < 0)
        assert torch.equal(got[0].cpu()[unused], want[0].cpu()[unused])
        if del_dec:
            assert torch.equal(got[1].cpu()[unused], want[1].cpu()[unused])
            tied = nsq_cases.tied_lanes(8, dev)
            t_got, t_want = kernel(*tied, **kw), plain(*tied, **kw)
            assert torch.equal(t_got[0], t_want[0])
            assert torch.equal(t_got[1], t_want[1])
