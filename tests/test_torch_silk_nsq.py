"""mousiki_tpu_torch.ops.silk_nsq (the batched noise-shaping quantizers)
against the host quantizers of the numpy codec and against
mousiki_tpu's ops/silk_nsq_jax, on parameters harvested from real
SilkEncoder runs (the cases of tests/test_silk_nsq_jax.py, whose harvest
helpers are shared). Agreement is by share of equal pulses, at the
reference's own bars: a boundary decision that flips in float32 carries on
through the dither, so equality of every pulse is not promised."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mousiki_tpu.ops import silk_nsq_jax as jnsq  # noqa: E402
from mousiki_tpu_torch import convert  # noqa: E402
from mousiki_tpu_torch.ops import silk_nsq as tnsq  # noqa: E402
from test_silk_nsq_jax import (L, M, NB_SUBFR, SUB, harvest,  # noqa: E402
                               harvest_dd)
from test_silk_nsq_jax import to_batch as jax_batch  # noqa: E402
from torch_threads import CountOps, one_torch_thread  # noqa: E402,F401

WARP = 983 * 16 / 65536.0
KW = dict(nb_subfr=NB_SUBFR, sub=SUB, M=M)


def to_torch(params, state, del_dec=False):
    """The reference's batch as the port's NamedTuples on the CPU."""
    p = tnsq.NsqParams(*(torch.from_numpy(np.array(v)) for v in params))
    return p, convert.nsq_state_from_numpy(
        [np.asarray(v) for v in state], "cpu", del_dec=del_dec)


def shares(pulses, other):
    return [float((a == b).mean()) for a, b in zip(pulses, other)]


@pytest.fixture(scope="module")
def calls_by_rate():
    return {rate: harvest(rate) for rate in (24000, 12000)}


@pytest.fixture(scope="module")
def dd_calls():
    return harvest_dd(24000)


@pytest.mark.parametrize("bitrate", [24000, 12000])
def test_nsq_vs_host_and_jax(calls_by_rate, bitrate):
    calls = calls_by_rate[bitrate]
    assert len(calls) >= 8
    jp, js = jax_batch(calls)
    params, state = to_torch(jp, js)
    pulses, xq, new_state = tnsq.nsq_frame(params, state, **KW)
    assert pulses.dtype == torch.int32 and pulses.shape == (len(calls), L)
    assert xq.shape == (len(calls), L)
    pulses = pulses.numpy()
    host = [np.asarray(c[4], np.int32) for c in calls]
    agree = shares(pulses, host)
    assert min(agree) >= 0.985, agree
    assert float(np.mean(agree)) >= 0.995, agree

    jpulses, jxq, jstate = jnsq.nsq_frame(jp, js, **KW)
    vs_jax = shares(pulses, np.asarray(jpulses))
    print(f"{bitrate}: lanes exactly equal to JAX "
          f"{sum(f == 1.0 for f in vs_jax)}/{len(vs_jax)}, "
          f"mean share {np.mean(vs_jax):.4f}")
    assert min(vs_jax) >= 0.985, vs_jax
    assert float(np.mean(vs_jax)) >= 0.995, vs_jax
    # where a lane's pulses are all equal, its output and state agree
    for s, share in enumerate(vs_jax):
        if share == 1.0:
            np.testing.assert_allclose(xq[s].numpy(), np.asarray(jxq)[s],
                                       rtol=0, atol=2e-2)
            for got, want in zip(new_state, jstate):
                want = np.asarray(want)[s]
                np.testing.assert_allclose(
                    got[s].numpy(), want, rtol=0,
                    atol=1e-4 * max(1.0, float(np.abs(want).max())))


def test_nsq_state_chain(calls_by_rate):
    """Frames chained through the port's own state follow the host's chain
    (and the reference's)."""
    calls = harvest(24000, n_frames=10, seed=3)
    _, js0 = jax_batch(calls[:1])
    _, st = to_torch(*jax_batch(calls[:1]))
    jst = js0
    worst = worst_jax = 1.0
    for call in calls[:6]:
        jp, _ = jax_batch([call])
        params, _ = to_torch(jp, js0)
        pulses, _, st = tnsq.nsq_frame(params, st, **KW)
        jpulses, _, jst = jnsq.nsq_frame(jp, jst, **KW)
        worst = min(worst, shares(pulses.numpy(),
                                  [np.asarray(call[4], np.int32)])[0])
        worst_jax = min(worst_jax, shares(pulses.numpy(),
                                          np.asarray(jpulses))[0])
    assert worst >= 0.97, worst
    assert worst_jax >= 0.97, worst_jax
    assert st.lag_prev.dtype == torch.int32


def test_nsq_del_dec_vs_host_and_jax(dd_calls):
    calls = dd_calls
    assert len(calls) >= 8
    jp, js = jax_batch([c[:5] for c in calls])
    js = jnsq.NsqDelDecState(*js)
    params, state = to_torch(jp, js, del_dec=True)
    pulses, seed_used, new_state = tnsq.nsq_del_dec_frame(
        params, state, **KW, n_states=4, warping=WARP)
    assert pulses.dtype == torch.int32 and seed_used.dtype == torch.int32
    assert isinstance(new_state, tnsq.NsqDelDecState)
    pulses = pulses.numpy()
    host = [np.asarray(c[4], np.int32) for c in calls]

    def held(other, what):
        agree = shares(pulses, other)
        assert float(np.mean(agree)) >= 0.9, (what, agree)
        assert sum(f == 1.0 for f in agree) >= len(agree) // 2, (what, agree)
        for s, o in enumerate(other):
            ratio = (float(np.sum(pulses[s].astype(np.float64) ** 2)) + 1.0) \
                / (float(np.sum(np.asarray(o, np.float64) ** 2)) + 1.0)
            assert 0.5 < ratio < 2.0, (what, s, ratio, agree[s])
        return agree

    held(host, "host")
    jpulses, jseed, jstate = jnsq.nsq_del_dec_frame(
        jp, js, **KW, n_states=4, warping=WARP)
    vs_jax = held(np.asarray(jpulses), "jax")
    print(f"del-dec: lanes exactly equal to JAX "
          f"{sum(f == 1.0 for f in vs_jax)}/{len(vs_jax)}, "
          f"mean share {np.mean(vs_jax):.4f}")
    for s, share in enumerate(vs_jax):
        if share == 1.0:
            assert int(seed_used[s]) == int(np.asarray(jseed)[s])
            for got, want in zip(new_state, jstate):
                want = np.asarray(want)[s]
                np.testing.assert_allclose(
                    got[s].numpy(), want, rtol=0,
                    atol=1e-3 * max(1.0, float(np.abs(want).max())))


def test_lanes_are_independent(calls_by_rate, dd_calls):
    """A stream's pulses do not depend on its batch: each quantizer on a
    batch equals the same lanes run alone, exactly."""
    jp, js = jax_batch(calls_by_rate[24000][:5])
    params, state = to_torch(jp, js)
    batched, _, _ = tnsq.nsq_frame(params, state, **KW)
    for s in (0, 3):
        solo, _, _ = tnsq.nsq_frame(
            tnsq.NsqParams(*(v[s:s + 1] for v in params)),
            tnsq.NsqDevState(*(v[s:s + 1] for v in state)), **KW)
        assert torch.equal(solo[0], batched[s])
    jp, js = jax_batch([c[:5] for c in dd_calls[:5]])
    params, state = to_torch(jp, js, del_dec=True)
    batched, seeds, _ = tnsq.nsq_del_dec_frame(params, state, **KW,
                                               warping=WARP)
    for s in (1, 4):
        solo, seed, _ = tnsq.nsq_del_dec_frame(
            tnsq.NsqParams(*(v[s:s + 1] for v in params)),
            tnsq.NsqDelDecState(*(v[s:s + 1] for v in state)), **KW,
            warping=WARP)
        assert torch.equal(solo[0], batched[s])
        assert int(seed[0]) == int(seeds[s])


def test_ops_a_sample(calls_by_rate, dd_calls):
    """The quantizers' cost is their sample loops: the ops a frame, printed
    (an upper bound on the launches a frame on a GPU) and held under a
    ceiling a sample."""
    jp, js = jax_batch(calls_by_rate[24000][:2])
    with CountOps() as ops:
        tnsq.nsq_frame(*to_torch(jp, js), **KW)
    single = ops.n
    jp, js = jax_batch([c[:5] for c in dd_calls[:2]])
    with CountOps() as ops:
        tnsq.nsq_del_dec_frame(*to_torch(jp, js, del_dec=True), **KW,
                               warping=WARP)
    print(f"non-view ops a frame: nsq_frame {single}, "
          f"nsq_del_dec_frame {ops.n}")
    assert single < 110 * L and ops.n < 160 * L, (single, ops.n)


def test_lcg_wraps_as_int32():
    edge = np.array([0, 1, -1, 2 ** 31 - 1, -2 ** 31, 2 ** 31 - 2,
                     -2 ** 31 + 1, 123456789, -987654321, 11, 10],
                    np.int64)
    want = ((edge * tnsq.RAND_MULTIPLIER + tnsq.RAND_INCREMENT + 2 ** 31)
            % 2 ** 32 - 2 ** 31).astype(np.int32)
    seed = torch.from_numpy(edge.astype(np.int32))
    got = tnsq._silk_rand(seed)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnsq._silk_rand(jnp.asarray(
            edge.astype(np.int32)))))
    # the pulse that is added afterwards wraps too
    top = torch.tensor([2 ** 31 - 1, -2 ** 31], dtype=torch.int32)
    bump = top + torch.tensor([5, -7], dtype=torch.int32)
    np.testing.assert_array_equal(
        bump.numpy(), np.array([-2 ** 31 + 4, 2 ** 31 - 7], np.int32))
    # twenty steps in a row follow the int64 recurrence folded to 32 bits
    s, ref = torch.tensor([3], dtype=torch.int32), 3
    for _ in range(20):
        s = tnsq._silk_rand(s)
        ref = (ref * tnsq.RAND_MULTIPLIER + tnsq.RAND_INCREMENT + 2 ** 31) \
            % 2 ** 32 - 2 ** 31
        assert int(s[0]) == ref


def test_zero_warping_and_first_sample_tie(dd_calls):
    """warping = 0 needs 0^0 = 1 (a plain delay line), and at the first
    sample all four states tie: the lowest index wins, as in the
    reference."""
    S = len(dd_calls)       # the reference's compiled shape is reused
    rng = np.random.default_rng(8)
    z = np.zeros
    P = dict(x=(rng.standard_normal((S, L)) * 500).astype(np.float32),
             a=z((S, 2, 16), np.float32), b=z((S, NB_SUBFR, 5), np.float32),
             ar_shp=(rng.standard_normal((S, NB_SUBFR, 24)) * 0.02)
             .astype(np.float32),
             harm=z((S, NB_SUBFR), np.float32),
             tilt=z((S, NB_SUBFR), np.float32),
             lf_ma=z((S, NB_SUBFR), np.float32),
             lf_ar=z((S, NB_SUBFR), np.float32),
             gains=np.full((S, NB_SUBFR), 40.0, np.float32),
             pitch_l=np.full((S, NB_SUBFR), 64, np.int32),
             lam=np.full(S, 1.5, np.float32), offset=np.full(S, 0.1,
                                                             np.float32),
             voiced=z(S, bool), seed=np.arange(S, dtype=np.int32),
             ltp_scale=np.ones(S, np.float32), interp=z(S, bool))
    params = tnsq.NsqParams(**{k: torch.from_numpy(v) for k, v in P.items()})
    state = tnsq.init_nsq_dd_state(S, M, device="cpu")
    pulses, seed_used, _ = tnsq.nsq_del_dec_frame(params, state, **KW,
                                                  warping=0.0)
    assert bool(torch.isfinite(pulses.float()).all())
    jpulses, jseed, _ = jnsq.nsq_del_dec_frame(
        jnsq.NsqParams(**{k: jnp.asarray(v) for k, v in P.items()}),
        jnsq.init_nsq_dd_state(S, M), **KW, warping=0.0)
    agree = shares(pulses.numpy(), np.asarray(jpulses))
    assert min(agree) >= 0.9, agree
    assert torch.argmin(torch.zeros(3, 4), dim=1).tolist() == [0, 0, 0]
    assert torch.argmax(torch.zeros(3, 4), dim=1).tolist() == [0, 0, 0]


def test_nsq_state_round_trip():
    st = tnsq.init_nsq_state(3, M, device="cpu")
    back = convert.nsq_state_to_numpy(st)
    assert isinstance(back, tnsq.NsqDevState)
    again = convert.nsq_state_from_numpy(back, "cpu")
    for a, b in zip(st, again):
        assert a.dtype == b.dtype and torch.equal(a, b)
    dd = convert.nsq_state_from_numpy(jnsq.init_nsq_dd_state(3, M), "cpu",
                                      del_dec=True)
    assert isinstance(dd, tnsq.NsqDelDecState)
    assert dd.lag_prev.dtype == torch.int32 and dd.xq.shape == (3, M)
