"""The synthesis postfilter's comb filter (mousiki_tpu_torch.ops.synthesis.
comb_filter_batched and its plain version) against the JAX reference,
mousiki_tpu.ops.synthesis_jax.comb_filter_batched, on the CPU.

Seeded rows cover periods from 15 to the longest the decoder sends
(1022), tapsets 0-2, the case where the old and new filters are the same
(no blend), g1 = 0 (the filter stops after the blend), g0 = g1 = 0 (the
row left as it is), and both calls a frame makes at N = 120, 240, 480
and 960. Bar: 1e-6 of the row's peak magnitude (the port sums a sample's
ten taps in another order than the reference). The kernel runs only on a
GPU: a `cuda` test holds it to the plain version there (4 float32 ulps of
the row's peak, the bar of chip_smoke.py phase 3c). The kernel's chunk
is a row's shortest lag, min(t0, t1) - 2, where the plain version's is
13: a numpy model of the kernel's float32 arithmetic shows on seeded
rows that both chunks give the same bits, and that a chunk one sample
longer does not. The JAX package is imported inside the test that
compares with it, so that the file imports where JAX is not (the GPU
machine runs the `cuda` test: pytest -m cuda).
"""

import numpy as np
import pytest
import torch

from comb_cases import EDGE_ROWS, ROW_LEN, comb_calls, comb_rows
from mousiki_tpu_torch.ops import synthesis
from torch_threads import one_torch_thread  # noqa: F401

S = 12
TOL = 1e-6
ULPS = 4


def _torch_args(d, device="cpu"):
    return {k: torch.as_tensor(v, device=device) for k, v in d.items()}


@pytest.mark.parametrize("n", [120, 240, 480, 960])
def test_reference_matches_jax(n):
    import jax.numpy as jnp
    from mousiki_tpu.ops import synthesis_jax
    rng = np.random.default_rng(n)
    jc = synthesis_jax.make_consts(n=n)
    tc = synthesis.make_consts(n, "cpu")
    for pos, N in comb_calls(n):
        d = comb_rows(rng, S)
        t = _torch_args(d)
        got = synthesis.comb_filter_batched_reference(
            tc, t["buf"].clone(), pos, N, t["t0"], t["t1"], t["g0"],
            t["g1"], t["tap0"], t["tap1"]).numpy()
        want = np.asarray(synthesis_jax.comb_filter_batched(
            jc, jnp.asarray(d["buf"]), pos, N, *(jnp.asarray(d[k]) for k in
                                                 ("t0", "t1", "g0", "g1",
                                                  "tap0", "tap1"))))
        peak = np.abs(want).max(axis=2, keepdims=True)
        assert (np.abs(got - want) <= TOL * peak).all(), (n, pos, N)
        # outside [pos, pos + N), and in the rows the filter skips, the
        # memory is untouched
        np.testing.assert_array_equal(got[..., :pos], d["buf"][..., :pos])
        np.testing.assert_array_equal(got[..., pos + N:],
                                      d["buf"][..., pos + N:])
        np.testing.assert_array_equal(got[3], d["buf"][3])
        # g1 = 0: the filter stops after the blend region
        stop = pos + min(synthesis.OVERLAP, N)
        np.testing.assert_array_equal(got[2, :, stop:], d["buf"][2, :, stop:])
        assert not np.array_equal(got[0], d["buf"][0])


def test_dispatcher_takes_plain_version_on_cpu_and_refuses_bad_input():
    rng = np.random.default_rng(5)
    tc = synthesis.make_consts(960, "cpu")
    t = _torch_args(comb_rows(rng, S))
    args = [t[k] for k in ("t0", "t1", "g0", "g1", "tap0", "tap1")]
    pos, N = comb_calls(960)[1]
    synthesis.reset_launches()
    got = synthesis.comb_filter_batched(tc, t["buf"].clone(), pos, N, *args)
    want = synthesis.comb_filter_batched_reference(tc, t["buf"].clone(), pos,
                                                   N, *args)
    assert torch.equal(got, want)
    assert synthesis.comb_filter_launches == 0

    buf = t["buf"]
    with pytest.raises(TypeError, match="buf must be"):
        synthesis.comb_filter_batched(tc, buf.double(), pos, N, *args)
    with pytest.raises(TypeError, match="t0 must be torch.int32"):
        synthesis.comb_filter_batched(tc, buf, pos, N, args[0].long(),
                                      *args[1:])
    with pytest.raises(TypeError, match="g1 must be torch.float32"):
        synthesis.comb_filter_batched(tc, buf, pos, N, *args[:3],
                                      args[3].double(), *args[4:])
    with pytest.raises(ValueError, match="bad shape of tap1"):
        synthesis.comb_filter_batched(tc, buf, pos, N, *args[:5],
                                      args[5][:-1])
    with pytest.raises(ValueError, match="not inside a row"):
        synthesis.comb_filter_batched(tc, buf, ROW_LEN - 10, N, *args)
    # the plain version takes any layout; the kernel needs a contiguous
    # buf (checked on the CUDA route), its (S,) planes may be strided
    strided = buf.transpose(0, 1).contiguous().transpose(0, 1)
    assert torch.equal(synthesis.comb_filter_batched(tc, strided.clone(),
                                                     pos, N, *args), want)
    cols = [torch.stack([a, a], dim=1)[:, 0] for a in args]
    assert not cols[0].is_contiguous()
    assert torch.equal(synthesis.comb_filter_batched(tc, buf.clone(), pos, N,
                                                     *cols), want)
    synthesis._check_comb_kernel(tc, buf)
    with pytest.raises(ValueError, match="contiguous"):
        synthesis._check_comb_kernel(tc, strided)
    with pytest.raises(ValueError, match="cpu or cuda, not meta"):
        synthesis.comb_filter_batched(tc, buf.to("meta"), pos, N, *args)


TAP_COL = (0, 1, 1, 2, 2)
TAP_OFF = (0, 1, -1, 2, -2)


def _comb_model(d, consts, pos, N, chunk_of):
    """csrc/comb_filter.cu's arithmetic in numpy float32, one rounding an
    operation: each weight (1 - f) * (c * g0) or f * (c * g1), each tap
    times its weight, the ten products summed in order, then + x; a
    row's samples in chunks of chunk_of(t0, t1), each chunk's taps read
    before its samples are written. Returns the decode memory."""
    f32 = np.float32
    buf = d["buf"].copy()
    window = consts.window.numpy()
    gains = consts.comb_gains.numpy()
    wsq = window * window
    for s in range(buf.shape[0]):
        g0, g1 = d["g0"][s], d["g1"][s]
        if g0 == 0 and g1 == 0:
            continue
        t0, t1, tap0, tap1 = (int(d[k][s]) for k in ("t0", "t1", "tap0",
                                                     "tap1"))
        same = g0 == g1 and t0 == t1 and tap0 == tap1
        ov = 0 if same else synthesis.OVERLAP
        n_on = N if g1 != 0 else min(N, ov)
        tg = ([gains[tap0, c] * g0 for c in TAP_COL]
              + [gains[tap1, c] * g1 for c in TAP_COL])
        lags = [t0 - o for o in TAP_OFF] + [t1 - o for o in TAP_OFF]
        step = chunk_of(t0, t1)
        row = buf[s]
        for c0 in range(0, n_on, step):
            rel = np.arange(c0, min(c0 + step, n_on))
            f = np.where(rel < ov, wsq[np.minimum(rel, ov - 1)], f32(1))
            omf = f32(1) - f
            acc = np.zeros((row.shape[0], rel.size), f32)
            for k in range(10):
                w = (omf if k < 5 else f) * tg[k]
                acc = acc + row[:, pos + rel - lags[k]] * w
            row[:, pos + rel] = row[:, pos + rel] + acc
    return buf


def test_chunk_of_the_shortest_lag_gives_the_same_bits():
    """On seeded rows whose periods are raised to at least 34, chunks of
    each row's min(t0, t1) - 2 (and of the kernel's own: that, at most
    the 128 lanes of a row) give the bits of chunks of 13; one sample
    longer does not. The model at 13 is within 4 ulps of each row's peak
    of the plain version."""
    rng = np.random.default_rng(15)
    tc = synthesis.make_consts(960, "cpu")
    for pos, N in comb_calls(960):
        d = comb_rows(rng, S)
        for key in ("t0", "t1"):
            d[key] = np.maximum(d[key], 34).astype(np.int32)
        assert (np.minimum(d["t0"], d["t1"])[6:12] == [
            max(min(a, b), 34) for a, b in EDGE_ROWS.values()]).all()
        base = _comb_model(d, tc, pos, N, lambda a, b: 13)
        for name, chunk_of in (
                ("shortest lag", lambda a, b: min(a, b) - 2),
                ("kernel", lambda a, b: min(min(a, b) - 2, 128))):
            np.testing.assert_array_equal(
                _comb_model(d, tc, pos, N, chunk_of), base, err_msg=name)
        longer = _comb_model(d, tc, pos, N, lambda a, b: min(a, b) - 1)
        assert not np.array_equal(longer, base)
        t = _torch_args(d)
        want = synthesis.comb_filter_batched_reference(
            tc, t["buf"].clone(), pos, N,
            *(t[k] for k in synthesis.COMB_PLANES)).numpy()
        peak = np.abs(want).max(axis=2, keepdims=True)
        assert (np.abs(base - want) <= ULPS * 2.0 ** -23 * peak).all()


@pytest.mark.cuda
def test_comb_filter_kernel_matches_plain_version_on_gpu():
    """The kernel on the card against the plain version on the same card,
    both calls of every frame size: within 4 float32 ulps of each row's
    peak, rows the filter skips bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    rng = np.random.default_rng(9)
    for n in (120, 240, 480, 960):
        tc = synthesis.make_consts(n, "cuda")
        for pos, N in comb_calls(n):
            t = _torch_args(comb_rows(rng, 64), "cuda")
            args = [t[k] for k in ("t0", "t1", "g0", "g1", "tap0", "tap1")]
            want = synthesis.comb_filter_batched_reference(
                tc, t["buf"].clone(), pos, N, *args)
            before = synthesis.comb_filter_launches
            got = synthesis.comb_filter_batched(tc, t["buf"].clone(), pos, N,
                                                *args)
            # the planes as columns of a wider plane, as the host's are
            cols = [torch.stack([a, a], dim=1)[:, 0] for a in args]
            strided = synthesis.comb_filter_batched(tc, t["buf"].clone(), pos,
                                                    N, *cols)
            torch.cuda.synchronize()
            assert synthesis.comb_filter_launches == before + 2
            assert torch.equal(strided, got)
            peak = want.abs().amax(dim=2, keepdim=True)
            assert ((got - want).abs() <= ULPS * 2.0 ** -23 * peak).all()
            assert torch.equal(got[3], t["buf"][3])
