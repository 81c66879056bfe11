"""Port band-plan executor (mousiki_tpu_torch.ops.band_exec) vs the JAX
reference (mousiki_tpu.ops.band_exec_jax) on real plan arenas: the native
host stage decoding the committed golden stereo CELT packets at S = 3.

Bars: unpacked planes equal (integers and flags exactly, f32 planes bit
for bit); CWRS pulse vectors equal; the X plane within 1e-5 (the bar of
test_band_exec.py: f32 round-off on unit-norm spectra).
"""

import contextlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from golden_streams import frame_batch, load_stereo_celt
from mousiki_tpu.celt import host_native
from mousiki_tpu.ops import band_exec_jax
from mousiki_tpu_torch.ops import band_exec
from mousiki_tpu_torch.pipeline import SERVING_PROFILE, set_plan_profile
from torch_threads import one_torch_thread  # noqa: F401

S = 3
FRAME = 960
TOL = 1e-5
# tier capacities small enough that streams 0 and 2 of frame 0 overflow
# and fall back to the direct decoder
TIGHT_PROFILE = ((60, 20, 2), 2, 8)


@contextlib.contextmanager
def _profile(profile):
    """The profile in both host libraries: the arenas come from the JAX
    package's, the port unpacks them with its own layout."""
    set_plan_profile(*profile)
    host_native.set_plan_profile(*profile)
    try:
        yield
    finally:
        set_plan_profile()  # restore the full profile
        host_native.set_plan_profile()


def _arenas(frames):
    """Copies of (backing, x_direct) for the given frame indices."""
    streams = load_stereo_celt()
    batch = host_native.NativeCeltHostBatch(S)
    out = {}
    for f in range(max(frames) + 1):
        arenas, aux, _ = batch.decode_plan_arenas(frame_batch(streams, S, f),
                                                  FRAME)
        assert (aux["rcs"] >= 0).all()
        if f in frames:
            out[f] = (arenas["backing"].copy(), aux["x_direct"].copy())
    return out


def _jax_split(backing):
    n32, o16, n16, o8, n8, _ = host_native.arena_word_layout(S, 2, FRAME)
    a32 = jnp.asarray(backing[:n32])
    a16 = jnp.asarray(backing[o16:o16 + (n16 + 1) // 2].view(np.int16)[:n16])
    a8 = jnp.asarray(backing[o8:o8 + (n8 + 3) // 4].view(np.uint8)[:n8])
    return a32, a16, a8


def _unpack_both(backing):
    jp, jble, jpf, jif = jax.jit(partial(
        band_exec_jax.unpack_plan_arenas, channels=2, frame=FRAME))(
            *_jax_split(backing))
    tp, tble, tpf, tif = band_exec.unpack_plan_arenas(
        *band_exec.split_backing(torch.from_numpy(backing.copy()),
                                 channels=2, frame=FRAME, n_streams=S),
        channels=2, frame=FRAME)
    return (jp, jble, jpf, jif), (tp, tble, tpf, tif)


def _same(got, want, key):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, key
    if want.dtype == np.float32:
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32), err_msg=key)
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), err_msg=key)


def test_unpack_plan_arenas_matches_jax():
    with _profile(SERVING_PROFILE):
        backing, _ = _arenas([4])[4]
        (jp, *jrest), (tp, *trest) = _unpack_both(backing)
    assert set(tp) == set(jp)
    for key in jp:
        if isinstance(jp[key], list):
            for t, (g, w) in enumerate(zip(tp[key], jp[key])):
                _same(g, w, f"{key}[{t}]")
        else:
            _same(tp[key], jp[key], key)
    for g, w, key in zip(trest, jrest, ("ble", "pf_gain", "iflags")):
        _same(g, w, key)
    assert sum(int(a.sum()) for a in tp["pvq_active"]) > 100


def test_cwrs_walk_matches_jax():
    with _profile(SERVING_PROFILE):
        backing, _ = _arenas([4])[4]
        (jp, *_), (tp, *_) = _unpack_both(backing)
    jn = band_exec_jax._normalize_plan(jp)
    tn = band_exec._normalize_plan(tp)
    for t, (nmax, _) in enumerate(band_exec_jax.TIERS):
        want = np.asarray(jax.jit(band_exec_jax.cwrs_walk, static_argnums=4)(
            jn["pvq_active"][t].reshape(-1), jn["pvq_n"][t].reshape(-1),
            jn["pvq_k"][t].reshape(-1), jn["pvq_idx"][t].reshape(-1), nmax))
        got = band_exec.cwrs_walk(
            tn["pvq_active"][t].reshape(-1), tn["pvq_n"][t].reshape(-1),
            tn["pvq_k"][t].reshape(-1), tn["pvq_idx"][t].reshape(-1), nmax)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        # the walk resolves the pulse count of every active leaf
        act = tn["pvq_active"][t].reshape(-1)
        np.testing.assert_array_equal(
            got.abs().sum(dim=1)[act].numpy(),
            tn["pvq_k"][t].reshape(-1)[act].numpy())


def _execute_both(backing, x_direct):
    (jp, *_), (tp, *_) = _unpack_both(backing)
    want = np.asarray(band_exec_jax.execute_packed(
        jp, jnp.asarray(x_direct), channels=2, frame=FRAME, lm=3, start=0,
        end=21, mats=band_exec_jax.plan_combo_mats(2, FRAME)))
    got = band_exec.execute_packed(
        tp, torch.from_numpy(x_direct),
        band_exec.plan_combo_mats(2, FRAME, "cpu"), channels=2, frame=FRAME, lm=3, start=0, end=21)
    return tp, got.numpy(), want


def test_execute_packed_matches_jax():
    with _profile(SERVING_PROFILE):
        # frame 0 runs the anti-collapse, frame 11 has noise fills
        for f, (backing, x_direct) in _arenas([0, 11]).items():
            tp, got, want = _execute_both(backing, x_direct)
            assert not tp["direct"].any()
            assert np.abs(got - want).max() <= TOL, f


def test_execute_packed_direct_fallback():
    with _profile(TIGHT_PROFILE):
        backing, x_direct = _arenas([0])[0]
        tp, got, want = _execute_both(backing, x_direct)
    direct = tp["direct"].numpy().astype(bool)
    assert direct.tolist() == [True, False, True]
    # direct streams pass the host-decoded spectrum through unchanged
    np.testing.assert_array_equal(got[direct],
                                  x_direct[direct].reshape(2, -1))
    assert np.abs(got - want).max() <= TOL
