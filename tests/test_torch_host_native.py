"""The port's own copy of the native host symbol stage
(mousiki_tpu_torch.celt.host_native, built from csrc/celt_host.cpp)
against the JAX package's (mousiki_tpu.celt.host_native, built from
native/celt_host.cpp) on the committed golden stereo packets at S = 3.

Bar: the packed plan arenas equal bit for bit, and the native side
outputs (return codes, direct-decoder spectra, band energies) equal,
under the serving profile and under the full one.
"""

import numpy as np
import pytest

from golden_streams import frame_batch, load_stereo_celt
from mousiki_tpu.celt import host_native as jax_host_native
from mousiki_tpu_torch.celt import host_native
from mousiki_tpu_torch.pipeline import SERVING_PROFILE
from torch_threads import one_torch_thread  # noqa: F401

S = 3
FRAME = 960


@pytest.fixture(params=["serving", "full"])
def profile(request):
    """The profile in both libraries (each keeps its own); both restored
    to the full profile afterwards."""
    prof = SERVING_PROFILE if request.param == "serving" else (None,) * 3
    host_native.set_plan_profile(*prof)
    jax_host_native.set_plan_profile(*prof)
    try:
        yield prof
    finally:
        host_native.set_plan_profile()
        jax_host_native.set_plan_profile()


def test_decode_plan_arenas_bit_equal_to_jax(profile):
    streams = load_stereo_celt()
    port = host_native.NativeCeltHostBatch(S)
    ref = jax_host_native.NativeCeltHostBatch(S)
    lost = np.zeros((S, 12), bool)
    lost[1, 5:7] = True                      # a 2-frame burst
    for f in range(12):
        batch = frame_batch(streams, S, f, lost[:, f])
        arenas, aux, layout = port.decode_plan_arenas(batch, FRAME)
        want_arenas, want_aux, want_layout = ref.decode_plan_arenas(batch,
                                                                    FRAME)
        assert layout == want_layout
        assert (aux["rcs"] >= 0).all()
        np.testing.assert_array_equal(arenas["backing"],
                                      want_arenas["backing"], err_msg=str(f))
        for key in ("rcs", "x_direct", "band_log_e", "pf_gain"):
            np.testing.assert_array_equal(aux[key], want_aux[key],
                                          err_msg=f"{key} frame {f}")
    # the arenas were laid out for the profile under test
    slots = SERVING_PROFILE[0] if profile == SERVING_PROFILE else (224, 48, 16)
    assert layout["pvq_rec"][2] == (S, sum(slots), 3)


def test_plan_profiles_are_separate():
    """Setting the port's profile leaves the JAX package's as it was."""
    full = jax_host_native.get_plan_profile()
    host_native.set_plan_profile(*SERVING_PROFILE)
    try:
        assert host_native.get_plan_profile() == ((144, 40, 6), 2, 8)
        assert jax_host_native.get_plan_profile() == full
    finally:
        host_native.set_plan_profile()
    assert host_native.get_plan_profile() == full


def test_non_plan_decode_bit_equal_to_jax():
    streams = load_stereo_celt()
    port = host_native.NativeCeltHostBatch(S, n_threads=2)
    ref = jax_host_native.NativeCeltHostBatch(S)
    for f in range(6):
        batch = frame_batch(streams, S, f)
        got = port.decode(batch, FRAME)
        want = ref.decode(batch, FRAME)
        assert (got[4] >= 0).all()
        for name, a, b in zip(("x", "band_log_e", "iflags", "pf_gains",
                               "rcs"), got, want):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=f"{name} frame {f}")
    with pytest.raises(ValueError, match="no loss concealment"):
        port.decode([None] + batch[1:], FRAME)
    with pytest.raises(ValueError, match="payloads for"):
        port.decode(batch[:2], FRAME)


def test_decode_plan_chunk_equals_stacked_arenas(profile):
    """K frames decoded into one (K, words) backing equal K single decodes,
    the per-frame loss flags included; and the backing comes from the
    allocator the batch was given."""
    streams = load_stereo_celt()
    K = 4
    lost = np.zeros((S, K), bool)
    lost[2, 1] = True
    frames = [frame_batch(streams, S, f, lost[:, f]) for f in range(K)]
    made = []

    def alloc(shape):
        made.append(np.zeros(shape, np.int32))
        return made[-1]

    chunked = host_native.NativeCeltHostBatch(S, arena_alloc=alloc)
    # a ring of K arenas: every frame lands in a zeroed arena, as a row of
    # the chunk backing does (a reused arena keeps stale, masked-off values)
    single = host_native.NativeCeltHostBatch(S)
    single.set_plan_buffers(K)
    backing2d, aux_list, any_direct, any_lost = chunked.decode_plan_chunk(
        frames, FRAME)
    assert backing2d is made[0] and backing2d.ndim == 2
    assert any_lost == [False, True, False, False]
    direct = False
    for k in range(K):
        arenas, aux, layout = single.decode_plan_arenas(frames[k], FRAME)
        np.testing.assert_array_equal(backing2d[k], arenas["backing"])
        np.testing.assert_array_equal(aux_list[k]["rcs"], aux["rcs"])
        np.testing.assert_array_equal(aux_list[k]["x_direct"],
                                      aux["x_direct"])
        direct |= bool(host_native.plane_of(arenas, layout, "direct").any())
    assert any_direct == direct


def test_plan_buffer_ring_gives_two_arenas():
    streams = load_stereo_celt()
    batch = host_native.NativeCeltHostBatch(S)
    batch.set_plan_buffers(2)
    a0, _, _ = batch.decode_plan_arenas(frame_batch(streams, S, 0), FRAME)
    first = a0["backing"].copy()
    a1, _, _ = batch.decode_plan_arenas(frame_batch(streams, S, 1), FRAME)
    assert a1["backing"] is not a0["backing"]
    np.testing.assert_array_equal(a0["backing"], first)   # left untouched
    a2, _, _ = batch.decode_plan_arenas(frame_batch(streams, S, 2), FRAME)
    assert a2["backing"] is a0["backing"]
    with pytest.raises(ValueError):
        batch.set_plan_buffers(0)


def test_plan_arenas_are_allocated_once():
    """The ring of two and the chunk backing come from the allocator once:
    going back to one buffer and on to two again, and a chunk shorter than
    one decoded before, allocate nothing."""
    streams = load_stereo_celt()
    made = []

    def alloc(shape):
        made.append(np.zeros(shape, np.int32))
        return made[-1]

    batch = host_native.NativeCeltHostBatch(S, arena_alloc=alloc)
    frames = [frame_batch(streams, S, f) for f in range(4)]
    for n in (1, 2, 1, 2):
        batch.set_plan_buffers(n)
        used = [batch.decode_plan_arenas(frames[k], FRAME)[0]["backing"]
                for k in range(2)]
        assert (used[0] is used[1]) == (n == 1)
        assert all(any(u is m for m in made[:n]) for u in used)
    assert len(made) == 2
    full, _, _, _ = batch.decode_plan_chunk(frames, FRAME)
    assert full is made[2] and full.shape[0] == 4
    tail, _, _, _ = batch.decode_plan_chunk(frames[:2], FRAME)
    assert tail.shape == (2, full.shape[1])
    assert np.shares_memory(tail, made[2]) and tail.flags.c_contiguous
    assert len(made) == 3
