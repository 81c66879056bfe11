"""The port's own copies of the native SILK and mixed host stages
(mousiki_tpu_torch.silk.host_native / opus_host_native, built from
mousiki_tpu_torch/csrc/) against the JAX package's (built from native/)
on the committed golden packets.

Bar: every output equal bit for bit (plan arenas, SILK pcm, mode tags,
rates, return codes, SILK frame parameters), with packet loss and with
silk_params=True; and the plan profile set through the port reaches both
of the port's libraries that carry the plan writer, and none of the JAX
package's.
"""

import numpy as np
import pytest

from golden_streams import frame_batch, load_mono_mix, load_stereo_celt
from mousiki_tpu import opus_host_native as jax_opus_native
from mousiki_tpu.celt import host_native as jax_celt_native
from mousiki_tpu.silk import host_native as jax_silk_native
from mousiki_tpu_torch import opus_host_native
from mousiki_tpu_torch.celt import host_native as celt_native
from mousiki_tpu_torch.pipeline import SERVING_PROFILE
from mousiki_tpu_torch.silk import host_native as silk_native
from torch_threads import one_torch_thread  # noqa: F401

F = 12


@pytest.fixture(scope="module")
def mono():
    return load_mono_mix()


def _assert_decodes_equal(got, want, tag):
    arenas, aux, layout, silk16, modes, silk_fs, silk_stereo = got[:7]
    w_arenas, w_aux, w_layout, w_silk16, w_modes, w_fs, w_stereo = want[:7]
    assert layout == w_layout
    np.testing.assert_array_equal(arenas["backing"], w_arenas["backing"],
                                  err_msg=f"arena {tag}")
    for key in ("rcs", "x_direct", "band_log_e", "pf_gain"):
        np.testing.assert_array_equal(aux[key], w_aux[key],
                                      err_msg=f"{key} {tag}")
    np.testing.assert_array_equal(silk16, w_silk16, err_msg=f"silk16 {tag}")
    np.testing.assert_array_equal(modes, w_modes, err_msg=f"modes {tag}")
    np.testing.assert_array_equal(silk_fs, w_fs, err_msg=f"fs {tag}")
    np.testing.assert_array_equal(silk_stereo, w_stereo)
    if len(got) > 7:
        for a, b in zip(got[7], want[7]):
            np.testing.assert_array_equal(a, b, err_msg=f"params {tag}")


@pytest.mark.parametrize("silk_params", [False, True],
                         ids=["pcm", "silk_params"])
def test_opus_host_bit_equal_to_jax(mono, silk_params):
    """The five mono streams with loss (one stream offered its next packet
    for FEC), and a SKIP tick."""
    S = 5
    port = opus_host_native.NativeOpusHostBatch(S, 1)
    ref = jax_opus_native.NativeOpusHostBatch(S, 1)
    lost = np.zeros((S, F), bool)
    if not silk_params:
        lost[0, 5:7] = lost[1, 4] = lost[3, 8] = lost[2, 9] = True
    modes_seen = set()
    for f in range(F):
        batch = frame_batch(mono, S, f, lost[:, f], packets=True)
        want_batch = list(batch)
        fec = None
        if lost[1, f]:
            fec = [None] * S
            fec[1] = mono[1].packets[f + 1]
        if f == 10:                 # a feeder tick: neither decode nor conceal
            batch[4] = opus_host_native.SKIP
            want_batch[4] = jax_opus_native.SKIP
        got = port.decode(batch, 960, fec, silk_params=silk_params)
        want = ref.decode(want_batch, 960, fec, silk_params=silk_params)
        assert (got[1]["rcs"] >= 0).all()
        _assert_decodes_equal(got, want, f"frame {f}")
        modes_seen |= set(int(m) for m in got[4])
    assert modes_seen >= ({0, 1, 2, 5} if silk_params else {0, 1, 2, 3})


def test_opus_host_stereo_bit_equal_to_jax(mono):
    stereo = load_stereo_celt()
    S = 5
    port = opus_host_native.NativeOpusHostBatch(S, 2)
    ref = jax_opus_native.NativeOpusHostBatch(S, 2)
    for f in range(F):
        batch = frame_batch(stereo, 3, f, packets=True) \
            + [mono[1].packets[f], mono[4].packets[f]]
        if f == 7:
            batch[0] = batch[3] = None
        got = port.decode(batch, 960)
        _assert_decodes_equal(got, ref.decode(batch, 960), f"frame {f}")
        assert got[3].shape == (S, 640)


def test_decode_silk_frames_equal_to_jax(mono):
    port = opus_host_native.NativeOpusHostBatch(2, 1)
    ref = jax_opus_native.NativeOpusHostBatch(2, 1)
    for f in range(4):
        for s, (stream, khz) in enumerate(((mono[1], 16), (mono[2], 8))):
            got = port.decode_silk_frames(s, stream.payloads[f], khz, 20)
            want = ref.decode_silk_frames(s, stream.payloads[f], khz, 20)
            assert got.shape == (20 * khz,) and got.dtype == np.int16
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("khz,index", [(16, 1), (8, 2)])
def test_silk_host_bit_equal_to_jax(mono, khz, index):
    """NativeSilkHost: decode, decode_symbols and the concealment."""
    payloads = mono[index].payloads
    port, ref = silk_native.NativeSilkHost(), jax_silk_native.NativeSilkHost()
    port_sym = silk_native.NativeSilkHost()
    ref_sym = jax_silk_native.NativeSilkHost()
    for f in range(F):
        if f == 6:
            got, want = port.plc(), ref.plc()
            assert got.shape == (20 * khz,)
        else:
            got = port.decode(payloads[f], khz, 20)
            want = ref.decode(payloads[f], khz, 20)
        np.testing.assert_array_equal(got, want, err_msg=str(f))
        assert port.rng == ref.rng
        a = port_sym.decode_symbols(payloads[f], khz)
        b = ref_sym.decode_symbols(payloads[f], khz)
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key],
                                          err_msg=f"{key} frame {f}")
    port.reset()
    ref.reset()
    np.testing.assert_array_equal(port.decode(payloads[0], khz, 20),
                                  ref.decode(payloads[0], khz, 20))


def test_plan_profile_reaches_both_port_libraries(mono):
    """The profile set through the port changes the arena layout that the
    port's libopus_host AND libcelt_host write (each has its own copy of
    the capacity globals), the decoded output stays what the JAX
    package's library gives under the same profile, and the JAX package's
    profile is untouched by the port's."""
    S = 5
    full_jax = jax_celt_native.get_plan_profile()
    opus_host_native._load()
    celt_native._load()
    celt_native.set_plan_profile(*SERVING_PROFILE)
    try:
        assert len(celt_native._profile_libs()) == 2
        assert jax_celt_native.get_plan_profile() == full_jax
        port = opus_host_native.NativeOpusHostBatch(S, 1)
        celt = celt_native.NativeCeltHostBatch(1, channels=1)
        jax_celt_native.set_plan_profile(*SERVING_PROFILE)
        ref = jax_opus_native.NativeOpusHostBatch(S, 1)
        ref_celt = jax_celt_native.NativeCeltHostBatch(1, channels=1)
        for f in range(4):
            batch = frame_batch(mono, S, f, packets=True)
            got = port.decode(batch, 960)
            _assert_decodes_equal(got, ref.decode(batch, 960), f"frame {f}")
            arenas, _, layout = celt.decode_plan_arenas(
                [mono[0].payloads[f]], 960)
            w_arenas, _, _ = ref_celt.decode_plan_arenas(
                [mono[0].payloads[f]], 960)
            np.testing.assert_array_equal(arenas["backing"],
                                          w_arenas["backing"])
        assert got[2]["pvq_rec"][2] == (S, sum(SERVING_PROFILE[0]), 3)
        assert layout["pvq_rec"][2] == (1, sum(SERVING_PROFILE[0]), 3)
    finally:
        celt_native.set_plan_profile()
        jax_celt_native.set_plan_profile()
    assert celt_native.get_plan_profile() == full_jax
