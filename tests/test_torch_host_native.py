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
