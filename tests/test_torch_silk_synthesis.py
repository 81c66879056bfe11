"""The port's device SILK synthesis (mousiki_tpu_torch.ops.silk_synthesis)
against the JAX package's (mousiki_tpu.ops.silk_synthesis_jax) and against
the bit-exact native host decoder, on the symbols that the port's native
stage decodes from the committed golden SILK packets.

Bars: 1e-4 * max|out| against the JAX step, output and state, on every
frame (voiced and unvoiced frames both occur, interpolation on and off is
forced); 5e-3 of full scale against the host synthesis, the reference's
own bar (tests/test_silk_synthesis_jax.py).
"""

import numpy as np
import pytest
import torch

from golden_streams import load_mono_mix
from mousiki_tpu.ops import silk_synthesis_jax
from mousiki_tpu_torch.ops import silk_synthesis
from mousiki_tpu_torch.silk.host_native import NativeSilkHost
from torch_threads import one_torch_thread  # noqa: F401

F = 12


@pytest.fixture(scope="module")
def golden_silk():
    mono = load_mono_mix()
    return {16: mono[1].payloads, 8: mono[2].payloads}


def _params(symbols, module, wrap, interp):
    """SilkFrameParams of `module` for S streams' decoded symbols."""
    def stack(key, dtype):
        return wrap(np.stack([np.asarray(d[key], dtype) for d in symbols]))

    return module.SilkFrameParams(
        exc=stack("exc", np.float32), a=stack("a", np.float32),
        b=stack("b", np.float32), pitch_l=stack("pitch_l", np.int32),
        gains=stack("gains", np.float32), voiced=stack("voiced", bool),
        ltp_scale=stack("ltp_scale", np.float32),
        interp=None if interp is None else wrap(np.asarray(interp)))


@pytest.mark.parametrize("khz", [16, 8])
def test_silk_synthesis_matches_jax_and_host(golden_silk, khz):
    """Stream 0 decodes the packets as they are; stream 1 has the
    interpolation flag inverted (so both branches run on real symbols; it
    is held to JAX only)."""
    payloads = golden_silk[khz]
    sym_hosts = [NativeSilkHost(), NativeSilkHost()]
    pcm_host = NativeSilkHost()
    want_state = silk_synthesis_jax.init_silk_state(2, khz)
    state = silk_synthesis.init_silk_state(2, khz, "cpu")
    sub = khz * 5
    voiced_seen = set()
    interp_seen = set()
    for f in range(F):
        symbols = [h.decode_symbols(payloads[f], khz) for h in sym_hosts]
        interp = [symbols[0]["interp"], not symbols[1]["interp"]]
        voiced_seen.add(symbols[0]["voiced"])
        interp_seen.update(interp)
        want, want_state = silk_synthesis_jax.silk_synthesis_step(
            _params(symbols, silk_synthesis_jax, np.asarray, interp),
            want_state, nb_subfr=4, subfr_len=sub)
        got, state = silk_synthesis.silk_synthesis_step(
            _params(symbols, silk_synthesis, torch.from_numpy, interp),
            state, nb_subfr=4, subfr_len=sub)
        want = np.asarray(want)
        assert got.shape == (2, 20 * khz) and got.dtype == torch.float32
        tol = 1e-4 * max(1.0, float(np.abs(want).max()))
        assert np.abs(got.numpy() - want).max() <= tol, (f, tol)
        for field, a, b in zip(state._fields, state, want_state):
            assert np.abs(a.numpy() - np.asarray(b)).max() <= tol, (f, field)
        host = pcm_host.decode(payloads[f], khz, 20).astype(np.float32)
        err = np.abs(got[0].numpy() - host).max() / 32768.0
        assert err < 5e-3, (f, err)
    if khz == 16:       # the narrow-band fixture has no voiced frame
        assert voiced_seen == {True, False}
    assert interp_seen == {True, False}


def test_silk_synthesis_without_interp_flag(golden_silk):
    """interp=None (no interpolated halves) equals an all-False flag."""
    payloads = golden_silk[16]
    host = NativeSilkHost()
    a = silk_synthesis.init_silk_state(1, 16, "cpu")
    b = silk_synthesis.init_silk_state(1, 16, "cpu")
    for f in range(3):
        symbols = [host.decode_symbols(payloads[f], 16)]
        out_a, a = silk_synthesis.silk_synthesis_step(
            _params(symbols, silk_synthesis, torch.from_numpy, None), a)
        out_b, b = silk_synthesis.silk_synthesis_step(
            _params(symbols, silk_synthesis, torch.from_numpy, [False]), b)
        assert torch.equal(out_a, out_b)
