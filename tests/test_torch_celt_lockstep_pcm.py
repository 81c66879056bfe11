"""The port's lockstep decoder against the JAX package's: its constants,
the pulse search's bounds, the PCM with the state carried over frames,
the caps' overflow against libopus, and (-m slow) one step against the
JAX package's compiled one (split from tests/test_torch_celt_lockstep.py,
which holds the golden walk's tests, so that the tier-1 suite's files
stay short).
"""

import numpy as np
import pytest
import torch

from golden_streams import load_mono_mix, load_stereo_celt
from mousiki_tpu.celt.decoder import CeltDecoder
from mousiki_tpu.celt.plan import execute_plan
from mousiki_tpu.ops import celt_lockstep as jls
from mousiki_tpu.ops import celt_lockstep_emit as jle
from mousiki_tpu.ops import celt_lockstep_top as jlt
from mousiki_tpu.ops import celt_lockstep_walk as jlw
from mousiki_tpu.testing import oracle
from mousiki_tpu_torch import convert
from mousiki_tpu_torch.ops import celt_lockstep as tls
from mousiki_tpu_torch.ops import celt_lockstep_emit as tle
from mousiki_tpu_torch.ops import celt_lockstep_top as tlt
from mousiki_tpu_torch.ops import celt_lockstep_walk as tlw
from mousiki_tpu_torch.ops import synthesis
from mousiki_tpu_torch.ops.band_exec import execute_packed, plan_combo_mats
from mousiki_tpu_torch.pipeline import CeltStreamPipeline
from test_torch_celt_lockstep import (FRAME, LM, WIDE_CAPS, _capture,
                                      _finish, _walk)
from torch_threads import one_torch_thread  # noqa: F401


def test_constants_equal_jax():
    for lm in range(4):
        for C in (1, 2):
            got, want = tls._tables(lm, C), jls._tables(lm, C)
            for field in want._fields:
                np.testing.assert_array_equal(getattr(got, field),
                                              getattr(want, field),
                                              err_msg=f"{field} {lm} {C}")
        got, want = tlw.walk_layout(lm), jlw.walk_layout(lm)
        for field in want._fields:
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field), err_msg=field)
        np.testing.assert_array_equal(tle._combo_lut(lm), jle._combo_lut(lm))
    for C in (1, 2):
        for got, want in zip(tle._tier_map(LM, C), jle._tier_map(LM, C)):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    assert tle.DEFAULT_CAPS == jle.DEFAULT_CAPS
    assert tlt.N_ITER_LM3 == jlt.N_ITER_LM3
    np.testing.assert_array_equal(tlw._EXP2_TABLE8, jlw._EXP2_TABLE8)
    np.testing.assert_array_equal(tle._BIT_INTERLEAVE, jle._BIT_INTERLEAVE)
    np.testing.assert_array_equal(tle._BIT_DEINTERLEAVE,
                                  jle._BIT_DEINTERLEAVE)
    for name in ("TRIM_ICDF", "SPREAD_ICDF", "TAPSET_ICDF",
                 "SMALL_ENERGY_ICDF", "TF_SELECT_TABLE", "PRED_COEF",
                 "BETA_COEF", "BETA_INTRA", "MAX_PSEUDO"):
        assert getattr(tls, name) == getattr(jls, name), name
    for name in ("DEPTH_MAX", "NPB", "KIND_TREE", "KIND_SBAND", "KIND_DBAND",
                 "PH_ENTER", "PH_MID", "PH_DONE"):
        assert getattr(tlw, name) == getattr(jlw, name), name
    assert (tle.FILL_SLOTS_LS, tle.SPREAD_AGGRESSIVE) == \
        (jle.FILL_SLOTS_LS, jle.SPREAD_AGGRESSIVE)


def test_pulse_search_and_lowering_bounds():
    """The fixed forms of bits2pulses' search and of the PVQ budget
    lowering (the JAX module's while_loop) rest on the cache tables: every
    row's K is at most MAX_PSEUDO (the lowering's bound) and the row is
    non-decreasing on 1..K (the search's closed form). Both forms equal the
    loops they replace on random budgets."""
    rng = np.random.default_rng(5)
    for lm in range(4):
        lay = tlw.walk_layout(lm)
        assert lay.s_ck.max() <= tls.MAX_PSEUDO
        for ck, row in zip(lay.s_ck, lay.s_cbits):
            assert (np.diff(row[1:ck + 1]) >= 0).all()
        n = 4096
        slot = rng.integers(0, lay.nslot, n)
        cb = lay.s_cbits[slot].astype(np.int64)
        ck = lay.s_ck[slot].astype(np.int64)
        bm1 = rng.integers(-8, cb.max() + 16, n)
        rem = rng.integers(-64, cb.max() + 16, n)
        q41 = torch.arange(tls.MAX_PSEUDO + 1)
        lo, hi = tlw._search_pulses(torch.as_tensor(cb), torch.as_tensor(ck),
                                    torch.as_tensor(bm1), q41)
        is_leaf = rng.integers(0, 2, n).astype(bool)
        q0 = rng.integers(0, ck + 1)
        q1, rem1 = tlw._lower_pulses(torch.as_tensor(is_leaf),
                                     torch.as_tensor(rem),
                                     torch.as_tensor(q0),
                                     torch.as_tensor(cb), q41)
        for i in range(n):
            lo_w, hi_w = 0, int(ck[i])
            for _ in range(6):
                mid = (lo_w + hi_w + 1) >> 1
                if cb[i, mid] >= bm1[i]:
                    hi_w = mid
                else:
                    lo_w = mid
            if ck[i] > 0:
                assert (lo[i], hi[i]) == (lo_w, hi_w), i
            q = int(q0[i])
            r = int(rem[i])
            if is_leaf[i]:
                r -= int(cb[i, q]) + 1 if q > 0 else 0
                while r < 0 and q > 0:
                    r += int(cb[i, q]) + 1
                    q -= 1
                    r -= int(cb[i, q]) + 1 if q > 0 else 0
            assert (q1[i], rem1[i]) == (q, r), i


@pytest.mark.parametrize("channels", [2, 1])
def test_pcm_carried_state(channels):
    """Four frames a stream, the state carried on the device: the JAX
    package's CeltDecoder, the golden PCM and the port's plan pipeline."""
    streams = load_stereo_celt() if channels == 2 else [load_mono_mix()[0]]
    S, F = len(streams), 4
    decs = [CeltDecoder(channels=channels, stream_channels=channels, end=21,
                        disable_inv=channels == 1) for _ in streams]
    pipe = CeltStreamPipeline(S, channels, use_plan=True, device="cpu")
    consts = synthesis.make_consts(FRAME, "cpu")
    sstate = synthesis.init_state(S, channels, "cpu")
    lstate = tlt.init_state(S, device="cpu")
    mats = plan_combo_mats(channels, FRAME, "cpu")
    for f in range(F):
        pays = [gs.payloads[f] for gs in streams]
        buf, storage = tlt.pad_payloads(pays, "cpu")
        pcm, sstate, lstate, ok = tlt.lockstep_synthesis_step(
            consts, sstate, lstate, buf, storage, mats, C=channels,
            frame=FRAME)
        assert bool(ok.all())
        got = pcm.numpy()
        assert got.shape == (S, FRAME, channels)
        via_pipe = pipe.step(pays, FRAME).numpy()
        for s, gs in enumerate(streams):
            truth = decs[s].decode_with_ec(pays[s], FRAME)
            golden = gs.pcm[f * FRAME:(f + 1) * FRAME]
            for ref, name in ((truth, "CeltDecoder"), (golden, "golden"),
                              (via_pipe[s], "pipeline")):
                err = float(np.abs(got[s] - ref).max())
                assert err < 2e-4, f"frame {f} stream {s}: {name} {err}"
    assert lstate.rng.dtype == torch.int64
    back = convert.lockstep_state_to_numpy(lstate)
    assert back.rng.dtype == np.uint32
    np.testing.assert_array_equal(back.rng, [d.rng for d in decs])


def test_caps_overflow_libopus():
    """320 kbit/s stereo overflows the default tier caps (ok False on
    those lanes) and fits (384, 112, 24), with the X plane still right."""
    if not oracle.available():
        pytest.skip("no system libopus to encode with")
    from mousiki_tpu.bitstream.packet import parse_packet
    enc = oracle.RefEncoder(48000, 2, oracle.APP_RESTRICTED_LOWDELAY)
    enc.ctl_set(oracle.SET_BITRATE, 320000)
    F = 4
    sig = oracle.make_test_signal(FRAME * (F + 1), 2, kind="mix", seed=3)
    pcm16 = oracle.float_to_i16(sig)
    pays = [parse_packet(enc.encode(pcm16[f * FRAME:(f + 1) * FRAME]
                                    .reshape(-1))).frames[0]
            for f in range(F)]
    buf, storage, state, _traces, plans = _capture([pays], 2)
    w = _walk(buf, storage, state, 2)
    assert bool(w["ok"])
    *_, ok_default = _finish(w, state, 2)
    assert not bool(ok_default.all())
    p, *_, ok_wide = _finish(w, state, 2, WIDE_CAPS)
    assert bool(ok_wide.all())
    X = execute_packed(p, torch.zeros((F, 2, FRAME)),
                       plan_combo_mats(2, FRAME, "cpu"), channels=2,
                       frame=FRAME, lm=LM, start=0, end=21).numpy()
    for f in range(F):
        assert float(np.abs(X[f] - execute_plan(plans[f])).max()) < 2e-4


@pytest.mark.slow
def test_step_matches_jax_lockstep():
    """The whole step beside the JAX package's lockstep_synthesis_step,
    mono, two frames, the JAX state carried into the port."""
    import jax.numpy as jnp
    from mousiki_tpu.ops.band_exec_jax import \
        plan_combo_mats as jax_mats
    from mousiki_tpu.ops.synthesis_jax import init_state as jax_synth_init
    from mousiki_tpu.ops.synthesis_jax import make_consts as jax_consts
    gs = load_mono_mix()[0]
    j_consts, j_sstate = jax_consts(n=FRAME), jax_synth_init(1, 1)
    j_lstate = jlt.init_state(1)
    t_consts = synthesis.make_consts(FRAME, "cpu")
    t_sstate = synthesis.init_state(1, 1, "cpu")
    t_lstate = convert.lockstep_state_from_numpy(
        [np.asarray(v) for v in j_lstate], "cpu")
    for f in range(2):
        buf, storage = tlt.pad_payloads([gs.payloads[f]], "cpu")
        j_pcm, j_sstate, j_lstate, j_ok = jlt.lockstep_synthesis_step(
            j_consts, j_sstate, j_lstate, jnp.asarray(buf.numpy()),
            jnp.asarray(storage.numpy().astype(np.int32)),
            jax_mats(1, FRAME), C=1, frame=FRAME)
        t_pcm, t_sstate, t_lstate, t_ok = tlt.lockstep_synthesis_step(
            t_consts, t_sstate, t_lstate, buf, storage, C=1, frame=FRAME)
        assert bool(np.asarray(j_ok).all()) and bool(t_ok.all())
        np.testing.assert_allclose(t_pcm.numpy(), np.asarray(j_pcm),
                                   atol=2e-4)
        back = convert.lockstep_state_to_numpy(t_lstate)
        np.testing.assert_array_equal(back.rng, np.asarray(j_lstate.rng))
        for got, want in zip(back[1:], j_lstate[1:]):
            np.testing.assert_allclose(got, np.asarray(want), atol=2e-4)
