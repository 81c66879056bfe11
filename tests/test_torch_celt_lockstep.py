"""The port's lockstep band-tree walk, plan emission and whole step
(mousiki_tpu_torch/ops/celt_lockstep_walk.py, celt_lockstep_emit.py,
celt_lockstep_top.py) against the JAX package.

Constants equal the JAX package's. On the golden CELT streams (no
libopus needed), each lane one frame with the reference decoder's state
captured before it: the walk's PVQ leaves equal the reference decoder's
plan (fills a subset, in visit order), every real node and band slot is
written by at most one iteration (so the emission scatters need no
order), and the executed X plane is within 2e-4 of the plan's. Then the
whole step with the state carried over 4 frames: PCM within 2e-4 of the
JAX package's CeltDecoder, of the golden PCM and of the port's
CeltStreamPipeline(use_plan=True). A 320 kbit/s stream of the system
libopus overflows the default tier caps (ok False) and fits the wide
ones (skips without libopus). One `slow` case runs the whole step beside
the JAX package's lockstep_synthesis_step (the JAX compile of the step
dominates its time, so it stays out of tier-1).
"""

import numpy as np
import pytest
import torch

from golden_streams import load_mono_mix, load_stereo_celt
from mousiki_tpu.celt.decoder import CeltDecoder
from mousiki_tpu.celt.modes import opus_custom_mode
from mousiki_tpu.celt.plan import FOLD, NOISE, PVQ, execute_plan
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
from mousiki_tpu_torch.ops import ec_lockstep as tec
from mousiki_tpu_torch.ops import band_assembly, band_exec, synthesis
from mousiki_tpu_torch.ops.band_exec import execute_packed, plan_combo_mats
from mousiki_tpu_torch.pipeline import CeltStreamPipeline
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.lockstep

FRAME = 960
LM = 3
WIDE_CAPS = (384, 112, 24)


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


def _capture(payload_lists, channels):
    """Lanes = frames: the packed payloads and, from the reference
    decoder run over each stream, the state before every frame, its
    trace and its recorded plan."""
    pkts, states, traces, plans = [], [], [], []
    for pays in payload_lists:
        dec = CeltDecoder(channels=channels, stream_channels=channels,
                          end=21, disable_inv=channels == 1)
        for p in pays:
            states.append((dec.rng, dec.old_ebands.copy(),
                           dec.old_log_e.copy(), dec.old_log_e2.copy()))
            tr = {}
            desc = dec.decode_with_ec(p, FRAME, trace=tr, record_plan=True,
                                      return_desc=True)
            pkts.append(p)
            traces.append(tr)
            plans.append(desc["plan"])
    buf, storage = tlt.pad_payloads(pkts, "cpu")
    state = convert.lockstep_state_from_numpy(
        [np.array([s[i] for s in states]) if i == 0
         else np.stack([s[i] for s in states]) for i in range(4)], "cpu")
    return buf, storage, state, traces, plans


def _walk(buf, storage, state, C):
    """decode_frames up to and including the walk."""
    hdr, energy, tf_res, spread, _off, _trim, alloc, st = tls.decode_symbols(
        buf, storage, state.old_ebands, C=C)
    S = buf.shape[0]
    emits, carry, ok = tlw.walk_bands(
        st, torch.ones(S, dtype=torch.bool), C=C, lm=LM,
        transient=hdr.transient, tf_res=tf_res, spread=spread, alloc=alloc,
        total_bits_frac=((st.storage * 8) << 3) - alloc.anti_collapse_rsv,
        disable_inv=torch.full((S,), C == 1), n_iter=tlt.N_ITER_LM3[C])
    return dict(hdr=hdr, energy=energy, tf_res=tf_res, spread=spread,
                alloc=alloc, emits=emits, carry=carry, ok=ok)


def _finish(w, state, C, caps=tle.DEFAULT_CAPS):
    return tlt.finish_frames(state, w["hdr"], w["energy"], w["tf_res"],
                             w["spread"], w["alloc"], w["emits"], w["carry"],
                             C=C, lm=LM, caps=caps)


@pytest.fixture(scope="module", params=[2, 1], ids=["stereo", "mono"])
def golden_walk(request):
    """All 12 frames of the golden CELT streams (3 stereo, 1 mono) as
    lanes, walked once."""
    C = request.param
    streams = load_stereo_celt() if C == 2 else [load_mono_mix()[0]]
    buf, storage, state, traces, plans = _capture(
        [gs.payloads for gs in streams], C)
    return C, buf, storage, state, traces, plans, _walk(buf, storage, state,
                                                        C)


_EB = [int(v) for v in opus_custom_mode(48000, 960).ebands]


def _plan_leaves_by_slot(plan, lay):
    """FramePlan PVQ / fill leaves by lockstep global slot id."""
    band_start = [8 * e for e in _EB]

    def slot_of(dst, n):
        ch, off = divmod(dst, FRAME)
        band = max(i for i in range(21) if band_start[i] <= off)
        nb = band_start[band + 1] - band_start[band]
        d = 0
        while (nb >> d) != n:
            d += 1
            assert d < 6, (dst, n)
        nid = (1 << d) + (off - band_start[band]) // n
        return ch * lay.nslot + int(lay.base[band]) + nid - 1

    pvq, fills = {}, []
    for kind, op in plan.ops:
        if kind != "call":
            continue
        for lf in op.leaves:
            if lf.kind == PVQ:
                pvq[slot_of(lf.dst, lf.n)] = lf
            elif lf.kind in (FOLD, NOISE):
                fills.append(slot_of(lf.dst, lf.n))
    return pvq, fills


def test_walk_leaves(golden_walk):
    C, buf, storage, state, traces, plans, w = golden_walk
    assert bool(w["ok"])
    assert any(tr["transient"] for tr in traces)
    lay = tlw.walk_layout(LM)
    e = {k: v.numpy() for k, v in w["emits"]._asdict().items()}
    tells = tec.ec_tell(w["carry"].st).numpy()
    for s, tr in enumerate(traces):
        assert not tr["silence"]
        truth, truth_fills = _plan_leaves_by_slot(plans[s], lay)
        mine, mine_fills = {}, {}
        for t in range(e["slot"].shape[0]):
            sl = e["slot"][t, s]
            if sl < 0 or e["split"][t, s]:
                continue
            if e["k"][t, s] > 0:
                mine[sl] = (e["k"][t, s], e["idx"][t, s], e["gain"][t, s])
            elif e["rank"][t, s] >= 0:
                mine_fills[sl] = e["rank"][t, s]
        assert set(mine) == set(truth), f"lane {s}: pvq slots"
        for sl, lf in truth.items():
            k, idx, gain = mine[sl]
            assert (k, idx) == (lf.k, lf.idx & 0xFFFFFFFF), (s, sl)
            assert abs(gain - lf.gain) < 1e-4 * max(1.0, abs(lf.gain))
        # the plan records only nonzero fills; the walk emits every q == 0
        # leaf (zero / fold / noise resolve in pass 2): a subset, in order
        assert set(truth_fills) <= set(mine_fills), f"lane {s}: fills"
        ranks = [mine_fills[sl] for sl in truth_fills]
        assert ranks == sorted(ranks), f"lane {s}: fill order"
        expected = tr["tell_post_bands"] - (tr["anti_collapse_rsv"] > 0)
        assert tells[s] == expected, f"lane {s}: tell"


def test_emission_slots_written_once(golden_walk):
    """Hazard of the emission scatters: torch's scatter with duplicate
    indices keeps an unspecified one. Every real (lane, node slot) and
    (lane, band) is emitted by at most one iteration; only the dummy
    column takes many."""
    C, *_, w = golden_walk
    e = w["emits"]
    for plane, n_real in ((e.slot, C * tlw.walk_layout(LM).nslot),
                          (e.band, 21)):
        real = plane >= 0
        col = torch.where(real, plane, n_real).T          # (S, T)
        counts = torch.zeros((col.shape[0], n_real + 1), dtype=torch.int64)
        counts.scatter_add_(1, col, torch.ones_like(col))
        assert int(counts[:, :n_real].max()) == 1
        assert int(real.sum()) == int(counts[:, :n_real].sum())
    # every band entered once a lane
    assert (e.band >= 0).sum(dim=0).eq(21).all()


def test_xplane_parity(golden_walk):
    C, buf, storage, state, traces, plans, w = golden_walk
    p, _ble, _hdr, _new, ok = _finish(w, state, C)
    assert bool(ok.all())
    S = buf.shape[0]
    X = execute_packed(p, torch.zeros((S, C, FRAME)),
                       plan_combo_mats(C, FRAME, "cpu"), channels=C,
                       frame=FRAME, lm=LM, start=0, end=21).numpy()
    for f in range(S):
        err = float(np.abs(X[f] - execute_plan(plans[f])).max())
        assert err < 2e-4, f"frame {f}: X err {err}"


def test_emission_planes_take_the_band_kernel_layout(golden_walk):
    """The emitted plan planes in the layout the band assembly kernel
    reads on the card (each stream's row contiguous, as in the host's
    arena), after the executor's normalisation."""
    C, buf, storage, state, traces, plans, w = golden_walk
    p, *_ = _finish(w, state, C)
    p = band_exec._normalize_plan(p)
    X = torch.zeros((buf.shape[0], C * FRAME), dtype=torch.float64)
    band_assembly._check_kernel(p, X, band_assembly.packed_operators(
        FRAME, "cpu"), FRAME, LM)


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
