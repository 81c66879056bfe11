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

The constants, the pulse search's bounds, the PCM with the state carried
and the caps' overflow are in tests/test_torch_celt_lockstep_pcm.py.
(Split so that each of the port's test files holds at most 8 cases: the
tier-1 suite then starts its longest file early.)
"""

import numpy as np
import pytest
import torch

from golden_streams import load_mono_mix, load_stereo_celt
from mousiki_tpu.celt.decoder import CeltDecoder
from mousiki_tpu.celt.modes import opus_custom_mode
from mousiki_tpu.celt.plan import FOLD, NOISE, PVQ, execute_plan
from mousiki_tpu_torch import convert
from mousiki_tpu_torch.ops import celt_lockstep as tls
from mousiki_tpu_torch.ops import celt_lockstep_emit as tle
from mousiki_tpu_torch.ops import celt_lockstep_top as tlt
from mousiki_tpu_torch.ops import celt_lockstep_walk as tlw
from mousiki_tpu_torch.ops import ec_lockstep as tec
from mousiki_tpu_torch.ops import band_assembly, band_exec
from mousiki_tpu_torch.ops.band_exec import execute_packed, plan_combo_mats
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.lockstep

FRAME = 960
LM = 3
WIDE_CAPS = (384, 112, 24)


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
