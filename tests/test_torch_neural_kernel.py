"""The neural loss recovery's two hand kernels: models/fargan.conceal_frames
(csrc/fargan.cu: PitchDNN + FARGAN, F frames a launch) and models/dred.
decode_qframes (csrc/rdovae.cu: the RDOVAE decoder over Q qframes a
launch).

On the CPU, with the JAX package's seeded weights carried across
(convert.*_from_numpy): (a) the host build of fargan.h against the plain
version and the JAX package's _conceal_batch, S = 3, two calls of two
frames with the state carried and one lane inactive in the second;
(b) the same through DeepPlcState.conceal's route (PitchDNN once, its
period for every frame) against the JAX DeepPlcState; (c) the host build
of rdovae.h against the plain version and the JAX _rdovae_decode_batch on
streams with 0, 1, 13 and 26 of 26 qframes active, the frozen state equal
to the state after the last active qframe; (d) the wrappers' routes and
argument checks. Integer periods equal frame by frame, a flip excused only
where the plain version's float lies within 1e-3 of an integer (and its
lane then left out of the PCM bar); PCM and every state field within 1e-4
(tests/test_deep_recovery.py:92), features within 1e-4 of their scale.

On the card (`cuda`, the port's seeded models, no JAX): each kernel within
the same bars of its plain version, bit-equal to its host build, a stream
bit-equal at S = 64 and alone, and one launch a call.
"""

import numpy as np
import pytest
import torch

from mousiki_tpu_torch import convert
from mousiki_tpu_torch.models import deep_plc, fargan
from mousiki_tpu_torch.models import dred as rdovae
from mousiki_tpu_torch.models.nnet import Linear
from torch_threads import one_torch_thread  # noqa: F401
from torch_threads import seeded_jax_model

TOL = 1e-4          # tests/test_deep_recovery.py:92
PERIOD_TOL = 1e-3   # a flipped integer period is excused this near one
S, FRAMES, CALLS, Q = 3, 2, 2, 26
ACTIVE_QFRAMES = (0, 1, 13, 26)


@pytest.fixture(scope="module")
def models():
    """The JAX package's FARGAN (seed 2), PitchDNN (seed 3, five times the
    reference's scale, so that the periods spread) and RDOVAE decoder
    (seed 1), and the port's copies of them on the CPU."""
    from mousiki_tpu.models import deep_plc as jax_plc
    from mousiki_tpu.models import dred as jax_dred
    from mousiki_tpu.models import fargan as jax_fargan

    jf = seeded_jax_model(jax_fargan.random_model, 2, lambda s: 0.08)
    jp = seeded_jax_model(jax_plc.random_pitchdnn, 3,
                          lambda s: 1.0 / np.sqrt(s[1]))
    jd = seeded_jax_model(jax_dred.random_dec, 1,
                          lambda s: 0.3 / np.sqrt(s[1]))
    return dict(jax=(jf, jp, jd),
                port=(convert.fargan_from_numpy(jf, "cpu"),
                      convert.pitchdnn_from_numpy(jp, "cpu"),
                      convert.rdovae_dec_from_numpy(jd, "cpu")))


def _flipped(got, want, label) -> np.ndarray:
    """Lanes whose integer periods differ anywhere (S, F float periods);
    fails on a flip not within PERIOD_TOL of an integer."""
    got, want = np.asarray(got), np.asarray(want)
    flips = got.astype(np.int32) != want.astype(np.int32)
    dist = np.abs(want - np.round(want))
    assert (dist[flips] < PERIOD_TOL).all(), (label, got[flips],
                                              want[flips])
    return flips.any(axis=1)


def _pcm_err(got, want, flipped, label) -> float:
    err = np.abs(np.asarray(got) - np.asarray(want)).max(axis=1)
    worst = float(err[~flipped].max(initial=0.0))
    assert worst <= TOL, f"{label}: PCM {worst} from the reference"
    return worst


def _state_err(got, want, flipped, label) -> float:
    """The worst error of the FARGAN state fields and the PitchDNN state
    (lanes without a flip), each in units of max(1, the field's peak)."""
    worst = 0.0
    for name, g, w in zip((*fargan.FarganState._fields, "pitch_state"),
                          got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (label, name)
        if not w.size:          # fwc0_mem: no history
            continue
        scale = max(1.0, float(np.abs(w).max()))
        e = float(np.abs(g - w)[~flipped].max(initial=0.0)) / scale
        assert e <= TOL, f"{label}: {name} {e} of its scale"
        worst = max(worst, e)
    return worst


def _jax_periods(jp, feats, state):
    """(S, F) float periods of the JAX PitchDNN, stream by stream, and the
    new states."""
    from mousiki_tpu.models import deep_plc as jax_plc

    out = np.zeros(feats.shape[:2], np.float32)
    states = []
    for s in range(feats.shape[0]):
        st = state[s]
        for f in range(feats.shape[1]):
            p, st = jax_plc.compute_pitchdnn(jp, st, feats[s, f])
            out[s, f] = float(p)
        states.append(np.asarray(st))
    return out, np.stack(states)


def test_conceal_host_build_matches_plain_and_jax(models):
    """(a) S = 3, two calls of two frames, the states carried, lane 1
    inactive in the second call."""
    import jax.numpy as jnp
    from mousiki_tpu.models import fargan as jax_fargan
    from mousiki_tpu.parallel.deep_recovery import _conceal_batch

    (jf, jp, _), (tf, tp, _) = models["jax"], models["port"]
    rng = np.random.default_rng(5)
    host = plain = (fargan.init_state(tf, S), torch.zeros(S, 64))
    jst = (jax_fargan.init_state(jf, S), jnp.zeros((S, 64), jnp.float32))
    jper_state = np.zeros((S, 64), np.float32)
    flipped = np.zeros(S, bool)
    errs = {"pcm": 0.0, "pcm_jax": 0.0, "state": 0.0}
    for call in range(CALLS):
        feats = (rng.standard_normal((S, FRAMES, 20)) * 0.3).astype(
            np.float32)
        act = np.array([1.0, 0.0 if call else 1.0, 1.0], np.float32)
        t_feats, t_act = torch.from_numpy(feats), torch.from_numpy(act)
        got = fargan.conceal_frames_host(tf, tp, *host, t_feats, t_act)
        want = fargan.conceal_frames_reference(tf, tp, *plain, t_feats,
                                               t_act)
        jpcm, *jst = _conceal_batch(jf, jp, *jst, jnp.asarray(feats),
                                    jnp.asarray(act), n_frames=FRAMES)
        jper, jper_state = _jax_periods(jp, feats, jper_state)
        label = f"call {call}"
        flipped |= _flipped(got[1], want[1], label)
        flipped |= _flipped(want[1], jper, label)
        assert got[0].shape == (S, FRAMES * 160)
        assert bool(torch.isfinite(got[0]).all())
        assert not got[0][1].any() or not call
        errs["pcm"] = max(errs["pcm"], _pcm_err(got[0], want[0], flipped,
                                                label))
        errs["pcm_jax"] = max(errs["pcm_jax"], _pcm_err(got[0], jpcm,
                                                        flipped, label))
        errs["state"] = max(
            errs["state"],
            _state_err((*got[2], got[3]), (*want[2], want[3]), flipped,
                       label),
            _state_err((*got[2], got[3]), (*jst[0], jst[1]), flipped,
                       label))
        host, plain = (got[2], got[3]), (want[2], want[3])
    assert float(np.abs(jpcm).max()) > 1e-2
    print(f"host build: worst PCM {errs['pcm']:.3g} from the plain "
          f"version, {errs['pcm_jax']:.3g} from JAX; state "
          f"{errs['state']:.3g}; lanes with a period flip {flipped.sum()}")


def test_deep_plc_route_matches_jax(models):
    """(b) PitchDNN once a call, its period and the features for both
    frames: the host build, the port's DeepPlcState (the plain version on
    the CPU) and the JAX DeepPlcState, two calls of 320 samples."""
    from mousiki_tpu.models import deep_plc as jax_plc

    (jf, jp, _), (tf, tp, _) = models["jax"], models["port"]
    rng = np.random.default_rng(6)
    ref = jax_plc.DeepPlcState(fargan_model=jf, pitch_model=jp)
    port = deep_plc.DeepPlcState(tf, tp, device="cpu")
    host = (fargan.init_state(tf, 1), torch.zeros(1, 64))
    jstate = np.zeros((1, 64), np.float32)
    flipped = np.zeros(1, bool)
    for call in range(CALLS):
        feats = (rng.standard_normal(20) * 0.3).astype(np.float32)
        ref.last_features = port.last_features = feats
        want = np.asarray(ref.conceal(320))[None]
        plain = port.conceal(320)[None]
        got = fargan.conceal_frames_host(tf, tp, *host,
                                         torch.from_numpy(feats[None]),
                                         frames=2)
        jper, jstate = _jax_periods(jp, feats[None, None], jstate)
        assert got[1].shape == (1, 2) and got[1][0, 0] == got[1][0, 1]
        label = f"call {call}"
        flipped |= _flipped(got[1][:, :1], jper, label)
        flipped |= _flipped(port.last_period[:, None], jper, label)
        _pcm_err(got[0], plain, flipped, label)
        _pcm_err(got[0], want, flipped, label)
        _state_err((*got[2], got[3]),
                   (*port.fargan_state, port.pitch_state), flipped, label)
        host = (got[2], got[3])


def _packed(rng, n_active=ACTIVE_QFRAMES, q=Q):
    """process's packed rows: seeded latents and initial states, stream s
    active over its first n_active[s] of q qframes (the rest hold seeded
    latents too, which must not move the state)."""
    packed = np.zeros((len(n_active), rdovae.packed_width(q)), np.float32)
    packed[:, :24 * q + 24] = (rng.standard_normal(
        (len(n_active), 24 * q + 24)) * 1.5).astype(np.float32)
    for s, n in enumerate(n_active):
        packed[s, 24 * q + 24: 24 * q + 24 + n] = 1.0
    return packed


def _flat(state) -> np.ndarray:
    return np.concatenate([np.asarray(t) for t in (
        *state.gru_states, *(p for c in state.conv_states for p in c.past))],
        axis=1)


def test_rdovae_host_build_matches_plain_and_jax(models):
    """(c) Streams with 0, 1, 13 and 26 of 26 qframes active; the frozen
    state equals the state after the last active qframe (the host build
    over that stream's active qframes alone: the same bits)."""
    import jax.numpy as jnp
    from mousiki_tpu.parallel.deep_recovery import _rdovae_decode_batch

    jd, td = models["jax"][2], models["port"][2]
    packed = _packed(np.random.default_rng(7))
    t = torch.from_numpy(packed)
    got, got_state = rdovae.decode_qframes_host(td, t, return_state=True)
    want, want_state = rdovae.decode_qframes_reference(td, t,
                                                       return_state=True)
    lat = packed[:, :24 * Q].reshape(-1, Q, 24)
    jwant = np.asarray(_rdovae_decode_batch(
        jd, jnp.asarray(lat), jnp.asarray(packed[:, 24 * Q: 24 * Q + 24]),
        jnp.asarray(packed[:, 24 * Q + 24:] > 0.5)))
    assert got.shape == (len(ACTIVE_QFRAMES), Q, 4, 20)
    scale = float(np.abs(jwant).max())
    err = float(np.abs(got.numpy() - want.numpy()).max())
    err_jax = float(np.abs(got.numpy() - jwant).max())
    assert max(err, err_jax) <= TOL * scale, (err, err_jax, scale)
    got_flat, want_flat = _flat(got_state), _flat(want_state)
    assert np.abs(got_flat - want_flat).max() <= TOL * max(
        1.0, float(np.abs(want_flat).max()))
    for s, n in enumerate(ACTIVE_QFRAMES):
        alone = np.concatenate([packed[s:s + 1, :24 * n],
                                packed[s:s + 1, 24 * Q: 24 * Q + 24],
                                np.ones((1, n), np.float32)], axis=1)
        out, st = rdovae.decode_qframes_host(td, torch.from_numpy(alone),
                                             return_state=True)
        np.testing.assert_array_equal(_flat(st)[0], got_flat[s],
                                      err_msg=f"stream {s}")
        np.testing.assert_array_equal(out[0].numpy(),
                                      got[s, :n].numpy())
    print(f"host build: features {err:.3g} from the plain version, "
          f"{err_jax:.3g} from JAX (scale {scale:.3g})")


def test_routes_and_argument_checks(models):
    """(d) CPU tensors take the plain versions (no launch counted); the
    host build and the kernel route refuse what the kernels do not take."""
    tf, tp, td = models["port"]
    fst, pst = fargan.init_state(tf, 2), torch.zeros(2, 64)
    feats = torch.zeros(2, 1, 20)
    fargan.reset_launches()
    rdovae.reset_launches()
    got = fargan.conceal_frames(tf, tp, fst, pst, feats)
    want = fargan.conceal_frames_reference(tf, tp, fst, pst, feats)
    assert all(torch.equal(a, b) for a, b in zip(got[:2], want[:2]))
    packed = torch.from_numpy(_packed(np.random.default_rng(8), (1, 2), 2))
    assert torch.equal(rdovae.decode_qframes(td, packed),
                       rdovae.decode_qframes_reference(td, packed))
    assert fargan.conceal_frames_launches == 0
    assert rdovae.decode_qframes_launches == 0
    with pytest.raises(TypeError, match="feats"):
        fargan.conceal_frames_host(tf, tp, fst, pst, torch.zeros(2, 1, 21))
    with pytest.raises(TypeError, match="float32"):
        fargan.conceal_frames_host(tf, tp, fst, pst, feats.double())
    with pytest.raises(TypeError, match="gru2"):
        fargan.conceal_frames_host(tf, tp, fst._replace(
            gru2=torch.zeros(2, 64)), pst, feats)
    with pytest.raises(ValueError, match="kernel does not take"):
        fargan._run(tf, tp, fst, pst, feats, None, None, host=False)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fargan.conceal_frames(tf, tp, fst, pst, feats.to("meta"))
    # a FARGAN whose fwc0 conv keeps a frame of history
    wide = fargan.FarganModel(tf.cond_pembed.numpy(), {
        **{n: getattr(tf, n) for n in fargan.LAYERS},
        "fwc0_conv": Linear(np.zeros((256, 680), np.float32),
                            device="cpu")}, device="cpu")
    with pytest.raises(ValueError, match="fwc0 history"):
        fargan.conceal_frames_host(wide, tp, fst, pst, feats)
    with pytest.raises(TypeError, match="25 Q"):
        rdovae.decode_qframes_host(td, torch.zeros(2, 50))
    with pytest.raises(TypeError, match="float32"):
        rdovae.decode_qframes_host(td, packed.double())
    short = rdovae.RdovaeDec(td.hidden_init, td.gru_init, td.dense1,
                             [tuple(p) for p in td.grus], list(td.glus),
                             list(td.convs),
                             Linear(np.zeros((40, 736), np.float32),
                                    device="cpu"))
    with pytest.raises(ValueError, match="default widths"):
        rdovae.decode_qframes_host(short, packed)
    with pytest.raises(ValueError, match="GRU shortcut"):
        rdovae.decode_qframes_host(rdovae.RdovaeDec(
            td.hidden_init, td.gru_init, Linear(
                td.dense1.weight.numpy(), None, np.zeros(72, np.float32),
                device="cpu"), [tuple(p) for p in td.grus],
            list(td.glus), list(td.convs), td.output), packed)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _cpu(x):
    """x (a tensor, or a tuple or state of them) on the CPU."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    items = [_cpu(v) for v in x]
    return type(x)(*items) if hasattr(x, "_fields") else tuple(items)


@pytest.mark.cuda
def test_conceal_kernel_on_gpu():
    """The concealment kernel at S = 64, two calls of two frames (the
    second with inactive lanes), and the DeepPlcState route at S = 1:
    within the bars of the plain version on the card, bit-equal to the
    host build, stream 5 bit-equal alone, one launch a call."""
    dev = _needs_card()
    tf = fargan.random_model(torch.Generator().manual_seed(2), device=dev)
    tp = deep_plc.random_pitchdnn(torch.Generator().manual_seed(3),
                                  device=dev)
    tf_cpu = fargan.random_model(torch.Generator().manual_seed(2),
                                 device="cpu")
    tp_cpu = deep_plc.random_pitchdnn(torch.Generator().manual_seed(3),
                                      device="cpu")
    n = 64
    rng = np.random.default_rng(9)
    state = plain = (fargan.init_state(tf, n), torch.zeros(n, 64,
                                                           device=dev))
    flipped = np.zeros(n, bool)
    for call in range(CALLS):
        feats = torch.from_numpy((rng.standard_normal((n, FRAMES, 20))
                                  * 0.3).astype(np.float32)).to(dev)
        act = torch.ones(n, device=dev)
        act[::7] = 0.0 if call else 1.0
        fargan.reset_launches()
        got = fargan.conceal_frames(tf, tp, *state, feats, act)
        assert fargan.conceal_frames_launches == 1
        want = fargan.conceal_frames_reference(tf, tp, *plain, feats, act)
        host = fargan.conceal_frames_host(tf_cpu, tp_cpu, *_cpu(state),
                                          feats.cpu(), act.cpu())
        for a, b in zip(_cpu((got[0], got[1], *got[2], got[3])),
                        (host[0], host[1], *host[2], host[3])):
            assert torch.equal(a, b)
        one = fargan.conceal_frames(
            tf, tp, type(state[0])(*(t[5:6] for t in state[0])),
            state[1][5:6], feats[5:6], act[5:6])
        assert torch.equal(one[0][0], got[0][5])
        flipped |= _flipped(got[1].cpu(), want[1].cpu(), f"call {call}")
        _pcm_err(got[0].cpu(), want[0].cpu(), flipped, f"call {call}")
        state, plain = (got[2], got[3]), (want[2], want[3])
    f1 = torch.zeros(1, 20, device=dev)
    fargan.reset_launches()
    got = fargan.conceal_frames(tf, tp, fargan.init_state(tf, 1),
                                torch.zeros(1, 64, device=dev), f1,
                                frames=2)
    assert fargan.conceal_frames_launches == 1
    host = fargan.conceal_frames_host(
        tf_cpu, tp_cpu, fargan.init_state(tf_cpu, 1), torch.zeros(1, 64),
        f1.cpu(), frames=2)
    assert torch.equal(got[0].cpu(), host[0])


@pytest.mark.cuda
def test_rdovae_kernel_on_gpu():
    """The RDOVAE kernel on 64 streams of 26 qframes (0 to 26 active)
    within 1e-4 of the plain version's scale on the card, bit-equal to the
    host build with its final state, stream 13 bit-equal alone, one launch
    a call."""
    dev = _needs_card()
    td = rdovae.random_dec(torch.Generator().manual_seed(1), device=dev)
    td_cpu = rdovae.random_dec(torch.Generator().manual_seed(1),
                               device="cpu")
    packed = torch.from_numpy(_packed(np.random.default_rng(10),
                                      [s % (Q + 1) for s in range(64)]))
    rdovae.reset_launches()
    got, st = rdovae.decode_qframes(td, packed.to(dev), return_state=True)
    assert rdovae.decode_qframes_launches == 1
    want = rdovae.decode_qframes_reference(td, packed.to(dev))
    host, host_st = rdovae.decode_qframes_host(td_cpu, packed,
                                               return_state=True)
    assert torch.equal(got.cpu(), host)
    np.testing.assert_array_equal(_flat(_cpu(st)), _flat(host_st))
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= TOL * scale
    one = rdovae.decode_qframes(td, packed[13:14].to(dev))
    assert torch.equal(one[0], got[13])
