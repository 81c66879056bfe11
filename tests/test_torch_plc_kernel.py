"""The concealment's row work (mousiki_tpu_torch.ops.plc.plc_rows): its
plain version against the path it replaced, the row arithmetic of
csrc/plc_rows.h (built by g++ for the host) against the plain version's
float32 steps, and, on the card, the kernel against the plain version.

(a) celt_plc_freq through plc_rows_reference equals, bit for bit, the
    same function through the sequence it replaced (`_previous_rows`,
    its lines kept here), on the golden decode history of
    tests/test_torch_plc.py (a first loss, then a second one with the 0.8
    fade and the carried LPC) and on the seeded rows of plc_cases.py.
(b) The host build of plc_rows.h given the plain version's own sums (the
    float64 dots, energies and window sums): the Levinson steps, the
    noise floor, the residual, the decay and the synthesis steps (a row
    that saturates at +-65536 among them) bit for bit; logf and expf are
    the C library's there and torch's vectorised ones here, within 2
    float32 ulps of each value.
(c) On the card (`cuda`): the kernel against the plain version on the
    seeded rows and a random batch: the LPC within 1e-4, ext within 1e-3
    of each row's peak, the rows of streams that are not lost 0.0.
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

import plc_cases
from golden_streams import frame_batch, load_stereo_celt
from mousiki_tpu_torch.celt.modes import MODE
from mousiki_tpu_torch.ops import _build, plc, synthesis
from mousiki_tpu_torch.pipeline import (SERVING_PROFILE, CeltStreamPipeline,
                                        set_plan_profile)
from torch_threads import one_torch_thread  # noqa: F401

S, C, N = 3, 2, 960
N_EXT = N + plc.OVERLAP
ULPS = 2
LPC_TOL = 1e-4
EXT_TOL = 1e-3


def _consts(device="cpu"):
    return plc.make_plc_consts(N, MODE.window, device)


@pytest.fixture(scope="module")
def golden_state():
    streams = load_stereo_celt()
    set_plan_profile(*SERVING_PROFILE)
    try:
        pipe = CeltStreamPipeline(S, channels=C, use_plan=True,
                                  device="cpu")
        for f in range(5):
            pipe.step(frame_batch(streams, S, f))
    finally:
        set_plan_profile()
    return pipe.state


def _seeded_state():
    """A synthesis state whose decode memory ends in the seeded rows, with
    seeded postfilter parameters, and the rows' PlcState (loss count 1 and
    the carried LPC on a second loss)."""
    rows = plc_cases.plc_rows(np.random.default_rng(41))
    n = len(rows["names"])
    state = synthesis.init_state(n, C, "cpu")
    mem = state.decode_mem.clone()
    mem[:, :, plc.DBS - plc.HIST:plc.DBS] = torch.from_numpy(rows["hist"])
    rng = np.random.default_rng(42)
    state = state._replace(
        decode_mem=mem,
        pf_period=torch.as_tensor(rng.integers(15, 1022, n),
                                  dtype=torch.int32),
        pf_gain=torch.as_tensor(rng.uniform(0, 0.7, n), dtype=torch.float32),
        pf_tapset=torch.as_tensor(rng.integers(0, 3, n), dtype=torch.int32))
    first = torch.from_numpy(rows["first"])
    pstate = plc.PlcState(
        loss_count=torch.where(first, 0, 1).to(torch.int32),
        plc_pitch=torch.from_numpy(rows["pitch"]),
        lpc=torch.from_numpy(rows["lpc_prev"]))
    return state, pstate, torch.from_numpy(rows["lost"])


def _previous_rows(consts, hist, first, lost, pitch, fade, lpc_prev, *,
                   n_ext):
    """celt_plc_freq's row work as it was written before plc_rows: the
    fit's bandwidth expansion computed in the fit, the decay and the
    excitation inline."""
    S, C, _ = hist.shape
    dev = hist.device
    bw = 0.99 ** torch.arange(1, plc.ORDER + 1, dtype=torch.float32,
                              device=dev)
    fit = plc._lpc_fit({**consts, "bw": torch.ones_like(bw)}, hist) * bw
    lpc = torch.where(first[:, None, None], fit, lpc_prev)
    exc = plc._fir_residual(hist, lpc)
    p = pitch.long()
    ar = torch.arange(plc.HIST, device=dev)
    m1 = (ar >= plc.HIST - p[:, None])[:, None, :]
    m2 = ((ar >= plc.HIST - 2 * p[:, None])
          & (ar < plc.HIST - p[:, None]))[:, None, :]
    exc64 = exc.double()
    ee = exc64 * exc64
    zero = torch.zeros((), dtype=ee.dtype, device=dev)
    e1 = torch.where(m1, ee, zero).sum(-1).float()
    e2 = torch.where(m2, ee, zero).sum(-1).float()
    has2 = (2 * p <= plc.HIST)[:, None]
    e2 = torch.where(has2, e2, e1)
    decay = torch.sqrt(torch.clamp(e1 / torch.clamp(e2, min=1e-9), max=1.0))
    fade = fade[:, None]
    nn = torch.arange(n_ext, device=dev)
    src = plc.HIST - p[:, None] + nn[None, :] % p[:, None]
    periods = nn[None, :] // p[:, None]
    e_src = torch.gather(exc, 2, src[:, None, :].expand(S, C, n_ext))
    atten = fade[:, :, None] * torch.exp(
        torch.log(torch.clamp(decay, min=1e-9))[:, :, None]
        * periods[:, None, :].to(torch.float32))
    e_ext = e_src * atten
    return lpc, plc._lpc_synthesis(e_ext, hist[..., plc.HIST - plc.ORDER:],
                                   lpc)


@contextlib.contextmanager
def _rows_through(fn):
    saved = plc.plc_rows
    plc.plc_rows = fn
    try:
        yield
    finally:
        plc.plc_rows = saved


@pytest.mark.parametrize("history", ["golden", "seeded"])
def test_rows_equal_the_previous_path(history, request):
    if history == "golden":
        state = request.getfixturevalue("golden_state")
        pstate = plc.init_plc_state(S, C, "cpu")
        lost = torch.tensor([True, False, True])
    else:
        state, pstate, lost = _seeded_state()
    consts = _consts()
    # a first loss, then a second one from the state it left
    for rnd in range(2):
        freq, new = plc.celt_plc_freq(consts, state, pstate, lost,
                                      channels=C, frame=N)
        with _rows_through(_previous_rows):
            want, want_new = plc.celt_plc_freq(consts, state, pstate, lost,
                                               channels=C, frame=N)
        assert torch.equal(freq, want), (history, rnd)
        for got, ref in zip(new, want_new):
            assert torch.equal(got, ref), (history, rnd)
        assert float(freq[lost].abs().max()) > 1.0
        pstate = new


def _lib():
    lib = _build.load_plc_rows_host()
    for name in ("plc_host_noise_floor", "plc_host_levinson",
                 "plc_host_levinson_coef", "plc_host_residual",
                 "plc_host_decay", "plc_host_atten", "plc_host_synth"):
        getattr(lib, name).restype = None
    return lib


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


def _host(fn, *arrays, out_dtypes):
    """fn over the flat arrays, returning its outputs (one of each dtype
    of out_dtypes, the length of the first input)."""
    ins = [np.ascontiguousarray(a) for a in arrays]
    outs = [np.zeros(ins[0].size, d) for d in out_dtypes]
    fn(*map(_ptr, ins), *map(_ptr, outs), ctypes.c_long(ins[0].size))
    return outs


def _ulps(got, want):
    """|got - want| in float32 ulps of want."""
    spacing = np.spacing(np.abs(want).astype(np.float32))
    return np.abs(got.astype(np.float64) - want) / spacing


def _histories():
    rows = plc_cases.plc_rows(np.random.default_rng(43))
    return torch.from_numpy(np.concatenate(
        [rows["hist"], plc_cases.ar2(np.random.default_rng(44), (4, C))]))


def test_host_levinson_steps_match_the_plain_fit():
    """The fit's loop, op for op as plc._lpc_fit runs it (its result
    equal to _lpc_fit's), each iteration's k, error and updated taps
    against plc_rows.h given the iteration's float64 dot."""
    lib = _lib()
    consts = _consts()
    hist = _histories()
    xw = (hist * consts["han"]).double()
    ac = torch.stack([(xw[..., :plc.HIST - i] * xw[..., i:]).sum(-1)
                      for i in range(plc.ORDER + 1)], dim=-1).float()
    ac0 = ac[..., 0] * 1.0001 + 1e-9 * plc.HIST
    (got,) = _host(lib.plc_host_noise_floor, ac[..., 0].numpy(),
                   out_dtypes=[np.float32])
    np.testing.assert_array_equal(got, ac0.flatten().numpy())
    ac = torch.cat([ac0[..., None], ac[..., 1:] * consts["lagw"]], dim=-1)
    ac64 = ac.double()
    a = torch.zeros_like(ac[..., :plc.ORDER])
    err = ac[..., 0]
    for i in range(plc.ORDER):
        dot = (a[..., :i] * ac64[..., 1:i + 1].flip(-1)).sum(-1)
        acc = (ac64[..., i + 1] - dot).float()
        k = torch.clamp(acc / torch.clamp(err, min=1e-12), -0.98, 0.98)
        got_k, got_err = _host(lib.plc_host_levinson, ac64[..., i + 1].numpy(),
                               dot.numpy(), err.numpy(),
                               out_dtypes=[np.float32, np.float32])
        a2 = a.clone()
        a2[..., :i] = a[..., :i] - k[..., None] * a[..., :i].flip(-1)
        a2[..., i] = k
        (got_a,) = _host(lib.plc_host_levinson_coef, a[..., :i].numpy(),
                         a[..., :i].flip(-1).numpy(),
                         k[..., None].expand(*k.shape, i).numpy(),
                         out_dtypes=[np.float32])
        err = err * (1 - k * k)
        np.testing.assert_array_equal(got_k, k.flatten().numpy())
        np.testing.assert_array_equal(got_err, err.flatten().numpy())
        np.testing.assert_array_equal(got_a, a2[..., :i].flatten().numpy())
        a = a2
    assert torch.equal(a * consts["bw"], plc._lpc_fit(consts, hist))


def test_host_residual_matches_the_plain_residual():
    lib = _lib()
    hist = _histories()
    lpc = plc._lpc_fit(_consts(), hist)
    lpc[0, 0] = torch.linspace(-1.5, 1.5, plc.ORDER)   # taps of both signs
    want = plc._fir_residual(hist, lpc).numpy()
    got = np.zeros_like(want)
    lib.plc_host_residual(_ptr(np.ascontiguousarray(hist.numpy())),
                          _ptr(np.ascontiguousarray(lpc.numpy())), _ptr(got),
                          ctypes.c_long(hist.shape[0] * hist.shape[1]))
    np.testing.assert_array_equal(got, want)


def test_host_decay_and_excitation_match_the_plain_steps():
    """The decay from given energies bit for bit (has2 both ways, an
    energy of 0, e1 > e2); log and exp within ULPS of torch's."""
    lib = _lib()
    rng = np.random.default_rng(45)
    e1 = (rng.random(64) * 1e6).astype(np.float32)
    e2 = (rng.random(64) * 1e6).astype(np.float32)
    e1[:4], e2[4:8] = 0.0, 0.0
    has2 = rng.random(64) < 0.7
    t1, t2 = torch.from_numpy(e1), torch.from_numpy(e2)
    t2 = torch.where(torch.from_numpy(has2), t2, t1)
    decay = torch.sqrt(torch.clamp(t1 / torch.clamp(t2, min=1e-9), max=1.0))
    logd = torch.log(torch.clamp(decay, min=1e-9))
    got_decay, got_logd = _host(lib.plc_host_decay, e1, e2,
                                has2.astype(np.uint8),
                                out_dtypes=[np.float32, np.float32])
    np.testing.assert_array_equal(got_decay, decay.numpy())
    assert (decay < 1).any() and (decay == 1).any()
    assert _ulps(got_logd, logd.numpy()).max() <= ULPS
    # the attenuation of periods 0..8 at every decay, fade 1 and 0.8
    period = np.repeat(np.arange(9, dtype=np.int32), 64)
    fade = np.tile(np.where(np.arange(64) % 2, 1.0, 0.8).astype(np.float32),
                   9)
    lg = np.tile(logd.numpy(), 9)
    want = (torch.from_numpy(fade) * torch.exp(
        torch.from_numpy(lg) * torch.from_numpy(period).float())).numpy()
    (got,) = _host(lib.plc_host_atten, fade, lg, period,
                   out_dtypes=[np.float32])
    assert _ulps(got, want).max() <= ULPS


def test_host_synthesis_steps_match_the_plain_synthesis():
    """Each step of plc._lpc_synthesis's loop against plc_synth given the
    step's float64 sum; one row saturates at +65536 and -65536."""
    lib = _lib()
    rows = plc_cases.plc_rows(np.random.default_rng(46))
    hist = torch.from_numpy(rows["hist"])
    lpc = torch.from_numpy(rows["lpc_prev"]).clone()
    lpc[rows["first"]] = plc._lpc_fit(_consts(), hist[rows["first"]])
    e_ext = torch.from_numpy(np.random.default_rng(47).standard_normal(
        (*hist.shape[:2], N_EXT)).astype(np.float32) * 500)
    want = plc._lpc_synthesis(e_ext, hist[..., -plc.ORDER:], lpc)
    buf = torch.cat([hist[..., -plc.ORDER:], want], dim=-1)
    lpc_rev = lpc.flip(-1).double()
    sums = torch.stack([(buf[..., t:t + plc.ORDER] * lpc_rev).sum(-1)
                        for t in range(N_EXT)], dim=-1)
    (got,) = _host(lib.plc_host_synth, sums.numpy(), e_ext.numpy(),
                   out_dtypes=[np.float32])
    np.testing.assert_array_equal(got, want.flatten().numpy())
    sat = rows["names"].index("saturating_synthesis_p100")
    assert (want[sat] == 65536.0).any() and (want[sat] == -65536.0).any()


def test_cpu_route_and_argument_checks():
    """CPU tensors take the plain version (no launch); arguments of the
    wrong type, shape or size raise on both routes."""
    rows = plc_cases.plc_rows(np.random.default_rng(48))
    args = [torch.from_numpy(rows[k]) for k in
            ("hist", "first", "lost", "pitch", "fade", "lpc_prev")]
    consts = _consts()
    plc.reset_launches()
    lpc, ext = plc.plc_rows(consts, *args, n_ext=N_EXT)
    want_lpc, want_ext = plc.plc_rows_reference(consts, *args, n_ext=N_EXT)
    assert plc.plc_rows_launches == 0
    assert torch.equal(lpc, want_lpc) and torch.equal(ext, want_ext)
    assert ext.shape == (len(rows["names"]), C, N_EXT)
    with pytest.raises(TypeError, match="pitch"):
        plc.plc_rows(consts, *args[:3], args[3].long(), *args[4:],
                     n_ext=N_EXT)
    with pytest.raises(TypeError, match="hist"):
        plc.plc_rows(consts, args[0][..., 1:], *args[1:], n_ext=N_EXT)
    with pytest.raises(ValueError, match="n_ext"):
        plc.plc_rows(consts, *args, n_ext=plc.MAX_EXT + 1)
    with pytest.raises(ValueError, match="cpu or cuda"):
        plc.plc_rows(consts, args[0].to("meta"), *args[1:], n_ext=N_EXT)


@pytest.mark.cuda
def test_kernel_matches_plain_on_gpu():
    """The kernel against its plain version on the seeded rows and on 64
    random streams with a third of them lost (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    rng = np.random.default_rng(49)
    rows = plc_cases.plc_rows(rng)
    n = 64
    hist = (plc_cases.ar2(rng, (n, C)) * rng.uniform(0.1, 3, (n, 1, 1))
            ).astype(np.float32)
    lost = rng.random(n) < 0.35
    first = lost & (rng.random(n) < 0.6)
    batch = {"hist": hist, "first": first, "lost": lost,
             "pitch": rng.integers(100, 721, n).astype(np.int32),
             "fade": np.where(first, 1.0, 0.8).astype(np.float32),
             "lpc_prev": (rng.standard_normal((n, C, plc.ORDER)) * 0.05
                          ).astype(np.float32)}
    consts = _consts("cuda")
    for case in (rows, batch):
        args = [torch.from_numpy(np.ascontiguousarray(case[k])).cuda()
                for k in ("hist", "first", "lost", "pitch", "fade",
                          "lpc_prev")]
        for n_ext in (N_EXT, 240 + plc.OVERLAP):
            plc.reset_launches()
            lpc, ext = plc.plc_rows(consts, *args, n_ext=n_ext)
            torch.cuda.synchronize()
            assert plc.plc_rows_launches == 1
            want_lpc, want_ext = plc.plc_rows_reference(consts, *args,
                                                        n_ext=n_ext)
            lost_t = args[2]
            assert torch.equal(ext[~lost_t], torch.zeros_like(ext[~lost_t]))
            assert torch.equal(lpc[~lost_t], args[5][~lost_t])
            assert (lpc - want_lpc)[lost_t].abs().max().item() <= LPC_TOL
            peak = want_ext.abs().amax(dim=-1, keepdim=True)
            assert bool(((ext - want_ext).abs() <= EXT_TOL * peak)[lost_t]
                        .all())
