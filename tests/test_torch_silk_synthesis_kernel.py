"""The device SILK synthesis kernel (csrc/silk_synthesis.cu, arithmetic in
csrc/silk_synthesis.h): the host build of the header against the plain
version (ops/silk_synthesis.silk_synthesis_step_reference) on the CPU, and,
on the card, the kernel against the plain version and the host build.

(a) The host build against the plain version, 12 frames with the state
    carried: the golden 16 and 8 kHz SILK symbols (two streams, the second
    with the interpolation flag inverted) and the seeded parameters of
    silk_synthesis_cases.py at 12, 16 and 8 kHz (voiced and unvoiced,
    interpolation on and off, lags of 18 and of the rate's maximum, lags
    that change at every subframe, so that at 12 kHz the chunks that
    straddle two subframes take the earlier one's lag, lags that read
    inside the chunk being written or clamp to the plane's first sample).
    The header sums the LTP's 5 and the LPC's 16 products in the order of
    torch's CPU reduction and rounds every operation where the plain
    version does, so the output and both state planes are bit-equal.
(b) The same through the mixed decoder's lane layout: every parameter a
    strided view of one (S, 377) float plane, pitch_l int64.
(c) The wrapper's routes and argument checks.
(d) On the card (`cuda`): the kernel against the plain version over 12
    carried frames at 8, 12 and 16 kHz within 1e-4 of each frame's peak,
    state included (tests/test_torch_silk_synthesis.py's bar: the plain
    version on the card sums in CUDA's order, whose last-bit differences
    the LPC filter carries), and bit-equal to the host build; one launch a
    step.
"""

import numpy as np
import pytest
import torch

import silk_synthesis_cases as cases
from golden_streams import load_mono_mix
from mousiki_tpu_torch.ops import silk_synthesis as ss
from mousiki_tpu_torch.silk.host_native import NativeSilkHost
from torch_threads import one_torch_thread  # noqa: F401

F = 12
KERNEL_TOL = 1e-4


def _golden_frames(khz: int) -> list:
    """F frames of the golden SILK stream at khz for two streams, the
    second with the interpolation flag inverted, as dicts of arrays."""
    payloads = load_mono_mix()[{16: 1, 8: 2}[khz]].payloads
    hosts = [NativeSilkHost(), NativeSilkHost()]
    out = []
    for f in range(F):
        sym = [h.decode_symbols(payloads[f], khz) for h in hosts]
        frame = {k: np.stack([np.asarray(d[k], dtype) for d in sym])
                 for k, dtype in (("exc", np.float32), ("a", np.float32),
                                  ("b", np.float32), ("pitch_l", np.int32),
                                  ("gains", np.float32), ("voiced", bool),
                                  ("ltp_scale", np.float32))}
        frame["interp"] = np.array([sym[0]["interp"], not sym[1]["interp"]])
        out.append(frame)
    return out


def _run_frames(frames, khz, step, device="cpu", prepare=cases.params):
    """The outputs and states of `step` over the frames, state carried."""
    S = frames[0]["exc"].shape[0]
    state = ss.init_silk_state(S, khz, device)
    got = []
    for frame in frames:
        out, state = step(prepare(frame, device), state,
                          **cases.step_kwargs(khz))
        got.append((out, *state))
    return got


def _bit_equal(got, want, what):
    for f, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(("out", "out_hist", "lpc_hist"), g, w):
            assert torch.equal(a, b), f"{what}: frame {f} {name} differs"


@pytest.mark.parametrize("khz", [16, 8])
def test_host_build_equals_plain_on_golden_symbols(khz):
    frames = _golden_frames(khz)
    want = _run_frames(frames, khz, ss.silk_synthesis_step_reference)
    _bit_equal(_run_frames(frames, khz, ss.silk_synthesis_step_host), want,
               f"golden {khz} kHz")
    interp = np.stack([f["interp"] for f in frames])
    assert interp.any() and not interp.all()
    assert float(want[-1][0].abs().max()) > 1000.0


@pytest.mark.parametrize("khz", [12, 16, 8])
def test_host_build_equals_plain_on_seeded_frames(khz):
    frames = cases.frames(np.random.default_rng(khz), khz, F)
    want = _run_frames(frames, khz, ss.silk_synthesis_step_reference)
    _bit_equal(_run_frames(frames, khz, ss.silk_synthesis_step_host), want,
               f"seeded {khz} kHz")
    voiced = np.stack([f["voiced"] for f in frames])
    interp = np.stack([f["interp"] for f in frames])
    assert voiced.any() and not voiced.all()
    assert (interp & voiced).any() and (~interp & voiced).any()
    pitch = np.stack([f["pitch_l"] for f in frames])
    assert (pitch[voiced] == 18).any() and (pitch[voiced] == 18 * khz).any()
    if khz == 12:
        # chunk 7 (samples 56-63) takes subframe 0's lag for 60-63
        sub = cases.step_kwargs(khz)["subfr_len"]
        assert (7 * ss.CHUNK) // sub == 0 < (8 * ss.CHUNK - 1) // sub
        assert (pitch[voiced][:, 0] != pitch[voiced][:, 1]).any()
    peak = max(float(g[0].abs().max()) for g in want)
    assert 1000.0 < peak < 65536.0


def _lane_layout(frame: dict, device="cpu") -> ss.SilkFrameParams:
    """The mixed decoder's lane: the float parameters as views of one
    (S, 377) plane, pitch_l int64, voiced and interp computed planes."""
    S = frame["exc"].shape[0]
    sf = torch.zeros((S, 377), dtype=torch.float32, device=device)
    sf[:, :320] = torch.as_tensor(frame["exc"], device=device)
    sf[:, 320:352] = torch.as_tensor(frame["a"], device=device).reshape(S, 32)
    sf[:, 352:372] = torch.as_tensor(frame["b"], device=device).reshape(S, 20)
    sf[:, 372:376] = torch.as_tensor(frame["gains"], device=device)
    sf[:, 376] = torch.as_tensor(frame["ltp_scale"], device=device)
    return ss.SilkFrameParams(
        exc=sf[:, :320], a=sf[:, 320:352].reshape(S, 2, 16),
        b=sf[:, 352:372].reshape(S, 4, 5),
        pitch_l=torch.as_tensor(frame["pitch_l"], device=device).long(),
        gains=sf[:, 372:376],
        voiced=torch.as_tensor(frame["voiced"], device=device),
        ltp_scale=sf[:, 376],
        interp=torch.as_tensor(frame["interp"], device=device))


def test_host_build_takes_the_lane_layout():
    frames = cases.frames(np.random.default_rng(3), 16, 4)
    lane = _lane_layout(frames[0])
    assert not lane.exc.is_contiguous() and lane.ltp_scale.stride(0) == 377
    want = _run_frames(frames, 16, ss.silk_synthesis_step_reference)
    _bit_equal(_run_frames(frames, 16, ss.silk_synthesis_step_host,
                           prepare=_lane_layout), want, "lane layout")


def test_cpu_route_and_argument_checks():
    """CPU tensors take the plain version (no launch); interp=None is no
    interpolation on both routes; a dtype, shape, frame or device the
    kernel does not take raises."""
    frame = cases.frames(np.random.default_rng(4), 16, 1)[0]
    p = cases.params(frame)
    state = ss.init_silk_state(len(frame["exc"]), 16, "cpu")
    ss.reset_launches()
    out, new = ss.silk_synthesis_step(p, state)
    want, want_new = ss.silk_synthesis_step_reference(p, state)
    assert ss.silk_synthesis_launches == 0
    assert torch.equal(out, want) and torch.equal(new[1], want_new[1])
    off = p._replace(interp=torch.zeros_like(p.interp))
    for step in (ss.silk_synthesis_step_reference,
                 ss.silk_synthesis_step_host):
        a, _ = step(p._replace(interp=None), state)
        assert torch.equal(a, step(off, state)[0])
    with pytest.raises(TypeError, match="exc"):
        ss.silk_synthesis_step_host(p._replace(exc=p.exc.double()), state)
    with pytest.raises(TypeError, match="gains"):
        ss.silk_synthesis_step_host(p._replace(gains=p.gains[:, :3]), state)
    with pytest.raises(ValueError, match="L=100"):
        ss.silk_synthesis_step_host(p._replace(exc=p.exc[:, :100]), state,
                                    subfr_len=25)
    with pytest.raises(ValueError, match="is on"):
        ss.silk_synthesis_step_host(p._replace(exc=p.exc.to("meta")),
                                    state)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ss.silk_synthesis_step(p._replace(exc=p.exc.to("meta")), state)


@pytest.mark.cuda
def test_kernel_matches_plain_on_gpu():
    """The kernel against the plain version on the card and the host build
    on the CPU over 12 carried frames at 8, 12 and 16 kHz (needs the
    card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    for khz in (8, 12, 16):
        frames = cases.frames(np.random.default_rng(khz), khz, F, 64)
        if khz != 12:
            frames = [{k: np.concatenate([f[k], g[k]]) for k in f}
                      for f, g in zip(frames, _golden_frames(khz))]
        ss.reset_launches()
        got = _run_frames(frames, khz, ss.silk_synthesis_step, "cuda")
        torch.cuda.synchronize()
        assert ss.silk_synthesis_launches == F
        want = _run_frames(frames, khz, ss.silk_synthesis_step_reference,
                           "cuda")
        for f, (g, w) in enumerate(zip(got, want)):
            tol = KERNEL_TOL * float(w[0].abs().max())
            for name, a, b in zip(("out", "out_hist", "lpc_hist"), g, w):
                err = float((a - b).abs().max())
                assert err <= tol, (khz, f, name, err, tol)
        host = _run_frames(frames, khz, ss.silk_synthesis_step_host)
        _bit_equal([tuple(t.cpu() for t in g) for g in got], host,
                   f"kernel vs host build at {khz} kHz")
