"""The lane-split arithmetic of the SILK quantizer kernels (csrc/silk_nsq.h:
a sample's products one a warp lane, the delayed decision a trellis state
a warp) in its host build, bit for bit against the plain versions
(ops/silk_nsq.nsq_frame_reference, nsq_del_dec_frame_reference) on seeded
inputs that a real encoder run rarely reaches:

  * a gain change in every subframe (every state rescaled each time);
  * the shortest lags, so that the decision delay dd is 0-3 and the
    emitted column is read again at the next sample (the delayed
    decision's emission forwarded to the states in registers);
  * lags past 300, so that the re-whitening window clamps at column 319
    and the LTP taps at column 0;
  * small gains and large lambdas, so that a state is replaced at most
    samples (counted in the plain version: its one `torch.where` over the
    states' indices a sample);

at warping 0 and the encoder's 983 * 16 / 65536, order 24 and 16 (the
lane sums exact in nsq_sum's order at both), and order 5 (exact too; its
newest shaping product is not the last one the sum adds, so that sum is
formed whole every sample). Each case runs both quantizers on 8 lanes,
half voiced, half interpolated. Imports no JAX.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mousiki_tpu_torch.ops import _build
from mousiki_tpu_torch.ops import silk_nsq as tnsq
from torch_threads import one_torch_thread  # noqa: F401

KW = dict(nb_subfr=4, sub=80, M=320)
S = 8
WARP = 983 * 16 / 65536.0


def seeded(seed: int, gain_scale=1.0, lam=(0.3, 3.0)):
    """(params, state) fields of S lanes as numpy arrays, from `seed`: a
    stable-ish LPC, LTP taps around a centre tap, a decaying shaping AR,
    noise at int16 scale, gains of 100-2000 (times gain_scale), lags of
    40-250."""
    rng = np.random.default_rng(seed)
    f = np.float32
    a = rng.uniform(-0.5, 0.5, (S, 2, 16)) * 0.85 ** np.arange(16)
    a[:, :, 0] += 0.6
    taps = np.array([0.05, 0.15, 0.5, 0.15, 0.05])
    params = dict(
        x=rng.standard_normal((S, 320)) * 3000.0, a=a,
        b=taps * rng.uniform(0.2, 1.2, (S, 4, 1)),
        ar_shp=rng.uniform(-0.4, 0.4, (S, 4, 24)) * 0.85 ** np.arange(24),
        harm=rng.uniform(0.0, 0.5, (S, 4)), tilt=rng.uniform(-0.3, 0.1, (S, 4)),
        lf_ma=rng.uniform(-0.2, 0.4, (S, 4)),
        lf_ar=rng.uniform(-0.2, 0.4, (S, 4)),
        gains=rng.uniform(100.0, 2000.0, (S, 4)) * gain_scale,
        pitch_l=rng.integers(40, 250, (S, 4)),
        lam=rng.uniform(*lam, S),
        offset=rng.choice([0.0625, 0.09375, 0.1875, 0.25], S),
        voiced=np.arange(S) % 2 == 0,
        seed=rng.integers(-2 ** 31, 2 ** 31 - 1, S),
        ltp_scale=rng.uniform(0.6, 1.0, S),
        interp=np.arange(S) % 4 < 2)
    state = dict(
        xq=rng.standard_normal((S, 320)) * 3000.0,
        shp=rng.standard_normal((S, 320)) * 2.0,
        s_lpc=rng.standard_normal((S, 16)) * 5.0,
        s_ar2=rng.standard_normal((S, 24)),
        s_lf_ar=rng.standard_normal(S), s_diff=rng.standard_normal(S),
        lag_prev=rng.integers(0, 250, S),
        prev_gain=rng.uniform(100.0, 2000.0, S) * gain_scale)
    for group in (params, state):
        for k, v in group.items():
            group[k] = v if v.dtype == bool else v.astype(
                np.int32 if v.dtype.kind == "i" else f)
    return params, state


def gain_changes():
    params, state = seeded(1)
    params["gains"][:, 1::2] *= 1.5       # never equal to the last one
    state["prev_gain"] = params["gains"][:, 0] * 0.5
    return params, state


def short_lags():
    params, state = seeded(2)
    params["pitch_l"] = np.array([[0, 5, 9, 4], [1, 1, 1, 1], [2, 30, 6, 3],
                                  [3, 3, 40, 3], [4, 4, 4, 4], [5, 2, 8, 6],
                                  [6, 6, 6, 6], [3, 50, 60, 70]], np.int32)
    state["lag_prev"] = np.array([4, 1, 3, 2, 4, 5, 0, 3], np.int32)
    return params, state


def clamped_lags():
    params, state = seeded(3)
    params["pitch_l"] = np.random.default_rng(30).integers(
        301, 346, (S, 4)).astype(np.int32)
    state["lag_prev"][:] = 330
    return params, state


def replacements():
    return seeded(4, gain_scale=0.02, lam=(4.0, 10.0))


def short_order():
    return seeded(5)


def decision_delay(params, state) -> np.ndarray:
    """The delayed decision's dd a lane, as the quantizers compute it."""
    lag = np.where(params["voiced"], params["pitch_l"].min(1),
                   state["lag_prev"])
    delay = np.minimum(40, np.maximum(0, lag - 3))
    return np.where(params["voiced"] | (state["lag_prev"] > 0), delay, 40)


def as_tensors(params, state, del_dec):
    cls = tnsq.NsqDelDecState if del_dec else tnsq.NsqDevState
    return (tnsq.NsqParams(**{k: torch.from_numpy(v.copy())
                              for k, v in params.items()}),
            cls(**{k: torch.from_numpy(v.copy()) for k, v in state.items()}))


class Replacements(TorchDispatchMode):
    """Records, a sample, which lanes the plain delayed decision replaces a
    state on: the condition of its one torch.where that picks each state's
    source index ((S, N) bool against (S, 1) and (1, N) int64)."""

    def __init__(self):
        super().__init__()
        self.lanes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if (func is torch.ops.aten.where.self and args[0].dim() == 2
                and args[1].dtype == torch.int64 and args[2].dim() == 2
                and args[2].shape[0] == 1):
            self.lanes.append(args[0].any(1).clone())
        return func(*args, **(kwargs or {}))


def _bit_equal(got, want, what):
    names = ("pulses", "second", *tnsq.NsqDevState._fields)
    for name, g, w in zip(names, (got[0], got[1], *got[2]),
                          (want[0], want[1], *want[2])):
        assert torch.equal(g, w), f"{what}: {name} differs"


CASES = {
    # name: (inputs, warping, order)
    "gain_changes": (gain_changes, WARP, 24),
    "short_lags": (short_lags, 0.0, 24),
    "clamped_lags": (clamped_lags, WARP, 16),
    "replacements": (replacements, 0.0, 16),
    # the newest shaping product is not the last one nsq_sum adds: the
    # shaping sum formed whole every sample
    "short_order": (short_order, WARP, 5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_lanes_equal_the_plain_version(case):
    make, warping, order = CASES[case]
    params, state = make()
    dd = decision_delay(params, state)
    prev = np.concatenate([state["prev_gain"][:, None],
                           params["gains"][:, :-1]], 1)
    if case == "gain_changes":
        assert (params["gains"] != prev).all()
    if case == "short_lags":
        assert set(dd.tolist()) >= {0, 1, 2, 3}, dd
    if case == "clamped_lags":
        assert (params["pitch_l"] + 18 >= 319).all()
    single = as_tensors(params, state, False)
    _bit_equal(tnsq.nsq_frame_host(*single, **KW, order=order),
               tnsq.nsq_frame_reference(*single, **KW, order=order),
               f"{case}: nsq_frame")
    dd_args = as_tensors(params, state, True)
    spy = Replacements()
    with spy:
        want = tnsq.nsq_del_dec_frame_reference(*dd_args, **KW, order=order,
                                                warping=warping)
    assert len(spy.lanes) == 320
    share = torch.stack(spy.lanes).double().mean(0)
    if case == "replacements":
        assert float(share.min()) >= 0.9, share
    _bit_equal(tnsq.nsq_del_dec_frame_host(*dd_args, **KW, order=order,
                                           warping=warping),
               want, f"{case}: nsq_del_dec_frame")


def test_ptxas_report_parses():
    """_build.parse_ptxas on nvcc -Xptxas -v's lines (chip_smoke.py phase
    3e reports the quantizer kernels' registers and spills from it)."""
    text = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__9b772ba8_11_silk_nsq_cu_7d89164518nsq_del_dec_kernelE7NsqArgs' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__9b772ba8_11_silk_nsq_cu_7d89164518nsq_del_dec_kernelE7NsqArgs
    112 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 110 registers, used 1 barriers, 112 bytes cumulative stack size, 14416 bytes smem
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__9b772ba8_11_silk_nsq_cu_7d89164516nsq_frame_kernelE7NsqArgs' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__9b772ba8_11_silk_nsq_cu_7d89164516nsq_frame_kernelE7NsqArgs
    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 56 registers, used 1 barriers, 8 bytes cumulative stack size
"""
    got = _build.parse_ptxas(text)
    assert got == {
        "_ZN44_GLOBAL__N__9b772ba8_11_silk_nsq_cu_7d89164518"
        "nsq_del_dec_kernelE7NsqArgs": dict(
            stack=112, spill_stores=0, spill_loads=0, registers=110,
            smem=14416),
        "_ZN44_GLOBAL__N__9b772ba8_11_silk_nsq_cu_7d89164516"
        "nsq_frame_kernelE7NsqArgs": dict(
            stack=8, spill_stores=8, spill_loads=12, registers=56, smem=0)}
    assert _build.parse_ptxas("nvcc: no entries") == {}
