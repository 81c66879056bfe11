"""The device SILK synthesis kernel's arithmetic as the kernel splits it
(csrc/silk_synthesis.h: the LTP on a producer warp, up to four chunks a
step where the lags keep them apart, an interpolated frame's second half
re-whitened as the LPC chain hands over its output, the chain in rounds of
16 samples with a half's remainder of 8 a round of its own, each sample's
pairs 0-4 on one of 8 sample lanes, refilled with a half's LPC), in its
host build, bit for bit against the plain version
(ops/silk_synthesis.silk_synthesis_step_reference) on seeded frames that
reach each of those paths:

  * halves that are not whole rounds of 16: 12 kHz's 120 and the 40 of a
    10 ms frame at 8 kHz (nb = 2), beside 16 kHz's 160 and 80 and 8 kHz's
    80;
  * lags at and just below the thresholds where chunks c and c + 1, c + 2,
    c + 3 run in one step (18, 26, 34; 17, 25, 33);
  * a lag of 4 (a chunk reads the one it writes) and int32's extremes
    (every index clamped to the plane's first or last position);
  * interpolated voiced frames whose second half's first chunk reads the
    first half's output re-whitened (lag 18: up to its 9th last sample;
    lag 4: all of it; lags 17 and 25: up to the first sample of an 8 the
    chain hands over);
  * unvoiced lanes, interpolated or not, beside voiced ones in one batch;
  * the mixed decoder's lane layout (every parameter a strided view of
    one (S, 377) plane, pitch_l int64).

Also _build.parse_ptxas on the kernel's report lines. Imports no JAX.
"""

import numpy as np
import pytest
import torch

import silk_synthesis_cases as cases
from mousiki_tpu_torch.ops import _build
from mousiki_tpu_torch.ops import silk_synthesis as ss
from torch_threads import one_torch_thread  # noqa: F401

F = 4
I32 = np.iinfo(np.int32)
# stream -> (voiced, interp, lags of the four subframes; a 10 ms frame
# takes the first two)
LANES = (
    (True, True, (18, 18, 18, 18)),
    (True, True, (4, 4, 4, 4)),
    (True, True, (I32.max, I32.max, I32.min, I32.min)),
    (True, False, (17, 25, 33, 34)),
    (True, False, (18, 26, 34, 200)),
    (False, True, (0, 0, 0, 0)),
    (False, False, (0, 0, 0, 0)),
    (True, True, (26, 4, 18, 300)),
    (True, True, (25, 17, 25, 17)),
)


def _frames(khz: int, ms: int, seed: int) -> list:
    """F frames of the LANES streams at khz, ms long, as dicts of arrays
    (silk_synthesis_cases.py's excitation, LPC, taps and gains)."""
    nb = ms // 5
    L = khz * ms
    out = []
    for frame in cases.frames(np.random.default_rng(seed), khz, F,
                              len(LANES)):
        frame = dict(frame, exc=frame["exc"][:, :L], b=frame["b"][:, :nb],
                     gains=frame["gains"][:, :nb])
        frame["voiced"] = np.array([v for v, _, _ in LANES])
        frame["interp"] = np.array([i for _, i, _ in LANES])
        frame["pitch_l"] = np.array([lags[:nb] for _, _, lags in LANES],
                                    np.int32)
        out.append(frame)
    return out


def _run(frames, khz: int, ms: int, step, prepare=cases.params) -> list:
    nb = ms // 5
    state = ss.init_silk_state(len(LANES), khz, "cpu")
    got = []
    for frame in frames:
        out, state = step(prepare(frame), state, nb_subfr=nb,
                          subfr_len=5 * khz)
        got.append((out, *state))
    return got


def _bit_equal(got, want, what):
    for f, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(("out", "out_hist", "lpc_hist"), g, w):
            assert torch.equal(a, b), f"{what}: frame {f} {name} differs"


def _steps(lags, chunk_sub, half_chunks: int) -> set:
    """The numbers of chunks the kernel's LTP runs in its steps over a
    frame of these subframe lags (silk_syn_ltp's rule, each half from its
    first chunk: chunk c + i joins while its lag >= 8 i + 10)."""
    sizes = set()
    for lo, hi in ((0, half_chunks), (half_chunks, len(chunk_sub))):
        c = lo
        while c < hi:
            g = 1
            while (g < 4 and c + g < hi
                   and lags[chunk_sub[c + g]] >= ss.CHUNK * g + 10):
                g += 1
            sizes.add(g)
            c += g
    return sizes


@pytest.mark.parametrize("khz,ms", [(12, 20), (8, 10), (16, 10), (16, 20),
                                    (8, 20)])
def test_split_host_build_equals_plain(khz, ms):
    frames = _frames(khz, ms, 21 + khz + ms)
    want = _run(frames, khz, ms, ss.silk_synthesis_step_reference)
    _bit_equal(_run(frames, khz, ms, ss.silk_synthesis_step_host), want,
               f"{khz} kHz, {ms} ms")
    # the paths the frames reach
    L, sl = khz * ms, 5 * khz
    half = (L // 2 // sl) * sl
    assert (half % 16 == 8) == ((khz, ms) in ((12, 20), (8, 10)))
    nb = ms // 5
    chunk_sub = [min(c * ss.CHUNK // sl, nb - 1) for c in range(L // 8)]
    steps = set().union(*(_steps(lags[:nb], chunk_sub, half // ss.CHUNK)
                          for v, _, lags in LANES if v))
    assert steps == {1, 2, 3, 4}
    second = chunk_sub[half // ss.CHUNK]
    reads_y1 = [lags[second] for v, i, lags in LANES
                if v and i and 0 < lags[second] <= 18]
    assert 18 in reads_y1 and 4 in reads_y1
    peak = max(float(g[0].abs().max()) for g in want)
    assert 100.0 < peak < 65536.0 and all(
        bool(torch.isfinite(t).all()) for g in want for t in g)


def _lane_layout(frame: dict) -> ss.SilkFrameParams:
    """The mixed decoder's lane: the float parameters as views of one
    (S, 377) plane, pitch_l int64."""
    S = frame["exc"].shape[0]
    sf = torch.zeros((S, 377), dtype=torch.float32)
    sf[:, :320] = torch.as_tensor(frame["exc"])
    sf[:, 320:352] = torch.as_tensor(frame["a"]).reshape(S, 32)
    sf[:, 352:372] = torch.as_tensor(frame["b"]).reshape(S, 20)
    sf[:, 372:376] = torch.as_tensor(frame["gains"])
    sf[:, 376] = torch.as_tensor(frame["ltp_scale"])
    return ss.SilkFrameParams(
        exc=sf[:, :320], a=sf[:, 320:352].reshape(S, 2, 16),
        b=sf[:, 352:372].reshape(S, 4, 5),
        pitch_l=torch.as_tensor(frame["pitch_l"]).long(),
        gains=sf[:, 372:376], voiced=torch.as_tensor(frame["voiced"]),
        ltp_scale=sf[:, 376], interp=torch.as_tensor(frame["interp"]))


def test_split_host_build_takes_the_lane_layout():
    frames = _frames(16, 20, 5)
    lane = _lane_layout(frames[0])
    assert not lane.exc.is_contiguous() and lane.ltp_scale.stride(0) == 377
    want = _run(frames, 16, 20, ss.silk_synthesis_step_reference)
    _bit_equal(_run(frames, 16, 20, ss.silk_synthesis_step_host,
                    prepare=_lane_layout), want, "lane layout")


def test_ptxas_report_parses_the_synthesis_kernel():
    """_build.parse_ptxas on nvcc -Xptxas -v's lines for
    silk_synthesis_kernel (chip_smoke.py phase 2 reports its registers,
    stack, spills and shared memory from it)."""
    name = ("_ZN50_GLOBAL__N__b235759e_17_silk_synthesis_cu_59bd16c4"
            "21silk_synthesis_kernelE11SilkSynArgs")
    text = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{name}' for 'sm_90a'
ptxas info    : Function properties for {name}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 8880 bytes smem, 512 bytes cmem[0]
"""
    assert _build.parse_ptxas(text) == {name: dict(
        stack=0, spill_stores=0, spill_loads=0, registers=96, smem=8880)}
