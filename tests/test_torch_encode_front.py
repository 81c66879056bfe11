"""mousiki_tpu_torch.ops.encode_front against mousiki_tpu's
ops/encode_front_jax on the same seeded PCM: every decision equal, the
spectrum and the state within 1e-4 of their scale, with the state threaded
through 8 frames; the chunked scan against single steps; the Toeplitz
forms of the three recurrences against the reference's scans; and a
hand-over of the state from JAX mid-stream.

The Toeplitz recurrences, the loop count and the shape checks are in
tests/test_torch_encode_front_scans.py. (Split so that each of the
port's test files holds at most 8 cases: the tier-1 suite then starts
its longest file early.)
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mousiki_tpu.ops import encode_front_jax as ref  # noqa: E402
from mousiki_tpu.testing import oracle  # noqa: E402
from mousiki_tpu_torch import convert  # noqa: E402
from mousiki_tpu_torch.ops import encode_front as front  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

S = 2
INT_KEYS = ("silence", "pf_on", "pitch_index", "qg", "is_transient")
FLOAT_KEYS = ("tone_freq", "toneishness", "gain1", "tf_estimate")
REL = 1e-4
# a pitch decision may flip between two candidates whose scores differ by
# less than this (relative); such a frame is excused, and printed
KNIFE_EDGE = 1e-5


def _signal(n_frames, channels, kind="music", seed=0, frame=960):
    """The signals of tests/test_encode_pipeline.py."""
    n = frame * n_frames
    sig = oracle.make_test_signal(n, channels, seed=seed)
    if kind == "clicks":
        rng = np.random.default_rng(seed)
        for p in rng.integers(frame, n - frame, 6):
            sig[p: p + 120] += 0.5 * rng.standard_normal((120, channels))
    return np.clip(sig, -0.95, 0.95).astype(np.float32)


def _batch(channels, kind, n_frames, frame=960):
    sigs = [_signal(n_frames, channels, kind, seed=s, frame=frame)
            for s in range(S)]
    return np.stack([np.stack([sigs[s][f * frame:(f + 1) * frame]
                               for s in range(S)]) for f in range(n_frames)])


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = max(np.abs(want).max(), 1.0)
    err = np.abs(got - want).max()
    assert err <= REL * scale, (what, err, scale)
    return err / scale


def _pitch_margin(state_np, pcm, frame):
    """Relative margin between the two best coarse pitch scores of each
    stream, recomputed in float64 from the reference's state."""
    pre_mem = np.asarray(state_np["preemph_mem"], np.float64)
    x = np.transpose(pcm, (0, 2, 1)).astype(np.float64) * 32768.0
    prev = np.concatenate([pre_mem[..., None] / 0.85, x[..., :-1]], -1)
    pre = x - 0.85 * prev
    mono = np.concatenate([np.asarray(state_np["pf_mem"],
                                      np.float64).mean(1), pre.mean(1)], -1)
    lp = 0.5 * (mono[:, 0::2] + mono[:, 1::2])
    half = frame // 2
    fr = lp[:, -half:]
    nlp = lp.shape[-1]
    margins = []
    for s in range(lp.shape[0]):
        sc = []
        for lag in range(8, min(511, nlp - half - 1)):
            seg = lp[s, nlp - half - lag: nlp - lag]
            c = fr[s] @ seg
            sc.append(c / np.sqrt((fr[s] @ fr[s] + 1e-9)
                                  * (seg @ seg + 1e-9)) if c > 0 else 0.0)
        top = np.sort(sc)[-2:]
        margins.append((top[1] - top[0]) / max(top[1], 1e-30))
    return margins


def _run_both(channels, kind, n_frames, frame):
    pcms = _batch(channels, kind, n_frames, frame)
    jc = ref.make_front_consts(frame)
    js = ref.init_front_state(S, channels, frame)
    tc = front.make_front_consts(frame, "cpu")
    ts = front.init_front_state(S, channels, frame, "cpu")
    nbytes = np.full(S, 320, np.int32)
    rng = np.random.default_rng(5)
    excused = 0
    worst = {"freq": 0.0, "floats": 0.0, "state": 0.0}
    for f in range(n_frames):
        tapset = rng.integers(0, 3, S).astype(np.int32)
        js_before = {k: np.asarray(v) for k, v in js.items()}
        jo, js = ref.front_step(jc, js, jnp.asarray(pcms[f]),
                                jnp.asarray(nbytes), jnp.asarray(tapset),
                                channels=channels, frame=frame)
        to, ts = front.front_step(tc, ts, torch.from_numpy(pcms[f]),
                                  torch.from_numpy(nbytes),
                                  torch.from_numpy(tapset))
        flipped = [k for k in INT_KEYS
                   if not np.array_equal(to[k].numpy(), np.asarray(jo[k]))]
        if flipped:
            margins = _pitch_margin(js_before, pcms[f], frame)
            print(f"frame {f}: {flipped} differ; pitch "
                  f"{to['pitch_index'].numpy()} vs "
                  f"{np.asarray(jo['pitch_index'])}, score margins "
                  f"{margins}")
            assert min(margins) < KNIFE_EDGE, (f, flipped, margins)
            excused += 1
            # continue from the reference's state: the flip is its own
            # frame's, not the later frames'
            ts = convert.front_state_from_numpy(
                {k: np.asarray(v) for k, v in js.items()}, "cpu")
            continue
        for k in INT_KEYS:
            assert to[k].dtype == (torch.bool if jo[k].dtype == bool
                                   else torch.int32), k
        worst["freq"] = max(worst["freq"], _close(
            to["freq"].numpy(), jo["freq"], f"freq frame {f}"))
        for k in FLOAT_KEYS:
            worst["floats"] = max(worst["floats"], _close(
                to[k].numpy(), jo[k], f"{k} frame {f}"))
        for k, v in ts._asdict().items():
            worst["state"] = max(worst["state"], _close(
                v.numpy(), js[k], f"state {k} frame {f}"))
    print(f"C={channels} {kind} frame {frame}: worst error over its scale "
          f"{worst}, frames excused {excused}")
    assert excused <= 1, excused
    return to, ts


@pytest.mark.parametrize("channels,kind,frame", [
    (2, "music", 960), (1, "music", 960), (2, "clicks", 960),
    (2, "music", 480), (1, "clicks", 480)])
def test_front_step_matches_jax(channels, kind, frame):
    out, state = _run_both(channels, kind, 8, frame)
    assert out["freq"].shape == (S, channels, frame)
    assert state.pf_period.dtype == torch.int32
    assert state.pf_tapset.dtype == torch.int32


def test_front_scan_equals_steps_and_compact():
    K, channels = 4, 2
    pcms = torch.from_numpy(_batch(channels, "clicks", K))
    consts = front.make_front_consts(960, "cpu")
    nbytes = torch.full((S,), 320, dtype=torch.int32)
    tapset = torch.tensor([1, 2], dtype=torch.int32)
    st = front.init_front_state(S, channels, 960, "cpu")
    steps = []
    for k in range(K):
        o, st = front.front_step(consts, st, pcms[k], nbytes, tapset)
        steps.append(o)
    outs, st_scan = front.front_scan(
        consts, front.init_front_state(S, channels, 960, "cpu"), pcms,
        nbytes, tapset)
    for key in steps[0]:
        assert outs[key].shape[0] == K
        for k in range(K):
            assert torch.equal(outs[key][k], steps[k][key]), (key, k)
    for a, b in zip(st_scan, st):
        assert torch.equal(a, b)
    compact, _ = front.front_scan(
        consts, front.init_front_state(S, channels, 960, "cpu"), pcms,
        nbytes, tapset, compact=True)
    assert compact["freq"].dtype == torch.float16
    assert torch.equal(compact["freq"], outs["freq"].to(torch.float16))
    assert compact["qg"].dtype == torch.int32


def test_front_state_handover_from_jax():
    """Four frames in JAX, the state across through convert.py, four more
    in the port: as if the stream had been the port's all along."""
    channels, frame, n = 2, 960, 8
    pcms = _batch(channels, "music", n)
    jc = ref.make_front_consts(frame)
    js = ref.init_front_state(S, channels, frame)
    nbytes = np.full(S, 320, np.int32)
    tapset = np.zeros(S, np.int32)
    args = (jnp.asarray(nbytes), jnp.asarray(tapset))
    for f in range(4):
        _, js = ref.front_step(jc, js, jnp.asarray(pcms[f]), *args,
                               channels=channels, frame=frame)
    ts = convert.front_state_from_numpy(
        {k: np.asarray(v) for k, v in js.items()}, "cpu")
    back = convert.front_state_to_numpy(ts)
    for k, v in js.items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
        assert back[k].dtype == np.asarray(v).dtype, k
    tc = front.make_front_consts(frame, "cpu")
    for f in range(4, n):
        jo, js = ref.front_step(jc, js, jnp.asarray(pcms[f]), *args,
                                channels=channels, frame=frame)
        to, ts = front.front_step(tc, ts, torch.from_numpy(pcms[f]),
                                  torch.from_numpy(nbytes),
                                  torch.from_numpy(tapset))
        for k in INT_KEYS:
            np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]))
        _close(to["freq"].numpy(), jo["freq"], f"freq frame {f}")
