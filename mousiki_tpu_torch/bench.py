"""Headline benchmark of the port: end-to-end aggregate realtime-x of
batched 48 kHz stereo CELT decode on one NVIDIA GPU, with the phases,
traffic, metric key and quality gate of the JAX package's `bench.py`.

    python3 bench_torch.py [S] [--quick] [--s-big N] [--device cpu]

Pipeline measured (`pipeline.CeltStreamPipeline(use_plan=True)`):
packets -> native C++ host symbol-only decode (packed band plans) -> one
packed-arena host-to-device copy -> the device step (band reconstruction,
IMDCT synthesis, postfilter, the de-emphasis kernel). Every window's
clock stops after the device has finished its last frame.

The packets and libopus's side of the quality gate come from a committed
fixture (`testdata/bench_fixture.npz`, made by
`tools/gen_torch_bench_fixture.py` where libopus is installed): the
card's host has no libopus. The gate decodes the fixture's packets
through the same pipeline and runs the repo's opus_compare
(`tools/opus_compare.py`) against libopus's float decode, on the
synthetic signal and on the music corpus.

Prints ONE JSON line on stdout with `bench.py`'s keys, the card's name and
power limit; phase seconds go to stderr. Any failure (no GPU without
`--device cpu`, a missing fixture, a library that does not build, a
kernel that does not launch) raises: no line then claims a result. A
failed quality gate prints its line with "quality_gate": "FAIL" and exits
with code 1.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import wave
from dataclasses import dataclass

import numpy as np
import torch

from . import _device
from .hostcodec.testing.oracle import make_test_signal
from .parallel.deep_recovery import BatchedDeepRecovery
from .pipeline import (SERVING_PROFILE, CeltEncodePipeline,
                       CeltStreamPipeline, OpusStreamPipeline,
                       set_plan_profile)

N_FRAMES = 48
NORTH_STAR = 5000.0
METRIC = "aggregate_realtime_x_celt_48k_stereo_decode_e2e"
GATE_STREAMS = 8
FRAME = 960
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(_ROOT, "testdata", "bench_fixture.npz")
GENERATOR = "tools/gen_torch_bench_fixture.py"
SIGNALS = ("synthetic", "corpus")


@dataclass(frozen=True)
class Windows:
    """How long each phase measures. FULL is bench.py's; QUICK is for the
    smoke run and the tests."""
    n_win: int = 8              # windows a mode; the median is reported
    e2e_steps: int = 128        # steps of all windows at S
    big_steps: int = 32         # the same at S = s_big
    warm: int = 8               # warm-up frames of the stream mode
    chunk_warm: int = 2         # warm-up chunks of each chunked mode
    mixed_steps: int = 128
    mixed_warm: int = 4
    dred_windows: int = 6
    dred_calls: int = 10        # conceal calls a window
    encode_steps: int = 24
    gate_frames: int | None = None   # None: every frame of each signal


FULL = Windows()
QUICK = Windows(n_win=2, e2e_steps=8, big_steps=8, warm=2, chunk_warm=1,
                mixed_steps=4, mixed_warm=2, dred_windows=2, dred_calls=2,
                encode_steps=8, gate_frames=16)


# ------------------------------------------------------------ helpers

def downmix_16k(pcm48):
    """(N, C) 48 kHz float -> 16 kHz mono via windowed-sinc decimation."""
    mono = np.asarray(pcm48, np.float64).mean(axis=1)
    taps = 96
    t = np.arange(-taps, taps + 1, dtype=np.float64)
    h = np.sinc(t / 3.0) / 3.0 * np.hanning(2 * taps + 1)
    filt = np.convolve(mono, h, mode="same")
    return filt[::3].astype(np.float32)


def load_corpus():
    """Committed music-like corpus (testdata/corpus.wav, 48 kHz stereo
    16-bit; see tools/gen_bench_corpus.py). Returns float32 (N, 2) or
    None."""
    path = os.path.join(_ROOT, "testdata", "corpus.wav")
    if not os.path.exists(path):
        return None
    with wave.open(path, "rb") as w:
        n = w.getnframes()
        raw = w.readframes(n)
    x = np.frombuffer(raw, "<i2").reshape(-1, 2)
    return x.astype(np.float32) / 32768.0


def _blob(packets: list) -> tuple[np.ndarray, np.ndarray]:
    lens = np.asarray([len(p) for p in packets], np.int32)
    return np.frombuffer(b"".join(packets), np.uint8), lens


def _unblob(blob: np.ndarray, lens: np.ndarray) -> list:
    ends = np.cumsum(lens)
    raw = blob.tobytes()
    return [raw[e - n:e] for e, n in zip(ends.tolist(), lens.tolist())]


def save_fixture(path: str, fx: dict) -> None:
    """Write a fixture of load_fixture's form: each byte string list as
    one uint8 blob and its lengths, so the file loads without pickle."""
    arrays = {"libopus": np.asarray(fx["libopus"])}
    for name in SIGNALS:
        sig = fx[name]
        for key in ("packets", "payloads"):
            arrays[f"{name}_{key}"], arrays[f"{name}_{key}_len"] = \
                _blob(sig[key])
        arrays[f"{name}_final_range"] = np.asarray(sig["final_range"],
                                                   np.uint32)
        arrays[f"{name}_ref16k"] = np.asarray(sig["ref16k"], np.float32)
        arrays[f"{name}_ref16k_quick"] = np.asarray(sig["ref16k_quick"],
                                                    np.float32)
    mixed = fx["mixed"]
    arrays["mixed_packets"], arrays["mixed_packets_len"] = _blob(
        [p for stream in mixed["packets"] for p in stream])
    arrays["mixed_final_range"] = np.asarray(mixed["final_range"],
                                             np.uint32)
    np.savez_compressed(path, **arrays)


def load_fixture(path: str = FIXTURE) -> dict:
    """The bench's packets and libopus's side of its gate.

    Returns {"libopus": version, "synthetic": sig, "corpus": sig,
    "mixed": {"packets": 3 lists of 24 mono packets, "final_range":
    (3, 24)}}, each sig {"packets": full Opus packets, "payloads": their
    CELT frames, "final_range": libopus's after decoding each packet,
    "ref16k": downmix_16k of libopus's float decode of every packet,
    "ref16k_quick": the same of the first QUICK.gate_frames}."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path}: the bench fixture is missing; make it with "
            f"`python3 {GENERATOR}` where libopus is installed")
    with np.load(path, allow_pickle=False) as z:
        fx = {"libopus": str(z["libopus"])}
        for name in SIGNALS:
            fx[name] = {
                "packets": _unblob(z[f"{name}_packets"],
                                   z[f"{name}_packets_len"]),
                "payloads": _unblob(z[f"{name}_payloads"],
                                    z[f"{name}_payloads_len"]),
                "final_range": z[f"{name}_final_range"],
                "ref16k": z[f"{name}_ref16k"],
                "ref16k_quick": z[f"{name}_ref16k_quick"]}
        flat = _unblob(z["mixed_packets"], z["mixed_packets_len"])
        rng = z["mixed_final_range"]
        n = rng.shape[1]
        fx["mixed"] = {"packets": [flat[i * n:(i + 1) * n]
                                   for i in range(rng.shape[0])],
                       "final_range": rng}
    return fx


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ------------------------------------------------------------- phases

def _gate_one(payloads, ref16k, dev):
    """Gate decode through the production plan path (native host symbol
    decode -> packed arena -> device step), all frames in one scanned
    dispatch. The gate batch is fixed at 8 streams (independent of the
    perf batch size); stream 0 carries the compared signal. Returns the
    opus_compare result against `ref16k` and stream 0's (N, 2) PCM."""
    tools = os.path.join(_ROOT, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    from opus_compare import compare

    gs = GATE_STREAMS
    pipe = CeltStreamPipeline(gs, 2, use_plan=True, device=dev)
    pcm = pipe.decode_frames_scanned([[p] * gs for p in payloads], FRAME)
    ours = pcm[:, 0].cpu().numpy().reshape(-1, 2)
    r = compare(32768.0 * np.asarray(ref16k, np.float64),
                32768.0 * downmix_16k(ours))
    return r, ours


def quality_gate(fx: dict, dev, n_frames: int | None = None) -> dict:
    """The plan pipeline against libopus's float decode, on the synthetic
    perf signal and on the music corpus (every frame, or the first
    n_frames == QUICK.gate_frames of each)."""
    if n_frames not in (None, QUICK.gate_frames):
        raise ValueError(f"the fixture holds references of all frames and "
                         f"of the first {QUICK.gate_frames}, not {n_frames}")
    key = "ref16k" if n_frames is None else "ref16k_quick"
    syn, cor = fx["synthetic"], fx["corpus"]
    r, _ = _gate_one(syn["payloads"][:n_frames], syn[key], dev)
    out = {"pass": bool(r["ok"]), "err4": round(float(r["err4"]), 4),
           "err16": round(float(r["err16"]), 4),
           "pitch": round(float(r["pitch"]), 4)}
    rc, _ = _gate_one(cor["payloads"][:n_frames], cor[key], dev)
    out["corpus_err4"] = round(float(rc["err4"]), 4)
    out["corpus_err16"] = round(float(rc["err16"]), 4)
    out["pass"] = out["pass"] and bool(rc["ok"])
    return out


def e2e_window(pipe, payloads, n: int, off: int = 0, chunk: int = 1):
    """Decode n steps of heterogeneous traffic (stream s plays frame
    (off + i + s) % nf at step i) through `decode_stream`; returns the
    wall seconds. Every yielded frame is finished PCM."""
    nf, S = len(payloads), pipe.S
    frames = ([payloads[(off + i + s) % nf] for s in range(S)]
              for i in range(n))
    t0 = time.perf_counter()
    for _ in pipe.decode_stream(frames, FRAME, chunk=chunk):
        pass
    return time.perf_counter() - t0


def bench_e2e(payloads, S, dev, win: Windows = FULL, n_steps=None,
              chunks=(4, 8)):
    """Steady-state end-to-end rate through the plan pipeline: the median
    of win.n_win windows of the stream mode and of each chunked mode
    (`chunk` frames a device dispatch, at chunk * 20 ms of added
    latency). Streams are heterogeneous, so the device sees uncorrelated
    per-stream plans. Returns (the pipeline, median rates {mode: x},
    window rates {mode: [x]})."""
    n_steps = win.e2e_steps if n_steps is None else n_steps
    pipe = CeltStreamPipeline(S, 2, use_plan=True, device=dev)
    e2e_window(pipe, payloads, win.warm)                  # build + warm
    windows = {}
    n = max(4, n_steps // win.n_win)
    windows["stream"] = [S * n * 0.02 / e2e_window(pipe, payloads, n, w * n)
                         for w in range(win.n_win)]
    for ck in chunks:
        e2e_window(pipe, payloads, ck * win.chunk_warm, chunk=ck)
        n = max(ck, n_steps // win.n_win)
        windows[f"chunk{ck}"] = [
            S * n * 0.02 / e2e_window(pipe, payloads, n, w * n, chunk=ck)
            for w in range(win.n_win)]
    med = {mode: statistics.median(r) for mode, r in windows.items()}
    return pipe, med, windows


def bench_stages(pipe, payloads):
    """The stage breakdown on bench_e2e's pipeline: the host stage a frame
    with its Python glue (us), the native batch call alone on one thread
    (us), each the min of 3 batches (a CPU-bound microbench's best batch
    is its steal-free cost), and the realtime-x of 10 device steps on one
    prepared arena."""
    S, nf, native = pipe.S, len(payloads), pipe._native
    host_us = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        for i in range(10):
            native.decode_plan_arenas(
                [payloads[(i + s) % nf] for s in range(S)], FRAME)
        host_us = min(host_us, (time.perf_counter() - t0) / 10 / S * 1e6)
    core = native.plan_batch_call([payloads[s % nf] for s in range(S)],
                                  FRAME, n_threads=1)
    host_core_us = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(8):
            core()
        host_core_us = min(host_core_us,
                           (time.perf_counter() - t0) / (8 * S) * 1e6)

    args = pipe._host_decode_plan([payloads[s % nf] for s in range(S)],
                                  FRAME)
    _sync(pipe.device)
    t0 = time.perf_counter()
    for _ in range(10):
        _, pipe.state = pipe._plan_step(FRAME, pipe.state, *args)
    _sync(pipe.device)
    device_x = 10 * S * 0.02 / (time.perf_counter() - t0)
    return host_us, host_core_us, device_x


def bench_mixed(streams, S, dev, win: Windows = FULL):
    """Mixed SILK / CELT / hybrid e2e rate through OpusStreamPipeline, with
    the SILK synthesis on the host and then on the device
    (silk_synthesis="device"): the median of win.n_win windows each.
    Stream s plays fixture stream s % 3 at an offset. Returns
    ({"host": x, "device": x}, {"host": [x], "device": [x]})."""
    nf = len(streams[0])

    def frames(n, off=0):
        for i in range(n):
            yield [streams[s % 3][(off + i + s) % nf] for s in range(S)]

    windows = {}
    for silk in ("host", "device"):
        pipe = OpusStreamPipeline(S, silk_synthesis=silk, device=dev)
        for _ in pipe.decode_stream(frames(win.mixed_warm)):
            pass
        rates = []
        n = win.mixed_steps // win.n_win
        for w in range(win.n_win):
            t0 = time.perf_counter()
            for _ in pipe.decode_stream(frames(n, off=w)):
                pass
            rates.append(S * n * 0.02 / (time.perf_counter() - t0))
        windows[silk] = rates
    return {k: statistics.median(r) for k, r in windows.items()}, windows


def bench_encode(dev, S=128, n_steps=24, K=8):
    """CeltEncodePipeline in chunked serving mode: K frames a stream per
    device dispatch + the native symbol back half, after one warm chunk.
    """
    sig = make_test_signal(FRAME * (n_steps + K + 2), 2, seed=7)
    pipe = CeltEncodePipeline(S, 2, 128000, device=dev)

    def chunk(i0):
        return np.stack([np.stack(
            [sig[(i0 + k + s % 2) * FRAME:(i0 + k + s % 2 + 1) * FRAME]
             for s in range(S)]) for k in range(K)])

    pipe.step_chunk(chunk(0))  # build + warm
    t0 = time.perf_counter()
    for _ in pipe.encode_stream(chunk(i) for i in range(0, n_steps, K)):
        pass
    return S * n_steps * 0.02 / (time.perf_counter() - t0)


def bench_deep_recovery(dev, S=64, win: Windows = FULL):
    """Batched DRED concealment synthesis (PitchDNN + FARGAN on the
    device, the synthetic models): aggregate realtime-x of generating
    20 ms of 16 kHz concealment audio a stream a call. Returns (median,
    window rates)."""
    rec = BatchedDeepRecovery(S, device=dev)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((S, 2, 20)).astype(np.float32) * 0.3
    rec.conceal(feats)  # warm
    rates = []
    for _ in range(win.dred_windows):
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(win.dred_calls):
            rec.conceal(feats)
        _sync(dev)
        rates.append(S * win.dred_calls * 0.02
                     / (time.perf_counter() - t0))
    return statistics.median(rates), rates


def _mark(label, t0=[None]):
    """Phase timing to stderr (the JSON line on stdout stays clean)."""
    now = time.perf_counter()
    if t0[0] is not None:
        print(f"[bench] {_mark.prev}: {now - t0[0]:.1f}s", file=sys.stderr,
              flush=True)
    t0[0] = now
    _mark.prev = label


def _card(dev) -> tuple[str, float | None]:
    """(device name, power limit in W as nvidia-smi reads it); the CPU
    has neither card nor limit."""
    if dev.type != "cuda":
        return "cpu", None
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[dev.index or 0]
    watts = float(line.rsplit(",", 1)[1].strip().split()[0])
    return torch.cuda.get_device_name(dev), watts


def run(S: int, dev: torch.device, quick: bool = False,
        s_big: int = 1024) -> dict:
    """Every phase on `dev`, in bench.py's order; returns the result
    line."""
    win = QUICK if quick else FULL
    fx = load_fixture()
    set_plan_profile(*SERVING_PROFILE)
    name, watts = _card(dev)
    result = {
        "metric": METRIC,
        "unit": "x_realtime_per_chip",
        "streams": S,
        "host_cpu_cores": os.cpu_count() or 1,
        "device": name,
        "power_limit_w": watts,
        "libopus_fixture": fx["libopus"],
    }
    payloads = fx["synthetic"]["payloads"]
    _mark("e2e_s256")
    pipe, med, windows = bench_e2e(payloads, S, dev, win)
    host_us, host_core_us, device_x = bench_stages(pipe, payloads)
    del pipe
    _mark("e2e_s1024")
    _, med_big, win_big = bench_e2e(payloads, s_big, dev, win,
                                    n_steps=win.big_steps, chunks=())
    _mark("mixed")
    mixed, win_mixed = bench_mixed(fx["mixed"]["packets"], S, dev, win)
    _mark("dred")
    dred_x, win_dred = bench_deep_recovery(dev, win=win)
    _mark("encode")
    encode_x = bench_encode(dev, n_steps=win.encode_steps)
    _mark("quality_gate")
    gate = quality_gate(fx, dev, win.gate_frames)
    _mark("done")
    # headline: the best of the serving modes, per-frame streaming (20 ms
    # latency) against 4- and 8-frame chunked dispatch (80 / 160 ms)
    best = max(med.values())
    result.update({
        "value": round(best, 1),
        "vs_baseline": round(best / NORTH_STAR, 4),
        "value_stream_20ms": round(med["stream"], 1),
        "value_chunk4_80ms": round(med["chunk4"], 1),
        "value_chunk8_160ms": round(med["chunk8"], 1),
        "host_us_per_frame": round(host_us, 1),
        "host_core_us_per_frame": round(host_core_us, 1),
        "value_s1024": round(med_big["stream"], 1),
        "s_big": s_big,
        "device_only_x": round(device_x, 1),
        "mixed_silk_celt_hybrid_e2e_x": round(mixed["host"], 1),
        "mixed_device_silk_e2e_x": round(mixed["device"], 1),
        "encode_e2e_x_s128": round(encode_x, 1),
        "dred_recovery_x_s64": round(dred_x, 1),
        "quality_gate": "pass" if gate.pop("pass") else "FAIL",
        "quality": gate,
        "windows": {"value_stream_20ms": windows["stream"],
                    "value_chunk4_80ms": windows["chunk4"],
                    "value_chunk8_160ms": windows["chunk8"],
                    "value_s1024": win_big["stream"],
                    "mixed_silk_celt_hybrid_e2e_x": win_mixed["host"],
                    "mixed_device_silk_e2e_x": win_mixed["device"],
                    "dred_recovery_x_s64": win_dred},
    })
    if quick:
        result.update(quick=True, gate_frames=win.gate_frames)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="End-to-end realtime-x of batched CELT decode on the "
                    "card, with its quality gate")
    ap.add_argument("streams", nargs="?", type=int, default=256,
                    help="streams S of the main batch (default 256)")
    ap.add_argument("--s-big", type=int, default=1024,
                    help="streams of the second batch (default 1024)")
    ap.add_argument("--quick", action="store_true",
                    help="short windows, and gate on the first "
                         f"{QUICK.gate_frames} frames of each signal")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu runs everything on the CPU (tests only)")
    args = ap.parse_args(argv)
    dev = (torch.device("cpu") if args.device == "cpu"
           else _device.require_cuda())
    result = run(args.streams, dev, args.quick, args.s_big)
    print(json.dumps(result), flush=True)
    return 0 if result["quality_gate"] == "pass" else 1
