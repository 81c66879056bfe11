"""ms/step and kernel launches of the port's decode steps, the host
time of one SILK quantizer dispatch by span, or the device SILK synthesis
kernel alone, on one GPU, for one or more checkouts of this repository,
in turns.

    python3 tools/torch_step_ab.py --trees DIR_A,DIR_B --order 0,1,1,0 \\
        [--target steps|nsq|silk_syn|neural] [--probe 0,1] [--out FILE]

Each entry of --order runs one child process in that checkout (its
mousiki_tpu_torch and golden_streams.py), so that two versions of the
package are compared on one card in one call (A, B, B, A).

--target steps (the default): a child builds what the package builds at
first use, then times four steps, the four taking turns, three runs
each of 8 steps after warm-up (host wall time a step, the card
synchronised at the end of a run):

  celt         CeltStreamPipeline(256, 2, use_plan=True), golden stereo
               stream s % 3, loss-free;
  celt_lossy   the same with ~10% of the packets lost in every frame
               (seed 7), so that every step conceals;
  mixed        OpusStreamPipeline(256, channels=1) on the five golden
               mono streams, loss-free;
  mixed_device_silk
               the same with silk_synthesis="device" (the wide-band SILK
               streams synthesised on the card);

and counts the kernel launches of one profiled step of each (host-side
launch calls under torch.profiler).

--target nsq: a child tiles the wide-band quantizer calls of a real
encoder run (this checkout's nsq_cases.py, run on the child's package)
over the 256 lanes of an NsqBatchExecutor and, for the delayed-decision
and the single-state quantizer in turn, runs one dispatch to warm up,
three timed (host wall time, the card synchronised by the read-back),
then one under torch.profiler: the host time of the executor's spans
(nsq.h2d, nsq.quantize, nsq.d2h) and the launches in each. Then it times
each kernel call alone by CUDA events (20 calls after a warm-up, queued
behind a sleeping card so that they run back to back) on the calls of
phase 3e of chip_smoke.py: the harvested calls and a copy of each voiced
one without interpolation (nsq_cases.with_branches), tiled over S = 256
lanes with every 17th unused, and spread over S = 1 (NSQ_KERNEL_WIDTHS).

--target silk_syn: a child times silk_synthesis_step's kernel alone by
CUDA events (as above) on the calls of phase 3f of chip_smoke.py: the
first call of OpusStreamPipeline(256, channels=1,
silk_synthesis="device") on the mono mix (the lane's strided views), of
SilkStreamPipeline(256, synthesis="device") at 16 and 8 kHz on the golden
SILK streams (stream s at frame s % 12), the first frame of
silk_synthesis_cases.py's seeded 12 kHz streams at S = 256, and one
voiced, interpolated stream alone (S = 1, its chain) at 16, 12 and 8 kHz.

--target neural: a child times the neural recovery's two kernels alone
by CUDA events (as above) on the calls of phase 3g of chip_smoke.py:
conceal_frames on bench.py's features at S = 64 and 256 from the initial
state, the DeepPlcState route (PitchDNN once, two frames) at S = 1, and
decode_qframes on _seeded_dreds(64) and on its first stream alone.

--probe (nsq and silk_syn; indices into --trees) then builds each of
those checkouts' kernel source with the clock hooks of this checkout's
tools/nsq_probe.cu or tools/silk_syn_probe.cu (a header without hooks of
its own, as before they were added, gets them at the points of
PARENT_HOOKS or SYN_PARENT_HOOKS) and runs each kernel once on the calls
above: the cycles a sample of each part (NsqProbePart, SilkSynProbePart),
warp by warp.

Prints one JSON line a child and writes them all to FILE. Needs a GPU: a
child fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from functools import partial

S = 256
STEPS, WARM, RUNS = 8, 3, 3
NSQ_TIMED = 3
NSQ_KERNEL_WIDTHS = (256, 1)
NSQ_KERNEL_REPS = 20
# the clock probe's parts (csrc/silk_nsq.h NsqProbePart, in its order)
PROBE_PARTS = ("prologue", "reads", "dots", "candidates", "barrier",
               "decisions", "replacement", "emission", "advance", "flush")
PROBE_SLOTS = 16      # tools/nsq_probe.cu kSlots
# The hooks a silk_nsq.h without NSQ_PROBE hooks (the header of the first
# quantizer kernels, threads 0-3 a state) gets for the probe: (the text
# they follow, which occurrence of it, the hook). There the candidates
# hold the dot products, the single state's dots the LTP and harmonic
# reads, and its decision the planes' writes.
PARENT_HOOKS = (
    ("  const bool use_dz = lam > 2.0f;\n", 0, "NSQ_PROBE_BEGIN();"),
    ("    prev_gain = sf.gain;\n    NSQ_SYNC();\n", 0, "NSQ_PROBE(0);"),
    ("        const float n_ltp = nsq_n_ltp(w.shp, harm, t, sf.lag);\n", 0,
     "NSQ_PROBE(2);"),
    ("        w.pulses[n] = q0;\n", 0, "NSQ_PROBE(5);"),
    ("    g.o_prev_gain[s] = prev_gain;\n  }\n", 0,
     "NSQ_PROBE(9); NSQ_PROBE_END();"),
    ("  int lag_state = lag_prev;\n", 0, "NSQ_PROBE_BEGIN();"),
    ("    prev_gain = sf.gain;\n    NSQ_SYNC();\n", 1, "NSQ_PROBE(0);"),
    ("        const float n_ltp = nsq_n_ltp(w.shp, harm, t, sf.lag);\n", 1,
     "NSQ_PROBE(1);"),
    ("        const int last = (head + dd) % NSQ_DD;\n", 0, "NSQ_PROBE(3);"),
    ("        NSQ_SYNC_STATES();\n", 0, "NSQ_PROBE(4);"),
    ("        NSQ_SYNC_STATES();\n", 1, "NSQ_PROBE(5);"),
    ("        NSQ_SYNC_STATES();\n", 2, "NSQ_PROBE(6);"),
    ("        NSQ_SYNC_STATES();\n", 3, "NSQ_PROBE(7);"),
    ("        if (n_lo == 0) w.delayed_gain[head] = sf.gain;\n", 0,
     "NSQ_PROBE(8);"),
    ("    g.seed_used[s] = st.seed_init;\n  }\n", 0,
     "NSQ_PROBE(9); NSQ_PROBE_END();"),
)
# the SILK synthesis probe's parts (csrc/silk_synthesis.h
# SilkSynProbePart, in its order) and slots a warp (tools/silk_syn_probe.cu
# kSlots, kWarps)
SYN_PROBE_PARTS = ("loads", "whiten", "ltp", "lpc", "interp", "wait",
                   "out")
SYN_PROBE_SLOTS, SYN_PROBE_WARPS = 8, 4
# The hooks a silk_synthesis.h without SILK_SYN_PROBE hooks (the header of
# the first kernel, one warp a stream, the parts one after another behind
# barriers) gets for the probe, as PARENT_HOOKS: thread 0's record holds
# each part with the barrier after it (the LPC chain runs on thread 0).
SYN_PARENT_HOOKS = (
    ("  const float ltp_scale = g.ltp_scale[s * st[kSynLtpScale]];\n", 0,
     "SILK_SYN_PROBE_BEGIN();"),
    ("  for (int i = t; i < H; i += nt) w.hist[i] = hist[i];\n"
     "  SILK_SYN_SYNC();\n", 0, "SILK_SYN_PROBE(0);"),
    ("ltp_scale);\n  SILK_SYN_SYNC();\n", 0, "SILK_SYN_PROBE(1);"),
    ("H + half, nb, sl, t,\n               nt);\n", 0,
     "SILK_SYN_PROBE(2);"),
    ("w.y, half);\n  SILK_SYN_SYNC();\n", 0, "SILK_SYN_PROBE(3);"),
    ("w.a[1], i);\n    SILK_SYN_SYNC();\n  }\n", 0, "SILK_SYN_PROBE(4);"),
    ("H + half, H + L, nb, sl, t, nt);\n", 0, "SILK_SYN_PROBE(2);"),
    ("L - half);\n  SILK_SYN_SYNC();\n", 0, "SILK_SYN_PROBE(3);"),
    ("w.y[L - 1 - k];\n", 0, "SILK_SYN_PROBE(6); SILK_SYN_PROBE_END();"),
)
# the rates of the one-stream calls (the chain) of --target silk_syn
SYN_CHAINS = (16, 12, 8)
NSQ_SPANS = ("nsq.h2d", "nsq.quantize", "nsq.d2h")
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _steps_child() -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from golden_streams import frame_batch, load_mono_mix, load_stereo_celt
    from mousiki_tpu_torch.pipeline import (SERVING_PROFILE,
                                            CeltStreamPipeline,
                                            OpusStreamPipeline,
                                            set_plan_profile)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    set_plan_profile(*SERVING_PROFILE)
    stereo, mono = load_stereo_celt(), load_mono_mix()
    lost = np.random.default_rng(7).random((S, 12)) < 0.10
    modes = {
        "celt": (CeltStreamPipeline(S, 2, use_plan=True, device=dev),
                 lambda f: frame_batch(stereo, S, f % 12)),
        "celt_lossy": (CeltStreamPipeline(S, 2, use_plan=True, device=dev),
                       lambda f: frame_batch(stereo, S, f % 12,
                                             lost[:, f % 12])),
        "mixed": (OpusStreamPipeline(S, channels=1, device=dev),
                  lambda f: frame_batch(mono, S, f % 12, packets=True)),
        "mixed_device_silk": (
            OpusStreamPipeline(S, channels=1, silk_synthesis="device",
                               device=dev),
            lambda f: frame_batch(mono, S, f % 12, packets=True)),
    }
    runs = {name: [] for name in modes}
    frame = {name: 0 for name in modes}
    for rep in range(RUNS):
        for name, (pipe, batch) in modes.items():
            for _ in range(WARM if rep == 0 else 1):
                pipe.step(batch(frame[name]))
                frame[name] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(STEPS):
                pipe.step(batch(frame[name]))
                frame[name] += 1
            torch.cuda.synchronize()
            runs[name].append((time.perf_counter() - t0) * 1e3 / STEPS)
    out = {"tree": os.getcwd(), "device": torch.cuda.get_device_name(dev),
           "modes": {}}
    for name, (pipe, batch) in modes.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pipe.step(batch(frame[name]))
            torch.cuda.synchronize()
        launches = sum(1 for ev in prof.events() if ev.name in LAUNCH_CALLS)
        ms = runs[name]
        out["modes"][name] = {"ms_per_step": float(np.median(ms)),
                              "ms_per_step_min": min(ms),
                              "ms_per_step_runs": ms,
                              "launches": launches}
    return out


def _span(ev) -> str:
    """The executor span that holds a profiler event, or "outside"."""
    while ev is not None:
        if ev.name in NSQ_SPANS:
            return ev.name
        ev = ev.cpu_parent
    return "outside"


def _nsq_child() -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(1, HERE)
    import nsq_cases
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    out = {"tree": os.getcwd(), "device": torch.cuda.get_device_name(dev)}
    for del_dec in (True, False):
        ex, reqs = nsq_cases.executor_requests(nsq_cases.harvest(del_dec), S,
                                               del_dec, dev)
        ex._dispatch(reqs)
        wall = []
        for _ in range(NSQ_TIMED):
            t0 = time.perf_counter()
            ex._dispatch(reqs)
            wall.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ex._dispatch(reqs)
        host_ms = {span: 0.0 for span in NSQ_SPANS}
        launches = {span: 0 for span in (*NSQ_SPANS, "outside")}
        cpu = torch.autograd.DeviceType.CPU
        for ev in prof.events():
            if ev.device_type != cpu:
                continue
            if ev.name in NSQ_SPANS:
                host_ms[ev.name] += ev.cpu_time_total / 1e3
            elif ev.name in LAUNCH_CALLS:
                launches[_span(ev.cpu_parent)] += 1
        out["del_dec" if del_dec else "single"] = {
            "dispatch_ms": wall, "dispatch_ms_median": float(np.median(wall)),
            "host_ms_by_span": host_ms, "launches_by_span": launches,
            "kernel_us": {S: _event_us(partial(kernel, *args, **kw))
                          for S, (kernel, args, kw)
                          in _kernel_calls(del_dec, dev).items()}}
    return out


def _kernel_calls(del_dec: bool, dev) -> dict:
    """{S: (wrapper, arguments, keywords)} of one quantizer kernel at each
    of NSQ_KERNEL_WIDTHS, on chip_smoke.py phase 3e's lanes."""
    import numpy as np

    import nsq_cases
    kernel = nsq_cases.ROUTES[del_dec][0]
    kw = dict(nsq_cases.KW, warping=nsq_cases.WARPING) if del_dec \
        else nsq_cases.KW
    calls = nsq_cases.with_branches(nsq_cases.harvest(del_dec))
    out = {}
    for S in NSQ_KERNEL_WIDTHS:
        lanes = np.arange(S) % len(calls) if S > 1 else np.array([0])
        if S > 1:
            lanes[::17] = -1
        out[S] = (kernel, nsq_cases.batch(calls, S, dev, del_dec,
                                          lanes=lanes), kw)
    return out


def _event_us(fn) -> float:
    """Mean µs on the card of a call of `fn`, by CUDA events around each
    of NSQ_KERNEL_REPS calls queued behind a sleeping card (after one
    warm-up call), so that the calls run back to back without the host's
    gaps; fails if the host did not queue them all in time."""
    import torch
    fn()
    for cycles in (1 << 24, 1 << 27):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        woke = torch.cuda.Event()
        woke.record()
        pairs = []
        for _ in range(NSQ_KERNEL_REPS):
            pairs.append((torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True)))
            pairs[-1][0].record()
            fn()
            pairs[-1][1].record()
        queued = not woke.query()
        torch.cuda.synchronize()
        if queued:
            return sum(a.elapsed_time(b) for a, b in pairs) * 1e3 \
                / NSQ_KERNEL_REPS
    raise SystemExit("the kernel calls were not queued before the card woke")


def hooked(src: str, hooks=PARENT_HOOKS) -> str:
    """A header without clock hooks with `hooks` (PARENT_HOOKS for
    silk_nsq.h, SYN_PARENT_HOOKS for silk_synthesis.h) added."""
    for anchor, nth, hook in hooks:
        at = -1
        for _ in range(nth + 1):
            at = src.index(anchor, at + 1)
        at += len(anchor)
        src = src[:at] + hook + "\n" + src[at:]
    return src


def _probe_child() -> dict:
    """This checkout's quantizer kernels built with the clock hooks of
    tools/nsq_probe.cu, one call of each at NSQ_KERNEL_WIDTHS: cycles a
    sample of each part, warp by warp (the mean over the streams)."""
    import ctypes
    import shutil

    import numpy as np
    import torch

    sys.path.insert(1, HERE)
    from mousiki_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    lib, added, tmp = _probe_lib("silk_nsq", "silk_nsq.h", "nsq_probe",
                                 PARENT_HOOKS)
    out = {"tree": os.getcwd(), "device": torch.cuda.get_device_name(dev),
           "hooks_added": added}
    lib.nsq_probe_set.argtypes = [ctypes.c_void_p]
    real = _build._libs.get("silk_nsq")
    _build._libs["silk_nsq"] = lib
    try:
        for del_dec in (True, False):
            for S, (kernel, args, kw) in _kernel_calls(del_dec, dev).items():
                kernel(*args, **kw)
                buf = torch.zeros((S, 4, PROBE_SLOTS), dtype=torch.int64,
                                  device=dev)
                torch.cuda.synchronize()
                assert lib.nsq_probe_set(buf.data_ptr()) == 0
                kernel(*args, **kw)
                torch.cuda.synchronize()
                assert lib.nsq_probe_set(None) == 0
                cyc = buf.cpu().numpy().astype(np.float64) / 320.0
                out[f"{'del_dec' if del_dec else 'single'}_S{S}"] = {
                    f"warp{w}": {name: float(cyc[:, w, i].mean())
                                 for i, name in enumerate(PROBE_PARTS)}
                    for w in range(4)}
    finally:
        if real is None:
            _build._libs.pop("silk_nsq")
        else:
            _build._libs["silk_nsq"] = real
        shutil.rmtree(tmp)
    return out


def _strided_copy(t):
    """A copy of t with its strides (a view of a wider plane stays one)."""
    import torch
    if t is None:
        return None
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device=t.device).copy_(t)


def _syn_calls(dev) -> dict:
    """{label: (params, state, keywords)} of silk_synthesis_step on
    chip_smoke.py phase 3f's calls (see --target silk_syn): a pipeline's
    first call as the pipeline makes it, strides kept."""
    import numpy as np

    import mousiki_tpu_torch.pipeline as pipeline_mod
    import silk_synthesis_cases as cases
    from golden_streams import frame_batch, load_mono_mix
    from mousiki_tpu_torch.ops import silk_synthesis as ss
    from mousiki_tpu_torch.pipeline import (OpusStreamPipeline,
                                            SilkStreamPipeline)
    mono = load_mono_mix()
    out = {}
    step = pipeline_mod.silk_synthesis_step

    def first(label, pipe, batch):
        def grab(params, state, **kw):
            out.setdefault(label, (
                ss.SilkFrameParams(*map(_strided_copy, params)),
                ss.SilkStreamState(*map(_strided_copy, state)), kw))
            return step(params, state, **kw)
        pipeline_mod.silk_synthesis_step = grab
        try:
            pipe.step(batch)
        finally:
            pipeline_mod.silk_synthesis_step = step

    first("mixed_lane", OpusStreamPipeline(
        S, channels=1, silk_synthesis="device", device=dev),
        frame_batch(mono, S, 0, packets=True))
    for khz, k in ((16, 1), (8, 2)):
        first(f"silk{khz}", SilkStreamPipeline(
            S, khz, synthesis="device", device=dev),
            [mono[k].payloads[s % 12] for s in range(S)])
    frame = cases.frames(np.random.default_rng(19), 12, 1, S)[0]
    out["seeded12"] = (cases.params(frame, dev),
                       ss.init_silk_state(S, 12, dev),
                       cases.step_kwargs(12))
    for khz in SYN_CHAINS:
        frame = cases.frames(np.random.default_rng(20), khz, 1)[0]
        out[f"chain{khz}_S1"] = (
            cases.params({k: v[1:2] for k, v in frame.items()}, dev),
            ss.init_silk_state(1, khz, dev), cases.step_kwargs(khz))
    return out


def _syn_child() -> dict:
    """This checkout's SILK synthesis kernel alone by CUDA events on
    _syn_calls, µs a call."""
    import torch

    sys.path.insert(1, HERE)
    from mousiki_tpu_torch.ops import silk_synthesis as ss
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    out = {"tree": os.getcwd(), "device": torch.cuda.get_device_name(dev),
           "kernel_us": {}}
    for label, (params, state, kw) in _syn_calls(dev).items():
        out["kernel_us"][label] = _event_us(
            partial(ss.silk_synthesis_step, params, state, **kw))
    return out


def _neural_calls(dev) -> dict:
    """chip_smoke.py phase 3g's calls (see --target neural), each a
    function of no argument."""
    import torch

    import chip_smoke
    from mousiki_tpu_torch import dred
    from mousiki_tpu_torch.models import deep_plc, fargan
    from mousiki_tpu_torch.models import dred as rdovae

    def seeded(seed, make):
        return make(torch.Generator().manual_seed(seed), device=dev)

    fm, pm = seeded(2, fargan.random_model), seeded(3,
                                                    deep_plc.random_pitchdnn)
    dm = seeded(1, rdovae.random_dec)
    out = {}
    for S in (64, 256):
        out[f"conceal_S{S}"] = partial(
            fargan.conceal_frames, fm, pm, fargan.init_state(fm, S),
            torch.zeros(S, 64, device=dev),
            torch.as_tensor(chip_smoke._bench_features(S), device=dev))
    out["deep_plc_S1"] = partial(
        fargan.conceal_frames, fm, pm, fargan.init_state(fm, 1),
        torch.zeros(1, 64, device=dev),
        torch.as_tensor(chip_smoke._bench_features(1)[:, 0], device=dev),
        frames=2)
    packed = torch.from_numpy(rdovae.pack_latents(
        chip_smoke._seeded_dreds(64), dred.synthetic_stats())[0]).to(dev)
    out["rdovae_S64"] = partial(rdovae.decode_qframes, dm, packed)
    out["rdovae_S1"] = partial(rdovae.decode_qframes, dm, packed[:1])
    return out


def _neural_child() -> dict:
    """This checkout's neural kernels alone by CUDA events on
    _neural_calls, µs a call."""
    import torch

    sys.path.insert(1, HERE)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    out = {"tree": os.getcwd(), "device": torch.cuda.get_device_name(dev),
           "kernel_us": {}}
    for label, call in _neural_calls(dev).items():
        out["kernel_us"][label] = _event_us(call)
    return out


def _probe_lib(source: str, header: str, probe: str, hooks):
    """This checkout's csrc/<source>.cu built with the clock hooks of
    tools/<probe>.cu (the header given PARENT_HOOKS-style `hooks` where it
    has none); returns (library, hooks added, the temporary directory)."""
    import ctypes
    import shutil
    import tempfile

    from mousiki_tpu_torch.ops import _build
    flags = [_build.nvcc_path(), *_build.NVCC_FLAGS]
    tmp = tempfile.mkdtemp()
    text = open(os.path.join(_build.CSRC, header)).read()
    mark = "SILK_SYN_PROBE(" if probe == "silk_syn_probe" else "NSQ_PROBE("
    shutil.copy(os.path.join(_build.CSRC, f"{source}.cu"), tmp)
    with open(os.path.join(tmp, header), "w") as fh:
        fh.write(text if mark in text else hooked(text, hooks))
    lib_path = os.path.join(tmp, f"lib{probe}.so")
    res = subprocess.run([*flags, "-I", tmp, "-o", lib_path,
                          os.path.join(HERE, "tools", f"{probe}.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(res.stderr)
    return ctypes.CDLL(lib_path), mark not in text, tmp


def _syn_probe_child() -> dict:
    """This checkout's SILK synthesis kernel built with the clock hooks of
    tools/silk_syn_probe.cu, one call on each of _syn_calls: cycles a
    sample of each part, warp by warp (the mean over the streams; warps
    that record nothing left out)."""
    import ctypes
    import shutil

    import numpy as np
    import torch

    sys.path.insert(1, HERE)
    from mousiki_tpu_torch.ops import _build
    from mousiki_tpu_torch.ops import silk_synthesis as ss
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    lib, added, tmp = _probe_lib("silk_synthesis", "silk_synthesis.h",
                                 "silk_syn_probe", SYN_PARENT_HOOKS)
    out = {"tree": os.getcwd(), "device": torch.cuda.get_device_name(dev),
           "hooks_added": added}
    lib.silk_syn_probe_set.argtypes = [ctypes.c_void_p]
    real = _build._libs.get("silk_synthesis")
    _build._libs["silk_synthesis"] = lib
    try:
        for label, (params, state, kw) in _syn_calls(dev).items():
            S, L = params.exc.shape
            ss.silk_synthesis_step(params, state, **kw)
            buf = torch.zeros((S, SYN_PROBE_WARPS, SYN_PROBE_SLOTS),
                              dtype=torch.int64, device=dev)
            torch.cuda.synchronize()
            assert lib.silk_syn_probe_set(buf.data_ptr()) == 0
            ss.silk_synthesis_step(params, state, **kw)
            torch.cuda.synchronize()
            assert lib.silk_syn_probe_set(None) == 0
            cyc = buf.cpu().numpy().astype(np.float64) / L
            out[label] = {
                f"warp{w}": {name: float(cyc[:, w, i].mean())
                             for i, name in enumerate(SYN_PROBE_PARTS)}
                for w in range(SYN_PROBE_WARPS) if cyc[:, w].any()}
    finally:
        if real is None:
            _build._libs.pop("silk_synthesis")
        else:
            _build._libs["silk_synthesis"] = real
        shutil.rmtree(tmp)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--child-probe", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--target", choices=("steps", "nsq", "silk_syn",
                                         "neural"),
                    default="steps",
                    help="the decode steps, one quantizer dispatch, the "
                    "SILK synthesis kernel alone or the neural kernels "
                    "alone")
    ap.add_argument("--trees", help="comma-separated checkouts")
    ap.add_argument("--order", help="comma-separated indices into --trees")
    ap.add_argument("--probe", default="",
                    help="nsq, silk_syn: comma-separated indices into "
                    "--trees to probe")
    ap.add_argument("--out", help="file for the JSON lines")
    args = ap.parse_args()
    if args.child or args.child_probe:
        sys.path.insert(0, os.getcwd())
        if args.child_probe:
            child = (_syn_probe_child if args.target == "silk_syn"
                     else _probe_child)
        else:
            child = {"steps": _steps_child, "nsq": _nsq_child,
                     "silk_syn": _syn_child,
                     "neural": _neural_child}[args.target]
        print(json.dumps(child()), flush=True)
        return 0
    trees = [os.path.abspath(t) for t in args.trees.split(",")]
    order = [int(i) for i in (args.order or ",".join(
        str(i) for i in range(len(trees)))).split(",")]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    lines = []
    probes = [int(i) for i in args.probe.split(",") if i]
    if probes and args.target in ("steps", "neural"):
        ap.error("--probe takes --target nsq or silk_syn")
    for i, mode in [(i, "--child") for i in order] + [
            (i, "--child-probe") for i in probes]:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              mode, "--target", args.target],
                             cwd=trees[i], capture_output=True, text=True)
        if res.returncode != 0:
            sys.stderr.write(res.stdout + res.stderr)
            return res.returncode
        line = json.loads(res.stdout.strip().splitlines()[-1])
        line.update(index=i, card=card.strip())
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.writelines(json.dumps(line) + "\n" for line in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
