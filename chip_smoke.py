"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Drives mousiki_tpu_torch's stream decoders and encoders end to end on the
card: the plan-mode CELT decoder (48 kHz stereo, 20 ms frames), the mixed
SILK / CELT / hybrid decoder (mono), the CELT encoder (device front +
native symbol encoder), the SILK encoder (host analysis + batched
device quantizer), the neural loss recovery (RDOVAE decode, PitchDNN +
FARGAN concealment, the DRED encoder), the CELT decoder with its Python
host and the single-stream API (OpusDecoder with deep PLC and DRED
decode), with the JAX package nowhere in the process (it fails first
thing if any module of mousiki_tpu is loaded):

  1. device check: a CUDA device, its name and power limit (nvidia-smi);
  2. build, all at once: the three native host libraries (csrc/*.cpp,
     g++: celt_host, silk_host, opus_host) and the fused de-emphasis
     kernel (csrc/deemphasis.cu, nvcc), each with its build time;
  3. kernel vs plain: deemphasis_pcm against deemphasis_pcm_reference on
     the card at (S, C, N) = (256, 2, 960) and (256, 1, 960), the shapes
     the CELT and the mixed main path give it, (32, 2, 960), the
     Python-host CELT path's (phase 19), and (256, 2, 120), (7, 1, 960),
     (3, 2, 240); bar 1e-4 * max|pcm|. For
     each: the kernel's device time (torch.profiler; input in L2 as on the
     main path, and L2 evicted by a 128 MB read before each launch), its
     HBM bound and bound share, the plain
     version's device time, both per-call CUDA-event times, and a copy
     floor (one out.copy_(x.transpose(1, 2)) moving the same bytes: a
     yardstick that does not compute the same function);
  4. main path: CeltStreamPipeline(256, channels=2, use_plan=True) with the
     serving plan profile; stream s plays golden stereo stream s % 3 for
     12 frames; every stream within 2e-4 of the golden PCM, and the kernel
     launched once a step by the path itself (launch counts reset just
     before);
  5. loss: 256 streams with ~10% seeded packet loss, the first 8 streams
     against the port run on the CPU (5e-3 on lost and just-recovered
     frames, 2e-4 elsewhere);
  6. the CELT decoder's other modes at S = 256: decode_frames_scanned,
     decode_stream(chunk=4) and decode_stream with overlap_host each equal
     to the stepped output exactly, and the non-plan path within 2e-4 of
     the golden PCM;
  7. mixed main path: OpusStreamPipeline(256, channels=1); stream s plays
     golden mono stream s % 5 (CELT, SILK 16 kHz, SILK 8 kHz, two hybrid),
     whole packets, 12 frames; every stream within 2e-4 of the golden PCM
     (hybrid_fb_48k from frame 2 on), modes 0, 1 and 2 all present, the
     kernel launched once a step (counts reset just before);
  8. device SILK: SilkStreamPipeline(256, synthesis="device") against
     synthesis="host" on the SILK 16 kHz payloads, SNR above 45 dB; and
     the device-SILK lane of the mixed decoder within 5e-3 of its host
     lane;
  9. mixed loss: ~10% seeded loss on the mono mix, the first 8 streams
     against the port run on the CPU (5e-3 / 2e-4 as in phase 5);
 10. encode front: ops/encode_front.front_step at S = 256, stereo, on the
     golden stereo PCM (stream s replays fixture s % 3), 12 frames with
     the state threaded, against the same function on the CPU: every
     integer and boolean output equal, freq within 1e-4 * max|freq|, the
     float outputs within 1e-4;
 11. CELT encode (the encode side's main path): CeltEncodePipeline(256,
     channels=2, bitrate=128000), the 12 golden frames through step() and
     again through encode_stream() with chunks of 4; every packet
     non-empty; the packets decoded by CeltStreamPipeline on the card and
     held to the input by a band-limited SNR (16 kHz mono downmix, best
     delay), the bar 3 dB under the SNR of the same round trip through the
     port on the CPU in the same run (both printed); the share of packets
     byte-equal to the CPU port's is printed;
 12. SILK quantizers: nsq_frame and nsq_del_dec_frame at S = 256 against
     the CPU port, lanes tiled from the quantizer calls of a real encoder
     run (the copied host encoder on a seeded speech-like signal): share
     of equal pulses a lane >= 0.985 (single state); mean >= 0.9 and half
     the lanes exactly equal (delayed decision); lanes that hold the same
     call give the same pulses; at the first sample of the delayed
     decision, state 0 wins in the lanes where all states tie;
 13. SILK encode: SilkEncodePipeline(8) for 4 frames at 24 kbit/s on the
     golden mono PCM; stream 0's packets equal a one-stream pipeline's,
     and every packet decodes in OpusStreamPipeline to finite PCM;
 14. timing: steady-state ms/step and aggregate realtime-x through
     decode_stream: the CELT decoder at S = 256 (default, overlap_host,
     chunk=4) and S = 1024, the mixed decoder at S = 256 and S = 1024,
     each timed three times (twice at S = 1024), the modes of one width
     taking turns (every run, the least and the median are reported); the
     CELT encoder at
     S = 256 through step() and through encode_stream() with chunks of 8
     (24 frames after 8 of warm-up, three runs in turn); and profiled
     steps (kernel launches, device busy time, host time by stage) of
     both decoders, the device-SILK lane, one encode step and one frame
     of each quantizer;
 15. neural concealment: BatchedDeepRecovery(64) with the port's seeded
     synthetic models, 5 conceal calls of 2 frames on bench.py's features
     (default_rng(0), (64, 2, 20) * 0.3), against the same class on the
     CPU in this run: every PitchDNN period within 1e-3 of the CPU's, an
     integer period that differs (a flip) accepted only where the CPU's
     float lies within 1e-3 of an integer (each flip printed), the PCM
     within 1e-4 in every lane without a flip, all finite;
 16. RDOVAE decode: process() at S = 64 on DRED payloads (dred_encode of
     seeded latents, 26 a stream, synthetic stats, several levels) against
     the CPU port within 1e-4 * max|features|, and two rows against the
     per-stream opus_dred_process on the card;
 17. DRED encode: the copied OpusEncoder(48000, 1) at 24 kbit/s with
     set_dred_duration(40), its RDOVAE encoder on the card (the default:
     no model given), 2 streams x 10 frames; DRED parses from at least 8
     packets a stream, every packet (its padding removed: the native host
     stage takes single-frame packets) decodes to finite PCM in
     OpusStreamPipeline on the card, and the share of packets byte-equal to
     the CPU port's is printed;
 18. neural timing: dred_recovery_x_s64 as bench.py's bench_deep_recovery
     defines it (S = 64, 2 frames a call, 10 calls a window, the median of
     the windows; 3 windows here, not 6, to save time), the same at
     S = 256, the ms of a process call at S = 64 (median of 3), one
     profiled conceal call at each width and one profiled process call;
 19. Python-host CELT: CeltStreamPipeline(32, 2, use_native=False), one
     copied Python CeltDecoder a stream in front of the device synthesis,
     stream s playing golden stereo stream s % 3 for 12 frames; every
     stream within 2e-4 of the golden PCM, the kernel launched once a step
     by the path itself (counts reset just before), the ms a step;
 20. single-stream API (host numpy code, no libopus): the port's
     OpusDecoder over all 8 golden streams (96 packets), every final range
     equal to the fixture's and the PCM within 2e-4 of the golden PCM;
     codec.Decoder equal to OpusDecoder on one stream; a 5.1
     MultistreamEncoder.surround -> MultistreamDecoder round trip on a
     seeded signal, finite; an OggOpusWriter -> OpusFile round trip of one
     golden stream, packets equal;
 21. deep PLC and DRED decode on the card: the port's OpusDecoder(48000, 1)
     with set_deep_plc on the port's seeded FARGAN and PitchDNN and
     set_dred_models on its seeded RDOVAE decoder, on the card and on the
     CPU side by side, over the DRED packets of the copied OpusEncoder
     (as phase 17): 8 good packets, 2 lost and decoded from the DRED of
     the next one (dred_parse, dred_process, dred_decode), that packet,
     one more lost frame concealed without DRED; features and PCM within
     1e-4 of the CPU's, each pitch period flip printed and excused only
     within 1e-3 of an integer; the launches of one deep-PLC
     decode(None, 960).

Any failure raises (exit code != 0). Lines before the last report each
phase; the line before the last is the kernel table as JSON (one row for
each path's shape, every number of a row measured at that shape); the last
line is {"ok": true, "device": {...}}. With --out DIR, everything
measured also goes to DIR/chip_smoke.json, and the profiler's tables of
the profiled steps to DIR/profile_*.txt.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import torch

from golden_streams import (MIX_GOLDEN_FROM, frame_batch, golden_pcm,
                            load_mono_mix, load_stereo_celt)
from mousiki_tpu_torch._device import require_cuda
from mousiki_tpu_torch.ops import _build
from mousiki_tpu_torch.ops import deemphasis as deemph
from mousiki_tpu_torch import dred
from mousiki_tpu_torch.hostcodec.bitstream.repacketizer import \
    opus_packet_unpad
from mousiki_tpu_torch.hostcodec.opus_encoder import OpusEncoder
from mousiki_tpu_torch.models import deep_plc, fargan
from mousiki_tpu_torch.models import dred as rdovae
from mousiki_tpu_torch.ops import encode_front, silk_nsq
from mousiki_tpu_torch.parallel.deep_recovery import BatchedDeepRecovery
from mousiki_tpu_torch.pipeline import (SERVING_PROFILE, CeltEncodePipeline,
                                        CeltStreamPipeline,
                                        OpusStreamPipeline,
                                        SilkEncodePipeline,
                                        SilkStreamPipeline, set_plan_profile)

FRAME = 960
GOLDEN_TOL = 2e-4
KERNEL_REL_TOL = 1e-4
# NVIDIA H100 SXM data sheet peaks (dense, no sparsity, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
S_MAIN, S_WIDE = 256, 1024      # streams of the main paths / the wide timing
S_PYHOST = 32                   # streams of the Python-host CELT path
# (S, C, N) of the kernel's input on the CELT and on the mixed main path,
# and on the Python-host CELT path
CELT_SHAPE, MIXED_SHAPE = (S_MAIN, 2, FRAME), (S_MAIN, 1, FRAME)
PYHOST_SHAPE = (S_PYHOST, 2, FRAME)
KERNEL_SHAPES = (CELT_SHAPE, MIXED_SHAPE, PYHOST_SHAPE, (256, 2, 120),
                 (7, 1, 960), (3, 2, 240))
TIMING_REPEATS = 3
ENCODE_BITRATE = 128000
# the card's CELT encode -> decode round trip may fall this far (dB) under
# the same round trip through the port on the CPU, made in the same run
ENCODE_SNR_MARGIN_DB = 3.0
RESULTS: dict = {}
OUT_DIR: str | None = None


def say(phase: str, **fields) -> None:
    RESULTS.setdefault(phase, {}).update(fields)
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


# ---------------------------------------------------------------- phases

def check_no_jax_package() -> None:
    """The port runs alone: no module of the JAX package is loaded."""
    loaded = sorted(m for m in sys.modules
                    if m == "mousiki_tpu" or m.startswith("mousiki_tpu."))
    check(not loaded, f"modules of the JAX package are loaded: {loaded}")


def phase_device():
    dev = require_cuda()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    say("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        card=repr(card), jax_package_modules=0, jax="jax" in sys.modules)
    return dev, card


def _timed(fn):
    t0 = time.perf_counter()
    fn()
    return round(time.perf_counter() - t0, 3)


def phase_build():
    """g++ for the three host libraries and nvcc for the kernel, started
    together."""
    with ThreadPoolExecutor(max_workers=4) as pool:
        hosts = {name: pool.submit(_timed, partial(_build.build_host, name))
                 for name in _build.HOST_LIBS}
        kernel = pool.submit(_timed, deemph.build_kernel)
        say("build", kernel="csrc/deemphasis.cu",
            kernel_seconds=kernel.result(),
            **{f"{name}_seconds": fut.result()
               for name, fut in hosts.items()})


def _cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int = 20, match: str | None = None,
               between=None) -> float:
    """Mean device time a call of `fn`: the summed durations of the CUDA
    kernels it runs (those whose name holds `match`, if given), under
    torch.profiler; apart from the host time between launches that CUDA
    events also count. `between` runs before each call, unmeasured when
    `match` leaves its kernels out. The profiler now and then drops a
    kernel event, so the time is the mean kernel duration times the
    kernels a call runs; a window in which it saw under half of them is
    measured again, up to three windows."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for window in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if between is not None:
                    between()
                fn()
            torch.cuda.synchronize()
        us = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type == cuda
              and (match is None or match in ev.name)]
        if len(us) >= reps // 2:
            break
        print(f"[profiler] window {window}: {len(us)} kernels seen in "
              f"{reps} calls; measuring again", flush=True)
    check(len(us) >= reps // 2,
          f"profiler saw {len(us)} kernels in {reps} calls")
    per_call = max(1, round(len(us) / reps))
    return sum(us) / len(us) * per_call / 1e3


def bound_ms(S: int, C: int, N: int) -> tuple[float, str, int]:
    """The least time of the fused tail on the card: bytes (each input
    read once, each output written once) over HBM bandwidth, against
    3 flops a sample (fma + scale) over the fp32 peak."""
    nbytes = 4 * (S * C * N + S * C) + 4 * (S * N * C + S * C)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * S * C * N / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def phase_kernel(dev):
    rng = np.random.default_rng(7)
    # 128 MB read between launches evicts the 50 MB L2 with clean lines
    # (a write would leave dirty lines for the kernel to write back)
    flush = torch.zeros(32 << 20, dtype=torch.float32, device=dev)
    table = {}
    for S, C, N in KERNEL_SHAPES:
        x = torch.as_tensor((rng.standard_normal((S, C, N)) * 1000)
                            .astype(np.float32), device=dev)
        mem = torch.as_tensor((rng.standard_normal((S, C)) * 100)
                              .astype(np.float32), device=dev)
        pcm, m = deemph.deemphasis_pcm(x, mem)
        torch.cuda.synchronize()
        want_pcm, want_m = deemph.deemphasis_pcm_reference(x, mem)
        check(pcm.shape == (S, N, C) and pcm.is_contiguous(),
              f"kernel output {tuple(pcm.shape)} at {(S, C, N)}")
        check(bool(torch.isfinite(pcm).all()),
              f"kernel output not finite at {(S, C, N)}")
        scale = want_pcm.abs().max().item()
        err = (pcm - want_pcm).abs().max().item()
        # new_mem is unscaled: held to the same bar in its own units
        err_mem = (m - want_m).abs().max().item() / 32768.0
        check(max(err, err_mem) <= KERNEL_REL_TOL * scale,
              f"kernel vs plain at {(S, C, N)}: {err} / {err_mem} > "
              f"{KERNEL_REL_TOL} * {scale}")
        out = torch.empty_like(pcm)
        run = partial(deemph.deemphasis_pcm, x, mem)
        plain = partial(deemph.deemphasis_pcm_reference, x, mem)
        dev_ms = _device_ms(run, match="deemphasis_pcm_kernel")
        cold_ms = _device_ms(run, match="deemphasis_pcm_kernel",
                             between=flush.sum)
        plain_ms = _device_ms(plain)
        copy_ms = _device_ms(lambda: out.copy_(x.transpose(1, 2)))
        bms, bound_by, nbytes = bound_ms(S, C, N)
        row = dict(max_abs_err=err, bar=KERNEL_REL_TOL * scale,
                   kernel_device_ms=dev_ms,
                   kernel_device_ms_l2_flushed=cold_ms, bound_ms=bms,
                   bound_by=bound_by, bytes=nbytes, bound_share=bms / dev_ms,
                   bound_share_l2_flushed=bms / cold_ms,
                   plain_device_ms=plain_ms, copy_floor_ms=copy_ms,
                   call_ms=_cuda_ms(run, 200),
                   plain_call_ms=_cuda_ms(plain, 50))
        say(f"kernel_{S}x{C}x{N}", **row)
        table[(S, C, N)] = row
    return table


def phase_main_path(dev, streams):
    S, F = S_MAIN, 12
    pipe = CeltStreamPipeline(S, channels=2, use_plan=True, device=dev)
    deemph.reset_launches()
    worst = 0.0
    launches = []
    for f in range(F):
        pcm = pipe.step(frame_batch(streams, S, f), FRAME)
        torch.cuda.synchronize()
        launches.append(deemph.deemphasis_launches)
        got = pcm.cpu().numpy()
        check(got.shape == (S, FRAME, 2), f"pcm shape {got.shape}")
        check(bool(np.isfinite(got).all()), f"non-finite pcm at frame {f}")
        err = np.abs(got - golden_pcm(streams, S, f)).max(axis=(1, 2))
        check(bool((err <= GOLDEN_TOL).all()),
              f"frame {f}: {int((err > GOLDEN_TOL).sum())} streams beyond "
              f"{GOLDEN_TOL}, worst {err.max()}")
        worst = max(worst, float(err.max()))
    n = deemph.deemphasis_launches
    check(all(b - a == 1 for a, b in zip([0] + launches, launches)),
          f"deemphasis launches per step {launches}: one a step expected")
    # the arena is staged in page-locked memory, so its copy is asynchronous
    arena = pipe._native._plan_db[FRAME][1][0][0]["backing"]
    pinned = torch.from_numpy(arena).is_pinned()
    check(pinned, "the plan arena is not in page-locked memory")
    say("main_path", streams=S, frames=F, worst_abs_err_vs_golden=worst,
        bar=GOLDEN_TOL, deemphasis_launches=n,
        launches_after_each_step=launches, arena_pinned=pinned)
    return n, worst


def _loss_phase(phase, dev, make_pipe, batch_fn):
    """S = 256 streams with ~10% seeded packet loss on the card; the first
    8 streams against the same pipeline run on the CPU."""
    S, F, K = S_MAIN, 12, 8
    rng = np.random.default_rng(17)
    lost = rng.random((S, F)) < 0.10
    lost[:, 0] = False
    lost[1, 5:7] = True
    gpu = make_pipe(S, dev)
    cpu = make_pipe(K, "cpu")
    worst_rx, worst_lost = 0.0, 0.0
    for f in range(F):
        batch = batch_fn(S, f, lost[:, f])
        got = gpu.step(batch).cpu().numpy()
        check(bool(np.isfinite(got).all()), f"non-finite pcm at frame {f}")
        want = cpu.step(batch[:K]).numpy()
        for s in range(K):
            err = float(np.abs(got[s] - want[s]).max())
            plc = bool(lost[s, f] or (f and lost[s, f - 1]))
            check(err < (5e-3 if plc else 2e-4),
                  f"{phase} frame {f} stream {s}: {err} "
                  f"(lost={lost[s, f]})")
            if plc:
                worst_lost = max(worst_lost, err)
            else:
                worst_rx = max(worst_rx, err)
    say(phase, streams=S, frames=F, loss_share=float(lost.mean()),
        compared_streams=K, worst_err_received=worst_rx,
        worst_err_concealed=worst_lost)


def phase_loss(dev, streams):
    _loss_phase("loss", dev,
                lambda S, d: CeltStreamPipeline(S, use_plan=True, device=d),
                partial(frame_batch, streams))


def phase_mixed_loss(dev, mono):
    _loss_phase("mixed_loss", dev,
                lambda S, d: OpusStreamPipeline(S, channels=1, device=d),
                partial(frame_batch, mono, packets=True))


def phase_celt_modes(dev, streams):
    """The scanned decode, the chunked stream and the threaded host overlap
    against the stepped output at S = 256 (equal exactly), and the
    non-plan path against the golden PCM."""
    S, F = S_MAIN, 12
    lost = np.zeros((S, F), bool)
    lost[::9, 7] = True                      # concealment inside a chunk
    frames = [frame_batch(streams, S, f, lost[:, f]) for f in range(F)]
    stepped = CeltStreamPipeline(S, use_plan=True, device=dev)
    want = [stepped.step(batch) for batch in frames]

    def run(mode):
        pipe = CeltStreamPipeline(S, use_plan=True, device=dev)
        if mode == "scanned":
            return list(pipe.decode_frames_scanned(frames))
        if mode == "chunk4":
            return list(pipe.decode_stream(iter(frames), chunk=4))
        pipe.overlap_host = True
        return list(pipe.decode_stream(iter(frames)))

    diffs = {}
    for mode in ("scanned", "chunk4", "overlap_host"):
        got = run(mode)
        check(len(got) == F, f"{mode}: {len(got)} frames of {F}")
        diffs[mode] = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
        check(diffs[mode] == 0.0,
              f"{mode} differs from stepped output by {diffs[mode]}")
    nonplan = CeltStreamPipeline(S, use_plan=False, device=dev)
    worst = 0.0
    for f in range(F):
        got = nonplan.step(frame_batch(streams, S, f)).cpu().numpy()
        worst = max(worst,
                    float(np.abs(got - golden_pcm(streams, S, f)).max()))
    check(worst <= GOLDEN_TOL, f"non-plan path: {worst} from the golden PCM")
    say("celt_modes", streams=S, frames=F,
        **{f"max_abs_diff_{m}": d for m, d in diffs.items()},
        non_plan_worst_abs_err_vs_golden=worst)


def phase_mixed_main(dev, mono):
    S, F = S_MAIN, 12
    pipe = OpusStreamPipeline(S, channels=1, device=dev)
    deemph.reset_launches()
    worst = 0.0
    launches = []
    modes = set()
    for f in range(F):
        pcm = pipe.step(frame_batch(mono, S, f, packets=True))
        torch.cuda.synchronize()
        launches.append(deemph.deemphasis_launches)
        got = pcm.cpu().numpy()
        check(got.shape == (S, FRAME, 1), f"mixed pcm shape {got.shape}")
        check(bool(np.isfinite(got).all()), f"non-finite pcm at frame {f}")
        modes |= set(int(m) for m in pipe.last_modes)
        err = np.abs(got - golden_pcm(mono, S, f)).max(axis=(1, 2))
        held = np.array([f >= MIX_GOLDEN_FROM.get(mono[s % len(mono)].name, 0)
                         for s in range(S)])
        check(bool((err[held] <= GOLDEN_TOL).all()),
              f"mixed frame {f}: {int((err[held] > GOLDEN_TOL).sum())} "
              f"streams beyond {GOLDEN_TOL}, worst {err[held].max()}")
        worst = max(worst, float(err[held].max()))
    n = deemph.deemphasis_launches
    check(modes == {0, 1, 2}, f"modes seen {modes}: CELT, SILK and hybrid "
          "expected")
    check(all(b - a == 1 for a, b in zip([0] + launches, launches)),
          f"deemphasis launches per mixed step {launches}: one expected")
    say("mixed_main_path", streams=S, frames=F, modes=sorted(modes),
        worst_abs_err_vs_golden=worst, bar=GOLDEN_TOL,
        deemphasis_launches=n, launches_after_each_step=launches)
    return n


def phase_device_silk(dev, mono):
    """The device SILK synthesis against the bit-exact host synthesis."""
    S, F = S_MAIN, 12
    payloads = mono[1].payloads                       # silk_wb_16k
    host = SilkStreamPipeline(S, synthesis="host", device=dev)
    device = SilkStreamPipeline(S, synthesis="device", device=dev)
    a, b = [], []
    for f in range(F):
        a.append(host.step([payloads[f]] * S).cpu().numpy())
        b.append(device.step([payloads[f]] * S).cpu().numpy())
    a, b = np.concatenate(a, axis=1), np.concatenate(b, axis=1)
    check(bool(np.isfinite(b).all()), "non-finite device SILK pcm")
    snr = 10 * np.log10((a ** 2).mean(axis=1)
                        / (((a - b) ** 2).mean(axis=1) + 1e-12))
    check(float(snr.min()) > 45.0, f"device SILK SNR {snr.min()} dB <= 45")
    lane = OpusStreamPipeline(S, silk_synthesis="device", device=dev)
    plain = OpusStreamPipeline(S, device=dev)
    worst = 0.0
    for f in range(F):
        batch = frame_batch(mono, S, f, packets=True)
        got = lane.step(batch)
        check(5 in set(int(m) for m in lane.last_modes),
              "no stream rode the device-SILK lane")
        worst = max(worst, float((got - plain.step(batch)).abs().max()))
    check(worst < 5e-3, f"device-SILK lane {worst} from the host lane")
    say("device_silk", streams=S, frames=F, min_snr_db=float(snr.min()),
        lane_worst_abs_err_vs_host_lane=worst)


def _time_stream(pipe, batch_fn, warm=3, steps=12, **kwargs):
    """Steady-state ms/step of pipe.decode_stream(**kwargs) over `steps`
    frames after `warm`."""
    def frames(n, first):
        return (batch_fn((first + i) % 12) for i in range(n))

    for _ in pipe.decode_stream(frames(warm, 0), **kwargs):
        pass
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    for _ in pipe.decode_stream(frames(steps, warm), **kwargs):
        n += 1
    torch.cuda.synchronize()
    check(n == steps, f"{n} frames of {steps} came out")
    return (time.perf_counter() - t0) * 1e3 / n


# record_function spans of the port
RANGES = ("host.", "plan.", "plc.", "synthesis.", "silk.", "mixed.",
          "front.", "nsq.", "pitchdnn", "fargan.", "rdovae.")
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")


def _innermost_range(ev):
    while ev is not None:
        if ev.name.startswith(RANGES):
            return ev.name
        ev = ev.cpu_parent
    return "outside"


def _profile_step(step, tag=None):
    """One call of `step` under torch.profiler: kernel launches (host-side
    launch calls, attributed to the innermost port span), device busy time
    (sum of kernel durations) and host time by span. With a tag (and
    --out) the profiler's table goes to profile_<tag>.txt."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches: dict = {}
    host_ms: dict = {}
    device_us = 0.0
    kernels = 0
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    for ev in prof.events():
        if ev.device_type == cpu and ev.name in LAUNCH_CALLS:
            stage = _innermost_range(ev.cpu_parent)
            launches[stage] = launches.get(stage, 0) + 1
        elif ev.device_type == cpu and ev.name.startswith(RANGES):
            host_ms[ev.name] = round(host_ms.get(ev.name, 0.0)
                                     + ev.cpu_time_total / 1e3, 3)
        elif ev.device_type == cuda and not ev.name.startswith(RANGES):
            kernels += 1
            device_us += ev.time_range.elapsed_us()
    if OUT_DIR is not None and tag is not None:
        with open(os.path.join(OUT_DIR, f"profile_{tag}.txt"), "w") as fh:
            fh.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=40))
    return {"launches": sum(launches.values()), "device_kernels": kernels,
            "device_busy_ms": round(device_us / 1e3, 3),
            "profiled_wall_ms": round(wall_ms, 3),
            "launches_by_span": launches, "host_ms_by_span": host_ms}


def _profile(name, step_of_frame):
    """Two profiled steps: the first warms the profiler up."""
    _profile_step(partial(step_of_frame, 4))
    say(f"profile_{name}", **_profile_step(partial(step_of_frame, 5), name))


def phase_timing(dev, streams, mono):
    for S in (S_MAIN, S_WIDE):
        celt_batch = partial(frame_batch, streams, S)
        mixed_batch = partial(frame_batch, mono, S, packets=True)
        pipe = CeltStreamPipeline(S, use_plan=True, device=dev)
        mixed = OpusStreamPipeline(S, channels=1, device=dev)
        modes = {f"S{S}": (pipe, celt_batch, {}),
                 f"mixed_S{S}": (mixed, mixed_batch, {})}
        if S == S_MAIN:
            overlapped = CeltStreamPipeline(S, use_plan=True, device=dev)
            overlapped.overlap_host = True
            modes["S256_overlap_host"] = (overlapped, celt_batch, {})
            modes["S256_chunk4"] = (
                CeltStreamPipeline(S, use_plan=True, device=dev),
                celt_batch, {"chunk": 4})
        # the modes take turns, so that a slow stretch of the shared host
        # does not fall on one of them alone
        runs: dict = {name: [] for name in modes}
        # the wide runs are timed twice: with three the whole run took over
        # ten minutes on a slow host
        for rep in range(TIMING_REPEATS if S == S_MAIN else 2):
            for name, (p, batch_fn, kwargs) in modes.items():
                runs[name].append(_time_stream(
                    p, batch_fn, warm=1 if rep else 3, **kwargs))
        for name, ms in runs.items():
            median = float(np.median(ms))
            say(f"timing_{name}", streams=S, ms_per_step=median,
                ms_per_step_min=min(ms), ms_per_step_runs=ms,
                realtime_x=S * 0.02 / (median / 1e3), **modes[name][2])
        _profile(f"S{S}", lambda f: pipe.step(celt_batch(f)))
        _profile(f"mixed_S{S}", lambda f: mixed.step(mixed_batch(f)))
        if S == S_MAIN:
            lost = np.zeros(S, bool)
            lost[::10] = True
            say("profile_S256_lossy", **_profile_step(
                lambda: pipe.step(celt_batch(6, lost)), "S256_lossy"))
            lane = OpusStreamPipeline(S, silk_synthesis="device", device=dev)
            for f in range(4):
                lane.step(mixed_batch(f))
            _profile("mixed_S256_device_silk",
                     lambda f: lane.step(mixed_batch(f)))


# ------------------------------------------------------------ encode side

def _pcm_batch(streams, S, f):
    """(S, 960, channels) float32 input of frame f: the golden PCM."""
    return golden_pcm(streams, S, f % 12)


def phase_encode_front(dev, streams):
    """front_step on the card against the same function on the CPU: the
    card runs 256 streams, the CPU the three distinct ones."""
    S, F, K = S_MAIN, 12, len(streams)
    consts = {d: encode_front.make_front_consts(FRAME, d)
              for d in (dev, "cpu")}
    st_g = encode_front.init_front_state(S, 2, FRAME, dev)
    st_c = encode_front.init_front_state(K, 2, FRAME, "cpu")
    nby = torch.full((S,), 320, dtype=torch.int32)
    worst = {"freq_rel": 0.0, "floats": 0.0}
    for f in range(F):
        pcm = torch.from_numpy(_pcm_batch(streams, S, f))
        tapset = ((torch.arange(S) % K + f) % 3).to(torch.int32)
        got, st_g = encode_front.front_step(
            consts[dev], st_g, pcm.to(dev), nby.to(dev), tapset.to(dev))
        want, st_c = encode_front.front_step(
            consts["cpu"], st_c, pcm[:K], nby[:K], tapset[:K])
        lane = torch.arange(S) % K
        for key, w in want.items():
            g, w = got[key].cpu(), w[lane]
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"front {key}: {g.shape} {g.dtype} on the card")
            if not g.is_floating_point():
                check(bool((g == w).all()),
                      f"front frame {f}: {key} differs in "
                      f"{int((g != w).sum())} streams")
            elif key == "freq":
                rel = float((g - w).abs().max() / w.abs().max())
                check(rel <= 1e-4, f"front frame {f}: freq off by {rel}")
                worst["freq_rel"] = max(worst["freq_rel"], rel)
            else:
                check(bool(torch.isfinite(g).all()), f"front {key} not finite")
                err = float((g - w).abs().max())
                check(err <= 1e-4, f"front frame {f}: {key} off by {err}")
                worst["floats"] = max(worst["floats"], err)
    say("encode_front", streams=S, frames=F,
        worst_freq_rel_err=worst["freq_rel"],
        worst_float_output_err=worst["floats"], bar=1e-4,
        integer_outputs="equal")


def _downmix_16k(x48):
    """48 kHz (n, channels) -> 16 kHz mono, through a windowed-sinc
    low-pass (the encode tests' band-limited comparison)."""
    taps = 96
    t = np.arange(-taps, taps + 1, dtype=np.float64)
    h = np.sinc(t / 3.0) / 3.0 * np.hanning(2 * taps + 1)
    return np.convolve(np.asarray(x48, np.float64).mean(axis=1), h,
                       mode="same")[::3]


def _snr_db(ref48, got48, skip=960):
    """SNR of got against ref after the downmix, at the best delay, past
    the first frame."""
    a, b = _downmix_16k(ref48[skip:]), _downmix_16k(got48[skip:])
    best = -1e9
    for lag in range(0, 120):
        bb = b[lag:]
        aa = a[:len(bb)]
        best = max(best, 10 * np.log10(
            (aa ** 2).mean() / (((aa - bb) ** 2).mean() + 1e-20)))
    return float(best)


def _encode_round_trip(device, streams, S, chunk=None):
    """Encode the 12 golden frames (step(), or encode_stream() in chunks),
    decode the packets with the port's CELT decoder on the same device.
    Returns (packets [frame][stream], decoded (S, 12 * 960, 2))."""
    F = 12
    enc = CeltEncodePipeline(S, channels=2, bitrate=ENCODE_BITRATE,
                             device=device)
    if chunk is None:
        frames = [enc.step(_pcm_batch(streams, S, f)) for f in range(F)]
    else:
        frames = list(enc.encode_stream(
            np.stack([_pcm_batch(streams, S, f)
                      for f in range(c, c + chunk)])
            for c in range(0, F, chunk)))
    check(len(frames) == F, f"{len(frames)} encoded frames of {F}")
    if chunk is not None and enc.device.type == "cuda":
        # the read-back of a chunk lands in page-locked memory: a ring of
        # two buffer sets, each waited on by its event before it is read
        sets = enc._d2h._sets
        check(all(s is not None and all(h.is_pinned() for h in s)
                  for s in sets), "the encoder's read-back is not pinned")
    dec = CeltStreamPipeline(S, channels=2, use_plan=True,
                              device=device)
    out = []
    for pkts in frames:
        check(len(pkts) == S and all(p is not None and len(p) > 10
                                     for p in pkts),
              "an encoded packet is empty")
        out.append(dec.step(pkts, FRAME).cpu().numpy())
    return frames, np.concatenate(out, axis=1)


def phase_encode_celt(dev, streams):
    """The encode main path: 256 stereo streams encoded on the card,
    decoded on the card, held to the input. The bar of each fixture is the
    SNR of the same round trip through the port on the CPU (one stream a
    fixture, made in this run) less ENCODE_SNR_MARGIN_DB."""
    S, K = S_MAIN, len(streams)
    result = {}
    for mode, chunk in (("step", None), ("stream4", 4)):
        frames, decoded = _encode_round_trip(dev, streams, S, chunk)
        cpu_frames, cpu_decoded = _encode_round_trip("cpu", streams, K, chunk)
        check(bool(np.isfinite(decoded).all()), "non-finite decoded pcm")
        cpu_snr = {g.name: _snr_db(g.pcm, cpu_decoded[s])
                   for s, g in enumerate(streams)}
        snr = {}
        for s in range(S):
            g = streams[s % K]
            val = _snr_db(g.pcm, decoded[s])
            bar = cpu_snr[g.name] - ENCODE_SNR_MARGIN_DB
            check(val >= bar, f"encode {mode}: stream {s} ({g.name}) "
                  f"{val:.2f} dB under its bar {bar:.2f}")
            snr[g.name] = min(snr.get(g.name, 1e9), val)
        equal = sum(frames[f][s] == cpu_frames[f][s % K]
                    for f in range(12) for s in range(S))
        result[mode] = dict(
            min_snr_db_by_fixture=snr, cpu_snr_db_by_fixture=cpu_snr,
            packets_equal_to_cpu_port=equal / (12 * S),
            packet_bytes=len(frames[0][0]))
    say("encode_celt", streams=S, frames=12, bitrate=ENCODE_BITRATE,
        margin_db=ENCODE_SNR_MARGIN_DB, **result)


def _speechlike(n, seed=0, frame=320):
    """Alternating voiced / unvoiced resonator output at int16 scale (the
    signal of the quantizer tests)."""
    rng = np.random.default_rng(seed)
    out = np.zeros(n, np.float64)
    t = 0
    voiced = True
    while t < n:
        seg = min(n - t, 4 * frame)
        if voiced:
            exc = np.zeros(seg)
            exc[::rng.integers(40, 200)] = 1.0
            exc += rng.standard_normal(seg) * 0.02
        else:
            exc = rng.standard_normal(seg) * 0.3
        a = 1.8 * np.cos(2 * np.pi * rng.uniform(0.03, 0.12))
        y = np.zeros(seg)
        y1 = y2 = 0.0
        for i in range(seg):
            y[i] = exc[i] + a * y1 - 0.81 * y2
            y2, y1 = y1, y[i]
        out[t:t + seg] = y / (np.abs(y).max() + 1e-9)
        t += seg
        voiced = not voiced
    return out * 9000


def _harvest_nsq(del_dec: bool, n_frames=16):
    """Every wide-band quantizer call of a real encoder run (the copied
    host SILK encoder at 24 kbit/s on the speech-like signal), each with
    the quantizer state it started from."""
    from mousiki_tpu_torch.hostcodec.bitstream.entcode import RangeEncoder
    from mousiki_tpu_torch.hostcodec.silk import noise_shape, nsq_del_dec
    from mousiki_tpu_torch.hostcodec.silk.encoder import SilkEncoder

    module, name = ((nsq_del_dec, "nsq_del_dec_best") if del_dec
                    else (noise_shape, "nsq_shaped"))
    orig = getattr(module, name)
    calls = []

    def spy(x, st_nsq, ctl, **kw):
        req = {"x": np.asarray(x, np.float64).copy(),
               "st": copy.deepcopy(st_nsq), "ctl": ctl, "kw": dict(kw)}
        out = orig(x, st_nsq, ctl, **kw)
        if kw["frame_length"] == 320:
            calls.append(req)
        return out

    setattr(module, name, spy)
    try:
        enc = SilkEncoder()
        enc.use_del_dec = del_dec
        enc.set_fs(16, 16000, 4)
        sig = _speechlike(320 * (n_frames + 1), seed=1)
        for f in range(n_frames):
            rc = RangeEncoder(1300)
            enc.encode_frame(rc, sig[f * 320:(f + 1) * 320], 4, 24000)
            rc.done()
    finally:
        setattr(module, name, orig)
    return calls


def _nsq_batch(calls, S, device, del_dec):
    """Lane s holds call s % len(calls): (NsqParams, state) on `device`."""
    from mousiki_tpu_torch.parallel.nsq_batch import NsqBatchExecutor
    P, st = NsqBatchExecutor(len(calls), device="cpu").pack_requests(calls)
    lane = np.arange(S) % len(calls)
    params = silk_nsq.NsqParams(**{
        k: torch.from_numpy(v[lane]).to(device) for k, v in P.items()})
    cls = silk_nsq.NsqDelDecState if del_dec else silk_nsq.NsqDevState
    return params, cls(**{k: torch.from_numpy(v[lane]).to(device)
                          for k, v in st.items()})


NSQ_KW = dict(nb_subfr=4, sub=80, M=320)
NSQ_WARPING = 983 * 16 / 65536.0


class _FirstArgmin:
    """Inside the block, keeps the input and the result of the first
    torch.argmin call: in nsq_del_dec_frame that is the choice of the
    first sample's winner among the trellis states."""

    def __enter__(self):
        self.seen = None
        self._orig = torch.argmin

        def spy(x, *args, **kwargs):
            out = self._orig(x, *args, **kwargs)
            if self.seen is None:
                self.seen = (x.clone(), out.clone())
            return out

        torch.argmin = spy
        return self

    def __exit__(self, *exc):
        torch.argmin = self._orig


def phase_silk_nsq(dev):
    S = S_MAIN
    out = {}
    batches = {}
    for del_dec in (False, True):
        calls = _harvest_nsq(del_dec)
        n = len(calls)
        check(n >= 8, f"{n} quantizer calls harvested")
        fn = (partial(silk_nsq.nsq_del_dec_frame, warping=NSQ_WARPING)
              if del_dec else silk_nsq.nsq_frame)
        batches[del_dec] = (fn, _nsq_batch(calls, S, dev, del_dec))
        with _FirstArgmin() as first:
            got = fn(*batches[del_dec][1], **NSQ_KW)[0].cpu()
        want = fn(*_nsq_batch(calls, n, "cpu", del_dec), **NSQ_KW)[0]
        check(got.shape == (S, 320) and got.dtype == torch.int32,
              f"pulses {tuple(got.shape)} {got.dtype}")
        lane = torch.arange(S) % n
        share = (got == want[lane]).float().mean(1)
        same = int((got == got[lane]).all(1).sum())
        check(same == S, f"{S - same} lanes differ from the first lane that "
              "holds the same call")
        res = dict(calls=n, min_share=float(share.min()),
                   mean_share=float(share.mean()),
                   lanes_exactly_equal=int((share == 1).sum()),
                   lanes_equal_to_their_first_copy=same)
        if del_dec:
            check(float(share.mean()) >= 0.9,
                  f"del-dec mean share of equal pulses {share.mean()}")
            check(int((share == 1).sum()) >= S // 2,
                  f"del-dec: {int((share == 1).sum())} of {S} lanes equal")
            # the first sample: where every state has the same cost, the
            # first state wins, on the card as in the reference
            cost, win = first.seen
            check(cost.is_cuda and cost.shape == (S, silk_nsq.MAX_DD_STATES),
                  f"first-sample costs {tuple(cost.shape)} on {cost.device}")
            tied = (cost == cost[:, :1]).all(1)
            check(int(tied.sum()) > 0, "no lane ties at the first sample")
            check(bool((win[tied] == 0).all()),
                  f"first-sample winners of tied lanes: "
                  f"{sorted(set(win[tied].tolist()))}")
            res.update(first_sample_tied_lanes=int(tied.sum()),
                       first_sample_winners_of_tied_lanes=sorted(
                           set(win[tied].tolist())))
        else:
            check(float(share.min()) >= 0.985,
                  f"nsq_frame share of equal pulses {share.min()}")
        out["del_dec" if del_dec else "single"] = res
    say("silk_nsq", streams=S, **out)
    return batches


def phase_encode_silk(dev, mono):
    S, F = 8, 4
    batched = SilkEncodePipeline(S, bitrate=24000, device=dev)
    solo = SilkEncodePipeline(1, bitrate=24000, device=dev)
    dec = OpusStreamPipeline(S, channels=1, device=dev)
    t0 = time.perf_counter()
    sizes = []
    for f in range(F):
        pcm = _pcm_batch(mono, S, f)[:, :, 0]
        pkts = batched.step(pcm)
        check(len(pkts) == S and all(p and len(p) > 2 for p in pkts),
              f"SILK encode frame {f}: an empty packet")
        check(solo.step(pcm[:1])[0] == pkts[0],
              f"SILK encode frame {f}: stream 0 differs from itself alone")
        out = dec.step(pkts).cpu().numpy()
        check(out.shape == (S, FRAME, 1) and bool(np.isfinite(out).all()),
              f"SILK packets of frame {f} decode to {out.shape}")
        check(set(int(m) for m in dec.last_modes) == {1},
              f"decoded modes {dec.last_modes}: SILK expected")
        sizes.append([len(p) for p in pkts])
    say("encode_silk", streams=S, frames=F, bitrate=24000,
        device_quantizer_calls=batched._ex.dispatches,
        solo_quantizer_calls=solo._ex.dispatches,
        packet_bytes_last_frame=sizes[-1],
        seconds=round(time.perf_counter() - t0, 2))


def phase_encode_timing(dev, streams, nsq_batches):
    """ms/step of the CELT encoder at S = 256 through step() and through
    encode_stream(K = 8), and the profiles of the encode side."""
    S, K, warm, timed = S_MAIN, 8, 8, 24
    frames = [_pcm_batch(streams, S, f) for f in range(12)]
    chunks = [np.stack([frames[(c + k) % 12] for k in range(K)])
              for c in range(0, warm + timed, K)]

    def run_step(pipe):
        for f in range(warm):
            pipe.step(frames[f % 12])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in range(warm, warm + timed):
            check(len(pipe.step(frames[f % 12])) == S, "packets missing")
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / timed

    def run_stream(pipe):
        for _ in pipe.encode_stream(iter(chunks[:warm // K])):
            pass
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sum(1 for _ in pipe.encode_stream(iter(chunks[warm // K:])))
        torch.cuda.synchronize()
        check(n == timed, f"{n} frames of {timed} came out")
        return (time.perf_counter() - t0) * 1e3 / n

    modes = {"encode_step": run_step, "encode_stream8": run_stream}
    pipes = {name: CeltEncodePipeline(S, channels=2, bitrate=ENCODE_BITRATE,
                                      device=dev) for name in modes}
    runs: dict = {name: [] for name in modes}
    for _ in range(TIMING_REPEATS):
        for name, fn in modes.items():
            runs[name].append(fn(pipes[name]))
    for name, ms in runs.items():
        median = float(np.median(ms))
        say(f"timing_{name}_S{S}", streams=S, ms_per_step=median,
            ms_per_step_min=min(ms), ms_per_step_runs=ms,
            realtime_x=S * 0.02 / (median / 1e3))
    pipe = pipes["encode_step"]
    _profile(f"encode_step_S{S}", lambda f: pipe.step(frames[f]))
    for del_dec, (fn, args) in nsq_batches.items():
        name = f"nsq_{'del_dec' if del_dec else 'frame'}_S{S}"
        wall_ms = _timed(lambda: (fn(*args, **NSQ_KW),
                                  torch.cuda.synchronize())) * 1e3
        say(f"profile_{name}", unprofiled_wall_ms=wall_ms,
            **_profile_step(lambda: fn(*args, **NSQ_KW), name))


# ------------------------------------------------------- neural recovery

S_NEURAL = 64                 # bench.py bench_deep_recovery's S
NEURAL_PCM_TOL = 1e-4         # tests/test_deep_recovery.py:92
PERIOD_TOL = 1e-3             # a flip is excused within this of an integer


def _bench_features(S):
    """bench.py bench_deep_recovery's features: (S, 2, 20) * 0.3."""
    return (np.random.default_rng(0).standard_normal((S, 2, 20))
            .astype(np.float32) * 0.3)


def phase_neural_conceal(dev):
    S, calls = S_NEURAL, 5
    feats = _bench_features(S)
    gpu = BatchedDeepRecovery(S, device=dev)
    cpu = BatchedDeepRecovery(S, device="cpu")
    flips, flipped, worst_period = [], np.zeros(S, bool), 0.0
    got, want = [], []
    for k in range(calls):
        got.append(gpu.conceal(feats).cpu().numpy())
        want.append(cpu.conceal(feats).numpy())
        pg = gpu.last_periods.cpu().numpy()
        pc = cpu.last_periods.numpy()
        worst_period = max(worst_period, float(np.abs(pg - pc).max()))
        for s, f in zip(*np.nonzero(pg.astype(np.int32)
                                    != pc.astype(np.int32))):
            dist = float(abs(pc[s, f] - np.round(pc[s, f])))
            flips.append(dict(call=k, lane=int(s), frame=int(f),
                              card=float(pg[s, f]), cpu=float(pc[s, f]),
                              cpu_distance_from_integer=dist))
            print(f"[neural_conceal] period flip {flips[-1]}", flush=True)
            check(dist < PERIOD_TOL, f"period flip far from an integer: "
                  f"{flips[-1]}")
            flipped[s] = True
    check(worst_period <= PERIOD_TOL,
          f"PitchDNN periods {worst_period} from the CPU's")
    got, want = np.concatenate(got, 1), np.concatenate(want, 1)
    check(got.shape == (S, calls * 320), f"conceal output {got.shape}")
    check(bool(np.isfinite(got).all()), "non-finite concealment PCM")
    err = np.abs(got - want).max(axis=1)
    check(bool((err[~flipped] <= NEURAL_PCM_TOL).all()),
          f"concealment PCM {err[~flipped].max()} from the CPU's in a lane "
          "without a period flip")
    say("neural_conceal", streams=S, calls=calls, frames_a_call=2,
        period_flips=len(flips), lanes_with_flips=int(flipped.sum()),
        worst_period_diff=worst_period,
        worst_pcm_err_no_flip=float(err[~flipped].max()),
        bar=NEURAL_PCM_TOL, max_abs_pcm=float(np.abs(got).max()))


def _seeded_dreds(S):
    """S OpusDred from dred_encode of seeded latents (26 a stream) at
    several quantizer levels, parsed back: the budget cuts some short."""
    stats = dred.synthetic_stats()
    rng = np.random.default_rng(11)
    out = []
    for s in range(S):
        lat = [(rng.standard_normal(24) * 1.5).astype(np.float32)
               for _ in range(26)]
        st = rng.standard_normal(24).astype(np.float32)
        payload = dred.dred_encode(lat, st, stats, q0=3 + s % 10,
                                   dq=s % 8, offset=0, max_bytes=160)
        out.append(dred.OpusDred(dred.dred_parse(payload, stats), payload))
    return out


def phase_rdovae_decode(dev):
    S = S_NEURAL
    dreds = _seeded_dreds(S)
    gpu = BatchedDeepRecovery(S, device=dev)
    feats, n10 = gpu.process(dreds)
    want, want_n = BatchedDeepRecovery(S, device="cpu").process(dreds)
    check(bool((n10 == want_n).all()), "valid frame counts differ")
    check(bool(np.isfinite(feats).all()), "non-finite features")
    scale = float(np.abs(want).max())
    err = float(np.abs(feats - want).max())
    check(err <= 1e-4 * scale, f"features {err} from the CPU port's "
          f"(bar 1e-4 * {scale})")
    rows = {}
    for s in (0, S - 1):
        one = np.stack(dred.opus_dred_process(dreds[s],
                                              model=gpu.dec_model))
        d = float(np.abs(feats[s, feats.shape[1] - n10[s]:] - one).max())
        check(d <= 1e-4 * scale, f"row {s}: {d} from opus_dred_process")
        rows[f"row{s}_vs_opus_dred_process"] = d
    say("rdovae_decode", streams=S, qframes=int(n10.max()) // 4,
        qframes_min=int(n10.min()) // 4, worst_abs_err_vs_cpu=err,
        bar=1e-4 * scale, **rows)
    return dreds


def _speechish(n, seed):
    """The signal of the DRED tests (tests/test_deep_recovery.py)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48000
    f0 = 120 + 30 * np.sin(2 * np.pi * 2.3 * t)
    sig = 0.3 * np.sin(2 * np.pi * np.cumsum(f0) / 48000)
    sig *= 0.6 + 0.4 * np.sin(2 * np.pi * 4.0 * t) ** 2
    sig += 0.01 * rng.standard_normal(n)
    return sig.astype(np.float32)[:, None]


def _dred_encoder(model=None):
    enc = OpusEncoder(48000, 1)
    enc.set_bitrate(24000)
    enc.set_dred_duration(40, model=model)
    return enc


def phase_dred_encode(dev):
    S, F = 2, 10
    t0 = time.perf_counter()
    cpu_model = rdovae.random_enc(torch.Generator().manual_seed(0),
                                  device="cpu")
    packets, equal, with_dred = [], 0, []
    for s in range(S):
        card, host = _dred_encoder(), _dred_encoder(cpu_model)
        check(card._dred.device.type == "cuda",
              f"the DRED encoder runs on {card._dred.device}")
        sig = _speechish(FRAME * F, seed=10 + s)
        pk = []
        for f in range(F):
            pcm = sig[f * FRAME:(f + 1) * FRAME]
            pk.append(card.encode(pcm, FRAME))
            equal += pk[-1] == host.encode(pcm, FRAME)
        packets.append(pk)
        with_dred.append(sum(dred.opus_dred_parse(p) is not None
                             for p in pk))
    check(min(with_dred) >= 8, f"DRED parses from {with_dred} packets")
    dec = OpusStreamPipeline(S, channels=1, device=dev)
    for f in range(F):
        out = dec.step([opus_packet_unpad(packets[s][f]) for s in range(S)])
        check(out.shape == (S, FRAME, 1) and bool(torch.isfinite(out).all()),
              f"DRED packets of frame {f} decode to {tuple(out.shape)}")
    say("dred_encode", streams=S, frames=F, packets_with_dred=with_dred,
        packets_equal_to_cpu_port=equal / (S * F),
        seconds=round(time.perf_counter() - t0, 2))


def phase_neural_timing(dev, dreds):
    """bench.py's dred_recovery_x_s64 (3 windows, not 6) at S = 64 and
    S = 256, process() timed at S = 64, and the profiles of a conceal
    call at each width and of one process call."""
    n_steps, windows = 10, 3
    recs = {}
    for S in (S_NEURAL, 256):
        rec = recs[S] = BatchedDeepRecovery(S, device=dev)
        feats = _bench_features(S)
        rec.conceal(feats)
        torch.cuda.synchronize()
        rates = []
        for _ in range(windows):
            t0 = time.perf_counter()
            for _ in range(n_steps):
                rec.conceal(feats)
            torch.cuda.synchronize()
            rates.append(S * n_steps * 0.02 / (time.perf_counter() - t0))
        say(f"timing_dred_recovery_x_s{S}", streams=S,
            realtime_x=float(np.median(rates)),
            realtime_x_windows=rates,
            ms_per_call=S * 0.02 / float(np.median(rates)) * 1e3)
    rec = recs[S_NEURAL]
    runs = []
    for _ in range(windows):
        t0 = time.perf_counter()
        rec.process(dreds)          # ends in its read-back
        runs.append((time.perf_counter() - t0) * 1e3)
    say("timing_process_S64", streams=S_NEURAL, ms_per_call=float(
        np.median(runs)), ms_per_call_runs=runs)
    for S, r in recs.items():
        feats = _bench_features(S)
        _profile_step(lambda: r.conceal(feats))
        say(f"profile_conceal_S{S}", **_profile_step(
            lambda: r.conceal(feats), f"conceal_S{S}"))
    rec.process(dreds)
    say("profile_process_S64", **_profile_step(lambda: rec.process(dreds),
                                                "process_S64"))


# ------------------------------------------------- the single-stream API


def phase_python_host(dev, streams):
    """The Python host decoder in front of the device synthesis."""
    S, F = S_PYHOST, 12
    pipe = CeltStreamPipeline(S, 2, use_native=False, device=dev)
    check(pipe._native is None and len(pipe._py_hosts) == S,
          "use_native=False did not take the Python host")
    deemph.reset_launches()
    worst, launches, step_ms = 0.0, [], []
    for f in range(F):
        t0 = time.perf_counter()
        pcm = pipe.step(frame_batch(streams, S, f), FRAME)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(deemph.deemphasis_launches)
        got = pcm.cpu().numpy()
        check(got.shape == (S, FRAME, 2), f"pcm shape {got.shape}")
        check(bool(np.isfinite(got).all()), f"non-finite pcm at frame {f}")
        err = np.abs(got - golden_pcm(streams, S, f)).max(axis=(1, 2))
        check(bool((err <= GOLDEN_TOL).all()),
              f"Python host frame {f}: {int((err > GOLDEN_TOL).sum())} "
              f"streams beyond {GOLDEN_TOL}, worst {err.max()}")
        worst = max(worst, float(err.max()))
    n = deemph.deemphasis_launches
    check(all(b - a == 1 for a, b in zip([0] + launches, launches)),
          f"deemphasis launches per Python-host step {launches}")
    median = float(np.median(step_ms[2:]))
    say("python_host", streams=S, frames=F, worst_abs_err_vs_golden=worst,
        bar=GOLDEN_TOL, deemphasis_launches=n,
        launches_after_each_step=launches, ms_per_step=median,
        ms_per_step_runs=step_ms, ms_per_stream_frame=median / S,
        realtime_x=S * 0.02 / (median / 1e3))
    return n


def phase_single_stream():
    """The single-stream API of hostcodec/ through the package's top-level
    names, on the golden streams."""
    import mousiki_tpu_torch as api
    from golden_streams import load_all
    t0 = time.perf_counter()
    streams = load_all()
    worst, packets = 0.0, 0
    for st in streams:
        channels = st.pcm.shape[1]
        dec = api.OpusDecoder(48000, channels)
        for f, pkt in enumerate(st.packets):
            pcm = dec.decode(pkt, FRAME)
            check(dec.final_range == st.ranges[f],
                  f"{st.name} packet {f}: final range {dec.final_range}, "
                  f"fixture {st.ranges[f]}")
            err = float(np.abs(pcm - st.pcm[f * FRAME:(f + 1) * FRAME])
                        .max())
            check(err <= GOLDEN_TOL, f"{st.name} packet {f}: {err}")
            worst = max(worst, err)
            packets += 1
    check(packets == 96, f"{packets} golden packets decoded")
    st = streams[0]
    typed = api.Decoder(48000, api.Channels(st.pcm.shape[1]))
    plain = api.OpusDecoder(48000, st.pcm.shape[1])
    for pkt in st.packets:
        check(np.array_equal(typed.decode_float(pkt, FRAME),
                             plain.decode(pkt, FRAME)),
              "codec.Decoder differs from OpusDecoder")
    enc = api.MultistreamEncoder.surround(48000, 6)
    enc.set_bitrate(256000)
    msdec = api.MultistreamDecoder(48000, 6, enc.streams, enc.coupled,
                                   enc.mapping)
    t = np.arange(FRAME * 3) / 48000.0
    sig = np.stack([(0.4 / (1 + c)) * np.sin(2 * np.pi * (200 + 130 * c) * t)
                    for c in range(6)], 1)
    sig += 0.01 * np.random.default_rng(6).standard_normal(sig.shape)
    for f in range(3):
        out = msdec.decode(enc.encode(sig[f * FRAME:(f + 1) * FRAME], FRAME),
                           FRAME)
        check(out.shape == (FRAME, 6) and bool(np.isfinite(out).all()),
              f"5.1 round trip frame {f}: {out.shape}")
    surround_peak = float(np.abs(out).max())
    check(surround_peak > 1e-3, "5.1 round trip is silent")
    writer = api.OggOpusWriter(st.pcm.shape[1], preskip=312)
    for pkt in st.packets:
        writer.write_packet(pkt, FRAME)
    blob = writer.finish()
    read = [p for p, _ in api.OggOpusReader(blob).packets()]
    check(read == st.packets, "Ogg round trip changed the packets")
    ogg_file = api.OpusFile(blob)
    ogg_pcm = ogg_file.decode_all()
    ogg_err = float(np.abs(ogg_pcm - st.pcm[312:]).max())
    check(ogg_file.pcm_total() == 12 * FRAME and ogg_err <= GOLDEN_TOL,
          f"OpusFile: {ogg_file.pcm_total()} samples, {ogg_err} from golden")
    say("single_stream", streams=len(streams), packets=packets,
        ranges_equal=True, worst_abs_err_vs_golden=worst, bar=GOLDEN_TOL,
        surround_peak=surround_peak, ogg_bytes=len(blob),
        ogg_worst_abs_err_vs_golden=ogg_err,
        seconds=round(time.perf_counter() - t0, 2))


def _deep_decoder(device):
    """OpusDecoder(48000, 1) with the port's seeded FARGAN (seed 2),
    PitchDNN (seed 3) and RDOVAE decoder (seed 1) on `device`."""
    from mousiki_tpu_torch import OpusDecoder
    dec = OpusDecoder(48000, 1)
    dec.set_deep_plc(
        fargan.random_model(torch.Generator().manual_seed(2), device=device),
        deep_plc.random_pitchdnn(torch.Generator().manual_seed(3),
                                 device=device))
    dec.set_dred_models(rdovae.random_dec(torch.Generator().manual_seed(1),
                                          device=device),
                        dred.synthetic_stats())
    return dec


def phase_deep_plc(dev):
    """Deep PLC and the DRED decode of the single-stream OpusDecoder on
    the card against the same decoder on the CPU."""
    t0 = time.perf_counter()
    enc = _dred_encoder(rdovae.random_enc(torch.Generator().manual_seed(0),
                                          device="cpu"))
    sig = _speechish(FRAME * 11, seed=21)
    pkts = [enc.encode(sig[f * FRAME:(f + 1) * FRAME], FRAME)
            for f in range(11)]
    encode_s = round(time.perf_counter() - t0, 2)
    card, host = _deep_decoder(dev), _deep_decoder("cpu")
    check(card.deep_plc.device.type == "cuda",
          f"deep PLC runs on {card.deep_plc.device}")
    flips, worst, conceal_ms = [], {"good": 0.0, "dred": 0.0,
                                    "plc": 0.0}, []
    flipped = False

    def compare(kind, got, want):
        nonlocal flipped
        check(got.shape == want.shape and bool(np.isfinite(got).all()),
              f"{kind}: {got.shape} / {want.shape}")
        if kind != "good":
            pc = float(host.deep_plc.last_period[0])
            pg = float(card.deep_plc.last_period[0])
            if int(pc) != int(pg):
                dist = abs(pc - round(pc))
                flips.append(dict(kind=kind, card=pg, cpu=pc,
                                  cpu_distance_from_integer=dist))
                print(f"[deep_plc] period flip {flips[-1]}", flush=True)
                check(dist < PERIOD_TOL,
                      f"period flip far from an integer: {flips[-1]}")
                flipped = True
        err = float(np.abs(got - want).max())
        if not flipped:
            check(err <= NEURAL_PCM_TOL, f"{kind} PCM {err} from the CPU's")
            worst[kind] = max(worst[kind], err)

    def on_card(fn, *args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        conceal_ms.append((time.perf_counter() - t) * 1e3)
        return out

    for pkt in pkts[:8]:
        compare("good", card.decode(pkt, FRAME), host.decode(pkt, FRAME))
    parsed = [d.dred_parse(pkts[10]) for d in (card, host)]
    check(all(p is not None for p in parsed), "no DRED in packet 10")
    feats = [np.stack(d.dred_process(p)) for d, p in zip((card, host),
                                                         parsed)]
    scale = max(1.0, float(np.abs(feats[1]).max()))
    feat_err = float(np.abs(feats[0] - feats[1]).max())
    check(feat_err <= 1e-4 * scale,
          f"DRED features {feat_err} from the CPU's (bar 1e-4 * {scale})")
    for k in (2, 1):            # the gap, oldest first (10 ms units)
        compare("dred",
                on_card(card.dred_decode, parsed[0], 2 * k, FRAME),
                host.dred_decode(parsed[1], 2 * k, FRAME))
    compare("good", card.decode(pkts[10], FRAME), host.decode(pkts[10], FRAME))
    for d in (card, host):      # what is left of the DRED features goes
        d.inject_dred_features([])
    compare("plc", on_card(card.decode, None, FRAME),
            host.decode(None, FRAME))
    prof = _profile_step(lambda: card.decode(None, FRAME), "deep_plc_decode")
    say("deep_plc", packets=len(pkts), encode_seconds=encode_s,
        dred_latents=parsed[0].nb_latents, feature_err=feat_err,
        feature_bar=1e-4 * scale, period_flips=len(flips),
        worst_pcm_err_good=worst["good"], worst_pcm_err_dred=worst["dred"],
        worst_pcm_err_plc=worst["plc"], bar=NEURAL_PCM_TOL,
        card_ms_per_lost_frame=conceal_ms,
        decode_none_launches=prof["launches"],
        decode_none_profiled_wall_ms=prof["profiled_wall_ms"],
        decode_none_device_busy_ms=prof["device_busy_ms"],
        seconds=round(time.perf_counter() - t0, 2))


def main() -> int:
    global OUT_DIR
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="directory for the measurements (JSON) "
                    "and profiler tables")
    args = ap.parse_args()
    OUT_DIR = args.out
    t_start = time.perf_counter()
    check_no_jax_package()
    dev, card = phase_device()
    if OUT_DIR is not None:
        os.makedirs(OUT_DIR, exist_ok=True)
    phase_build()
    table = phase_kernel(dev)
    streams = load_stereo_celt()
    mono = load_mono_mix()
    set_plan_profile(*SERVING_PROFILE)
    n_celt, _ = phase_main_path(dev, streams)
    phase_loss(dev, streams)
    phase_celt_modes(dev, streams)
    n_mixed = phase_mixed_main(dev, mono)
    phase_device_silk(dev, mono)
    phase_mixed_loss(dev, mono)
    phase_encode_front(dev, streams)
    phase_encode_celt(dev, streams)
    nsq_batches = phase_silk_nsq(dev)
    phase_encode_silk(dev, mono)
    phase_timing(dev, streams, mono)
    phase_encode_timing(dev, streams, nsq_batches)
    phase_neural_conceal(dev)
    dreds = phase_rdovae_decode(dev)
    phase_dred_encode(dev)
    phase_neural_timing(dev, dreds)
    n_pyhost = phase_python_host(dev, streams)
    phase_single_stream()
    phase_deep_plc(dev)
    # one row for each path's shape: the path's launches (counted from 0
    # just before it ran) beside what phase 3 measured at that shape
    kernels = {"kernels": [{
        "name": "deemphasis_pcm", "route": "cuda",
        "source": "mousiki_tpu_torch/csrc/deemphasis.cu",
        "replaces": "mousiki_tpu/ops/pallas_kernels.py:23",
        "path": path, "shape": list(shape), "launches": launches,
        "max_abs_err": table[shape]["max_abs_err"],
        "ms": table[shape]["kernel_device_ms"],
        "plain_ms": table[shape]["plain_device_ms"],
        "bound_ms": table[shape]["bound_ms"],
        "bound_by": table[shape]["bound_by"],
        # no PyTorch call computes a first-order IIR
        "library_ms": None}
        for path, shape, launches in (
            ("celt", CELT_SHAPE, n_celt), ("mixed", MIXED_SHAPE, n_mixed),
            ("celt_python_host", PYHOST_SHAPE, n_pyhost))]}
    RESULTS["kernels"] = kernels
    say("run", seconds=round(time.perf_counter() - t_start, 1))
    if OUT_DIR is not None:
        with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
            json.dump(RESULTS, fh, indent=1, default=str)
    print(card, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
