"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Drives mousiki_tpu_torch's plan-mode CELT stream decoder (48 kHz stereo,
20 ms frames) end to end on the card, with the JAX package nowhere in the
process (it fails first thing if any module of mousiki_tpu is loaded):

  1. device check: a CUDA device, its name and power limit (nvidia-smi);
  2. build, both at once: the native host symbol stage
     (csrc/celt_host.cpp, g++) and the fused de-emphasis kernel
     (csrc/deemphasis.cu, nvcc), each with its build time;
  3. kernel vs plain: deemphasis_pcm against deemphasis_pcm_reference on
     the card at (S, C, N) = (256, 2, 960), the main path's shape, and
     (256, 2, 120), (7, 1, 960), (3, 2, 240); bar 1e-4 * max|pcm|. For
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
  6. timing: steady-state ms/step and aggregate realtime-x at S = 256 and
     S = 1024 through decode_stream, and one profiled step (kernel
     launches, device busy time, host time by stage).

Any failure raises (exit code != 0). Lines before the last report each
phase; the line before the last is the kernel table as JSON; the last
line is {"ok": true, "device": {...}}. With --out DIR, everything
measured also goes to DIR/chip_smoke.json, and the profiler's tables of
the profiled steps to DIR/profile_*.txt.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import torch

from golden_streams import frame_batch, golden_pcm, load_stereo_celt
from mousiki_tpu_torch._device import require_cuda
from mousiki_tpu_torch.ops import _build
from mousiki_tpu_torch.ops import deemphasis as deemph
from mousiki_tpu_torch.pipeline import (SERVING_PROFILE, CeltStreamPipeline,
                                        set_plan_profile)

FRAME = 960
GOLDEN_TOL = 2e-4
KERNEL_REL_TOL = 1e-4
# NVIDIA H100 SXM data sheet peaks (dense, no sparsity, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
KERNEL_SHAPES = ((256, 2, 960), (256, 2, 120), (7, 1, 960), (3, 2, 240))
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
    """g++ for the host stage and nvcc for the kernel, started together."""
    with ThreadPoolExecutor(max_workers=2) as pool:
        host = pool.submit(_timed, _build.build_host)
        kernel = pool.submit(_timed, deemph.build_kernel)
        say("build", host_library="csrc/celt_host.cpp",
            host_seconds=host.result(), kernel="csrc/deemphasis.cu",
            kernel_seconds=kernel.result())


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
    kernels a call runs."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if between is not None:
                between()
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    us = [ev.time_range.elapsed_us() for ev in prof.events()
          if ev.device_type == cuda and (match is None or match in ev.name)]
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
        say("kernel", S=S, C=C, N=N, **row)
        table[(S, C, N)] = row
    return table


def phase_main_path(dev, streams):
    S, F = 256, 12
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
    say("main_path", streams=S, frames=F, worst_abs_err_vs_golden=worst,
        bar=GOLDEN_TOL, deemphasis_launches=n,
        launches_after_each_step=launches)
    return n, worst


def phase_loss(dev, streams):
    S, F, K = 256, 12, 8
    rng = np.random.default_rng(17)
    lost = rng.random((S, F)) < 0.10
    lost[:, 0] = False
    lost[1, 5:7] = True
    gpu = CeltStreamPipeline(S, device=dev)
    cpu = CeltStreamPipeline(K, device="cpu")
    worst_rx, worst_lost = 0.0, 0.0
    for f in range(F):
        batch = frame_batch(streams, S, f, lost[:, f])
        got = gpu.step(batch).cpu().numpy()
        check(bool(np.isfinite(got).all()), f"non-finite pcm at frame {f}")
        want = cpu.step(batch[:K]).numpy()
        for s in range(K):
            err = float(np.abs(got[s] - want[s]).max())
            plc = bool(lost[s, f] or (f and lost[s, f - 1]))
            check(err < (5e-3 if plc else 2e-4),
                  f"loss frame {f} stream {s}: {err} (lost={lost[s, f]})")
            if plc:
                worst_lost = max(worst_lost, err)
            else:
                worst_rx = max(worst_rx, err)
    say("loss", streams=S, frames=F, loss_share=float(lost.mean()),
        compared_streams=K, worst_err_received=worst_rx,
        worst_err_concealed=worst_lost)


def _time_stream(dev, streams, S, warm=3, steps=20):
    pipe = CeltStreamPipeline(S, device=dev)

    def frames(n, first):
        return (frame_batch(streams, S, (first + i) % 12) for i in range(n))

    for _ in pipe.decode_stream(frames(warm, 0)):
        pass
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    for _ in pipe.decode_stream(frames(steps, warm)):
        n += 1
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    return pipe, ms


RANGES = ("plan.", "plc.", "synthesis.")   # record_function spans of the port
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")


def _innermost_range(ev):
    while ev is not None:
        if ev.name.startswith(RANGES):
            return ev.name
        ev = ev.cpu_parent
    return "outside"


def _profile_step(pipe, streams, S, f, lost=None):
    """One step under torch.profiler: kernel launches (host-side launch
    calls, attributed to the innermost port span), device busy time (sum
    of kernel durations) and host time by span."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pipe.step(frame_batch(streams, S, f, lost))
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
    if OUT_DIR is not None:
        tag = f"S{S}" + ("_lossy" if lost is not None else "")
        with open(os.path.join(OUT_DIR, f"profile_{tag}.txt"), "w") as fh:
            fh.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=40))
    return {"launches": sum(launches.values()), "device_kernels": kernels,
            "device_busy_ms": round(device_us / 1e3, 3),
            "profiled_wall_ms": round(wall_ms, 3),
            "launches_by_span": launches, "host_ms_by_span": host_ms}


def phase_timing(dev, streams):
    for S in (256, 1024):
        pipe, ms = _time_stream(dev, streams, S)
        say(f"timing_S{S}", streams=S, ms_per_step=ms,
            realtime_x=S * 0.02 / (ms / 1e3))
        # two profiled steps: the first warms the profiler up
        _profile_step(pipe, streams, S, 4)
        say(f"profile_S{S}", **_profile_step(pipe, streams, S, 5))
        if S == 256:
            lost = np.zeros(S, bool)
            lost[::10] = True
            say("profile_S256_lossy", **_profile_step(pipe, streams, S, 6,
                                                      lost))


def main() -> int:
    global OUT_DIR
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="directory for the measurements (JSON) "
                    "and profiler tables")
    OUT_DIR = ap.parse_args().out
    check_no_jax_package()
    dev, card = phase_device()
    if OUT_DIR is not None:
        os.makedirs(OUT_DIR, exist_ok=True)
    phase_build()
    table = phase_kernel(dev)
    streams = load_stereo_celt()
    set_plan_profile(*SERVING_PROFILE)
    n_launch, _ = phase_main_path(dev, streams)
    phase_loss(dev, streams)
    phase_timing(dev, streams)
    row = table[(256, 2, FRAME)]
    kernels = {"kernels": [{
        "name": "deemphasis_pcm", "route": "cuda",
        "source": "mousiki_tpu_torch/csrc/deemphasis.cu",
        "replaces": "mousiki_tpu/ops/pallas_kernels.py:23",
        "launches": n_launch, "max_abs_err": row["max_abs_err"],
        "ms": row["kernel_device_ms"], "plain_ms": row["plain_device_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        # no PyTorch call computes a first-order IIR
        "library_ms": None}]}
    RESULTS["kernels"] = kernels
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
