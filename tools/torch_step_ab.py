"""ms/step and kernel launches of the port's decode steps, or the host
time of one SILK quantizer dispatch by span, at S = 256 on one GPU, for
one or more checkouts of this repository, in turns.

    python3 tools/torch_step_ab.py --trees DIR_A,DIR_B --order 0,1,1,0 \\
        [--target steps|nsq] [--out FILE]

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
(nsq.h2d, nsq.quantize, nsq.d2h) and the launches in each.

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

S = 256
STEPS, WARM, RUNS = 8, 3, 3
NSQ_TIMED = 3
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
            "host_ms_by_span": host_ms, "launches_by_span": launches}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--target", choices=("steps", "nsq"), default="steps",
                    help="the decode steps or one quantizer dispatch")
    ap.add_argument("--trees", help="comma-separated checkouts")
    ap.add_argument("--order", help="comma-separated indices into --trees")
    ap.add_argument("--out", help="file for the JSON lines")
    args = ap.parse_args()
    if args.child:
        sys.path.insert(0, os.getcwd())
        child = _nsq_child if args.target == "nsq" else _steps_child
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
    for i in order:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", "--target", args.target],
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
