"""Device times of the PVQ leaf kernels (ops/pvq_leaves.py) on the planes
the decode paths hand them at S = 256 on one GPU, for one or more
checkouts of this repository in turns, and a clock probe of this
checkout's kernels.

    python3 tools/torch_leaf_walk_ab.py --trees DIR_A,DIR_B \\
        --order 0,1,1,0 [--planes FILE] [--probe 1] [--out FILE]

The planes, kept in FILE (made there first, in this checkout, when FILE
does not exist): the three launches of `cwrs_walk` in the lockstep plan
emission (celt_lockstep_emit) of the first step of the stereo golden
streams and of the mono mix's CELT stream (golden frame 0), and the
`leaf_stage` call of the serving plan path (CeltStreamPipeline(256, 2,
use_plan=True)) on golden stereo frame 4. Each entry of --order runs one
child process in that checkout (its mousiki_tpu_torch), which checks its
`cwrs_walk` against its own plain walk (iy equal) and times each launch
(the kernel's mean device time over 20 back-to-back launches under
torch.profiler), and the stage where the checkout has `leaf_stage`.

--probe (indices into --trees) then builds each of those checkouts'
csrc/pvq_leaves.cu with the clock hooks of its tools/leaf_probe.cu, in a
child process there, runs each launch once through it, and
prints per launch: the span from the first warp's start to the last
warp's end, when warps start and end (ns after the first start, by
%globaltimer), and the cycles of each stage of a task (clock64), idle
tasks (no leaf walks) and walking tasks apart, at the 50th / 90th / 100th
percentile; it also prints ptxas's register and spill counts of the
kernels. Prints one JSON line a child and one for the probe; writes them
all to --out. Needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

S = 256
DEVICE = "cuda"
FRAME = 960
STAGE_FRAME = 4
REPS = 20
POINTS = 9      # tools/leaf_probe.cu kPoints


def _planes_cpu(d: dict) -> dict:
    return {k: (v.detach().cpu().clone() if hasattr(v, "detach") else
                [t.detach().cpu().clone() for t in v]) for k, v in d.items()}


def capture(path: str) -> None:
    """The walk launches of a lockstep step and the serving path's stage
    call, kept as CPU tensors in `path` (torch.save)."""
    sys.path.insert(0, os.getcwd())
    import torch

    from golden_streams import frame_batch, load_mono_mix, load_stereo_celt
    from mousiki_tpu_torch.ops import band_exec, synthesis
    from mousiki_tpu_torch.ops import celt_lockstep_emit as emit
    from mousiki_tpu_torch.ops import celt_lockstep_top as lockstep
    from mousiki_tpu_torch.ops import pvq_leaves as pvq
    from mousiki_tpu_torch.pipeline import (SERVING_PROFILE,
                                            CeltStreamPipeline,
                                            set_plan_profile)
    dev = torch.device(DEVICE)
    set_plan_profile(*SERVING_PROFILE)
    stereo, mono = load_stereo_celt(), load_mono_mix()
    out = {"walks": {}}
    walk = emit.cwrs_walk
    for name, C, src in (("stereo", 2, stereo), ("mono", 1, [mono[0]])):
        calls = []

        def keep(active, n, k, idx, nmax, calls=calls):
            if len(calls) < 3:
                calls.append((_planes_cpu({"active": active, "n": n,
                                           "k": k, "idx": idx}), nmax))
            return walk(active, n, k, idx, nmax)

        emit.cwrs_walk = keep
        try:
            consts = synthesis.make_consts(FRAME, dev)
            mats = band_exec.plan_combo_mats(C, FRAME, dev)
            buf, lens = lockstep.pad_payloads(frame_batch(src, S, 0), dev)
            lockstep.lockstep_synthesis_step(
                consts, synthesis.init_state(S, C, dev),
                lockstep.init_state(S, device=dev), buf, lens, mats, C=C,
                frame=FRAME)
        finally:
            emit.cwrs_walk = walk
        out["walks"][name] = calls
    kept = []
    stage = band_exec.leaf_stage

    def keep_stage(p, **kw):
        names = ["direct"] + [f"pvq_{x}" for x, _ in pvq.STAGE_PLANES]
        kept[:] = [(_planes_cpu({k: p[k] for k in names}), kw)]
        return stage(p, **kw)

    band_exec.leaf_stage = keep_stage
    try:
        pipe = CeltStreamPipeline(S, 2, use_plan=True, device=dev)
        for f in range(STAGE_FRAME + 1):
            pipe.step(frame_batch(stereo, S, f))
    finally:
        band_exec.leaf_stage = stage
    out["stage"] = kept[0]
    torch.save(out, path)


def _device_us(fn, match: str) -> tuple[float, int]:
    """Mean device time (µs) of the kernels named `match` over REPS calls
    of fn, under torch.profiler, and how many it saw."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    us = [ev.time_range.elapsed_us() for ev in prof.events()
          if ev.device_type == torch.autograd.DeviceType.CUDA
          and match in ev.name]
    return (sum(us) / len(us) if us else float("nan")), len(us)


def _on(d: dict, dev) -> dict:
    return {k: (v.to(dev) if hasattr(v, "to") else [t.to(dev) for t in v])
            for k, v in d.items()}


def child(path: str) -> dict:
    """This checkout's walk (and stage) on the kept planes."""
    sys.path.insert(0, os.getcwd())
    from functools import partial

    import torch

    from mousiki_tpu_torch.ops import pvq_leaves as pvq
    dev = torch.device(DEVICE)
    kept = torch.load(path)
    out = {"tree": os.getcwd(), "walks": {}}
    for name, calls in kept["walks"].items():
        rows = []
        for planes, nmax in calls:
            d = _on(planes, dev)
            args = [d[x] for x in ("active", "n", "k", "idx")]
            ok = torch.equal(pvq.cwrs_walk(*args, nmax),
                             pvq.cwrs_walk_reference(*args, nmax))
            us, seen = _device_us(partial(pvq.cwrs_walk, *args, nmax),
                                  "cwrs_walk_kernel")
            rows.append({"leaves": int(d["n"].numel()), "nmax": nmax,
                         "active": int(d["active"].sum()), "us": us,
                         "seen": seen, "iy_equal": ok})
        out["walks"][name] = {"us": sum(r["us"] for r in rows),
                              "launches": rows}
    if hasattr(pvq, "leaf_stage"):
        p, kw = kept["stage"]
        p = _on(p, dev)
        us, seen = _device_us(partial(pvq.leaf_stage, p, **kw),
                              "pvq_leaf_stage_kernel")
        out["stage"] = {"us": us, "seen": seen,
                        "active": [int(a.sum()) for a in p["pvq_active"]]}
    return out


def _pct(xs) -> list:
    import numpy as np
    if len(xs) == 0:
        return []
    return [float(v) for v in np.percentile(np.asarray(xs, float),
                                            [50, 90, 100])]


def _lanes(values: bool) -> list:
    """Lanes a leaf for tiers 16, 48 and 176 wide, as the checkout's
    csrc/pvq_leaves.cu sets them (kStageLanes, kWalkLanes)."""
    import re
    from mousiki_tpu_torch.ops import _build
    with open(os.path.join(_build.CSRC, "pvq_leaves.cu")) as fh:
        src = fh.read()
    name = "kStageLanes" if values else "kWalkLanes"
    m = re.search(name + r"\[kTiers\] = \{(\d+), (\d+), (\d+)\}", src)
    return [int(g) for g in m.groups()]


def _read_probe(rec, tiers, lanes) -> dict:
    """A launch's probe records (tasks, POINTS, 3) as percentiles;
    `tiers`: (nmax, leaves) in launch order; `lanes`: a leaf's lanes by
    tier width (_lanes)."""
    import numpy as np
    gt, clk, sm = rec[..., 0], rec[..., 1].astype(np.int64), rec[..., 2]
    seen = gt > 0
    t0 = gt[seen].min()
    ns = np.where(seen, gt - t0, 0).astype(np.int64)
    span = int(ns[seen].max())
    starts, ends = ns[:, 0][seen[:, 0]], ns[:, 8][seen[:, 8]]
    idle = seen[:, 3]
    busy = seen[:, 7]

    def cyc(a, b, rows):
        return _pct((clk[rows, b] - clk[rows, a]).tolist())

    first = 0
    by_tier = []
    for nmax, leaves in tiers:
        per_task = 32 // lanes[0 if nmax <= 16 else 1 if nmax <= 48 else 2]
        count = -(-leaves // per_task)
        rows = np.zeros(len(rec), bool)
        rows[first:first + count] = True
        first += count
        i, b = rows & idle, rows & busy
        by_tier.append({
            "nmax": nmax, "tasks": int(count), "idle": int(i.sum()),
            "walking": int(b.sum()),
            "idle_planes_cyc": cyc(1, 2, i), "idle_zero_cyc": cyc(2, 3, i),
            "planes_cyc": cyc(1, 2, b), "table_cyc": cyc(2, 4, b),
            "descent_cyc": cyc(4, 5, b), "iy_cyc": cyc(5, 6, b),
            "values_cyc": cyc(6, 7, b),
            "task_start_ns": _pct(ns[b, 1].tolist()),
            "task_end_ns": _pct(ns[b, 7].tolist())})
    # the SM clock against the global one, over the longest warp
    w = np.argmax(np.where(seen[:, 0] & seen[:, 8], ns[:, 8] - ns[:, 0], 0))
    mhz = (clk[w, 8] - clk[w, 0]) / max(1, gt[w, 8] - gt[w, 0]) * 1e3
    return {"span_ns": span, "warp_start_ns": _pct(starts.tolist()),
            "warp_end_ns": _pct(ends.tolist()),
            "warps": int(seen[:, 0].sum()), "sms": int(len(np.unique(
                sm[seen[:, 0], 0]))), "sm_mhz": float(mhz),
            "tiers": by_tier}


def probe(path: str) -> dict:
    """The kept planes through this checkout's kernels built with the
    clock hooks of tools/leaf_probe.cu."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    from mousiki_tpu_torch.ops import _build
    from mousiki_tpu_torch.ops import pvq_leaves as pvq
    root = os.getcwd()
    os.makedirs(_build.BUILD, exist_ok=True)
    lib_path = os.path.join(_build.BUILD, "libleaf_probe.so")
    flags = [_build.nvcc_path(), *_build.NVCC_FLAGS]
    res = subprocess.run([*flags, "-o", lib_path,
                          os.path.join(root, "tools", "leaf_probe.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(res.stderr)
    ptxas = subprocess.run(
        [*flags, "-Xptxas", "-v", "-o", os.path.join(_build.BUILD,
                                                     "ptxas_v.so"),
         os.path.join(_build.CSRC, "pvq_leaves.cu")],
        capture_output=True, text=True).stderr
    lib = ctypes.CDLL(lib_path)
    real_stage, real_walk = pvq._kernels()
    stage_fn, walk_fn = lib.mousiki_pvq_leaf_stage, lib.mousiki_cwrs_walk
    stage_fn.argtypes, stage_fn.restype = real_stage.argtypes, ctypes.c_int
    walk_fn.argtypes, walk_fn.restype = real_walk.argtypes, ctypes.c_int
    lib.leaf_probe_set.argtypes = [ctypes.c_void_p, ctypes.c_int]
    kernels = pvq._kernels
    pvq._kernels = lambda: (stage_fn, walk_fn)
    dev = torch.device(DEVICE)
    kept = torch.load(path)
    out = {"tree": root, "ptxas": [ln.strip() for ln in ptxas.splitlines()
                                   if "registers" in ln or "spill" in ln]}

    def run(fn, leaves, tiers, values):
        buf = torch.zeros((leaves, POINTS, 3), dtype=torch.int64,
                          device=dev)
        fn()   # built and warm
        torch.cuda.synchronize()
        assert lib.leaf_probe_set(buf.data_ptr(), leaves) == 0
        fn()
        torch.cuda.synchronize()
        assert lib.leaf_probe_set(None, 0) == 0
        return _read_probe(buf.cpu().numpy().view(np.uint64), tiers,
                           _lanes(values))

    try:
        for name, calls in kept["walks"].items():
            for t, (planes, nmax) in enumerate(calls):
                d = _on(planes, dev)
                args = [d[x] for x in ("active", "n", "k", "idx")]
                leaves = int(d["n"].numel())
                out[f"walk_{name}_tier{t}"] = run(
                    lambda: pvq.cwrs_walk(*args, nmax), leaves,
                    [(nmax, leaves)], False)
        p, kw = kept["stage"]
        p = _on(p, dev)
        tiers = [(nmax, int(a.numel()))
                 for a, (nmax, _) in zip(p["pvq_active"], pvq.TIERS)]
        out["stage"] = run(lambda: pvq.leaf_stage(p, **kw),
                           sum(n for _, n in tiers), tiers[::-1], True)
    finally:
        pvq._kernels = kernels
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--child-probe", help=argparse.SUPPRESS)
    ap.add_argument("--trees", default=".", help="comma-separated checkouts")
    ap.add_argument("--order", help="comma-separated indices into --trees")
    ap.add_argument("--planes", help="file of the kept planes (made if "
                    "missing)")
    ap.add_argument("--probe", default="",
                    help="comma-separated indices into --trees")
    ap.add_argument("--out", help="file for the JSON lines")
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child)), flush=True)
        return 0
    if args.child_probe:
        print(json.dumps(probe(args.child_probe)), flush=True)
        return 0
    import tempfile
    planes = os.path.abspath(args.planes or os.path.join(
        tempfile.mkdtemp(), "leaf_planes.pt"))
    if not os.path.exists(planes):
        capture(planes)
    trees = [os.path.abspath(t) for t in args.trees.split(",")]
    order = [int(i) for i in (args.order or ",".join(
        str(i) for i in range(len(trees)))).split(",")]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    lines = []
    probes = [int(i) for i in args.probe.split(",") if i]
    for i, mode in [(i, "--child") for i in order] + [
            (i, "--child-probe") for i in probes]:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              mode, planes], cwd=trees[i],
                             capture_output=True, text=True)
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
