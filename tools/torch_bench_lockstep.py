#!/usr/bin/env python3
"""Standalone perf probe of the PyTorch/CUDA port's lockstep CELT decoder
(ops/celt_lockstep_top.lockstep_synthesis_step: symbol decode, band walk,
plan emission, band execution and synthesis, all on the device; the host
only pads the packets). The twin of tools/bench_lockstep.py.

    python3 tools/torch_bench_lockstep.py [S] [BITRATE] [--device cuda|cpu]
        [--iters 10] [--trials 3] [--fixture PATH]

S stereo lanes (default 256) decode 48 kHz 20 ms CELT frames, lane s
taking packet s mod 32, zero-padded to 512 bytes, the state carried from
step to step. Prints the device, the first step's seconds (the label is
the reference's `compile+first:`; eager torch compiles nothing), one line
of ms per step and aggregate realtime-x for each trial of --iters steps,
and whether every lane of the first step decoded.

The 32 packets are libopus's (restricted low delay, BITRATE, the
reference's signal), read from testdata/lockstep_bench_fixture.npz: the
card's host has no libopus. That file holds 96 kbit/s (the default);
another BITRATE needs a fixture made where libopus is by
tools/gen_torch_lockstep_fixture.py --bitrate BITRATE --out PATH, passed
here as --fixture PATH. A stereo step at S = 256 takes about 25 s on an
H100 (PERF.md section 5): the reference's 1 + 3 x 10 steps take minutes.
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mousiki_tpu_torch._device import from_cli  # noqa: E402
from mousiki_tpu_torch.ops import celt_lockstep_top as top  # noqa: E402
from mousiki_tpu_torch.ops import synthesis  # noqa: E402
from mousiki_tpu_torch.ops.band_exec import plan_combo_mats  # noqa: E402
from mousiki_tpu_torch.repo_files import (pack_bytes,  # noqa: E402
                                          unpack_bytes)

FIXTURE = os.path.join(ROOT, "testdata", "lockstep_bench_fixture.npz")
GENERATOR = "tools/gen_torch_lockstep_fixture.py"
C = 2
FRAME = 960
BITRATE = 96000
N_PACKETS = 32
L = 512


def save_fixture(path: str, fx: dict) -> None:
    """fx: {"libopus": version, "bitrate": int, "packets": full packets,
    "payloads": their CELT frames}; each byte string list as one uint8
    blob and its lengths, so the file loads without pickle."""
    arrays = {"libopus": np.asarray(fx["libopus"]),
              "bitrate": np.asarray(fx["bitrate"], np.int64)}
    for key in ("packets", "payloads"):
        arrays[key], arrays[f"{key}_len"] = pack_bytes(fx[key])
    np.savez_compressed(path, **arrays)


def load_fixture(path: str = FIXTURE) -> dict:
    """save_fixture's dict, read back."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} is missing; make it with `python3 {GENERATOR}` where "
            "libopus is installed")
    with np.load(path, allow_pickle=False) as z:
        fx = {"libopus": str(z["libopus"]), "bitrate": int(z["bitrate"])}
        for key in ("packets", "payloads"):
            fx[key] = unpack_bytes(z[key], z[f"{key}_len"])
    return fx


def load_payloads(bitrate: int = BITRATE, path: str = FIXTURE) -> list:
    """The fixture's 32 CELT payloads (parse_packet's first frame of each
    packet); raises unless they were encoded at `bitrate`."""
    fx = load_fixture(path)
    if fx["bitrate"] != bitrate:
        raise ValueError(
            f"{path} holds {fx['bitrate']} bit/s packets, not {bitrate}: "
            f"make them where libopus is with `python3 {GENERATOR} "
            f"--bitrate {bitrate} --out PATH` and pass --fixture PATH")
    return fx["payloads"]


def pad(pkts: list, S: int) -> tuple[np.ndarray, np.ndarray]:
    """Lane s takes packet s mod len(pkts), zero-padded to L bytes: the
    (S, L) uint8 matrix and the (S,) int32 lengths."""
    buf = np.zeros((S, L), np.uint8)
    st = np.zeros(S, np.int32)
    for s in range(S):
        p = pkts[s % len(pkts)]
        buf[s, :len(p)] = np.frombuffer(p, np.uint8)
        st[s] = len(p)
    return buf, st


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(S: int = 256, bitrate: int = BITRATE, *, device, iters: int = 10,
        trials: int = 3, fixture: str = FIXTURE) -> dict:
    """The probe's body on `device`. Returns the first step's seconds, PCM
    and ok flags, and the ms per step and realtime-x of each trial."""
    dev = torch.device(device)
    buf, st = pad(load_payloads(bitrate, fixture), S)
    print("device:", dev if dev.type != "cuda"
          else f"{dev} ({torch.cuda.get_device_name(dev)})", flush=True)
    bufd = torch.from_numpy(buf).to(dev)
    std = torch.from_numpy(st.astype(np.int64)).to(dev)
    consts = synthesis.make_consts(FRAME, dev)
    sstate = synthesis.init_state(S, C, dev)
    lstate = top.init_state(S, device=dev)
    mats = plan_combo_mats(C, FRAME, dev)
    t0 = time.time()
    pcm, sstate, lstate, ok = top.lockstep_synthesis_step(
        consts, sstate, lstate, bufd, std, mats, C=C, frame=FRAME)
    _sync(dev)
    first_s = time.time() - t0
    print("compile+first:", round(first_s, 1), "s", flush=True)
    step_ms, rates = [], []
    for trial in range(trials):
        t0 = time.time()
        for _ in range(iters):
            _, sstate, lstate, _ = top.lockstep_synthesis_step(
                consts, sstate, lstate, bufd, std, mats, C=C, frame=FRAME)
        _sync(dev)
        dt = (time.time() - t0) / iters
        step_ms.append(dt * 1e3)
        rates.append(0.02 * S / dt)
        print(f"step: {dt*1e3:.2f} ms  -> {0.02*S/dt:.0f}x realtime",
              flush=True)
    ok_all = bool(ok.all())
    print("ok(first step):", ok_all)
    return {"first_s": first_s, "pcm": pcm, "ok": ok, "ok_all": ok_all,
            "step_ms": step_ms, "realtime_x": rates}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("streams", nargs="?", type=int, default=256)
    ap.add_argument("bitrate", nargs="?", type=int, default=BITRATE)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--iters", type=int, default=10,
                    help="steps a timed trial (default 10)")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--fixture", default=FIXTURE)
    args = ap.parse_args(argv)
    run(args.streams, args.bitrate, device=from_cli(args.device),
        iters=args.iters, trials=args.trials, fixture=args.fixture)


if __name__ == "__main__":
    main()
