"""Whether a stream's decode step depends on the batch it shares, for a
checkout of the port: batch_stages.py's comparison of 16 lossy streams as
one batch, as 8 batches of 2 and as 5 + 11, on the stereo CELT plan path
(8 frames, 30% loss from frame 2, seed 5) and the mixed mono path (6
frames, 15% loss from frame 1, seed 31), the inputs of
tests/test_torch_batch_invariance.py; with --jax, the port's PCM of the
one batch against the JAX package's pipeline on the same frames.

    python tools/torch_batch_invariance.py [--tree DIR] [--device DEV] \\
        [--jax] [--out FILE]

--tree: the checkout whose mousiki_tpu_torch is measured (default: this
one; a stage an older checkout lacks is not compared). --device: where
the port runs (default cpu). --jax (on the CPU): the worst difference
from the JAX package on received lanes and on lost and just-recovered
lanes. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from functools import partial

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_errors(path, frames, lost, make_port):
    import numpy as np
    from mousiki_tpu.celt import host_native as jax_host_native
    from mousiki_tpu.pipeline import CeltStreamPipeline as JaxCelt
    from mousiki_tpu.pipeline import OpusStreamPipeline as JaxOpus
    from mousiki_tpu_torch.pipeline import SERVING_PROFILE

    S = lost.shape[0]
    jax_host_native.set_plan_profile(*SERVING_PROFILE)
    ref = (JaxCelt(S, channels=2, use_plan=True) if path == "celt"
           else JaxOpus(S))
    port = make_port(S)
    rx = plc = 0.0
    for f, batch in enumerate(frames):
        err = np.abs(port.step(batch).cpu().numpy()
                     - np.asarray(ref.step(batch, 960))).max(axis=(1, 2))
        hit = lost[:, f] | (lost[:, f - 1] if f else False)
        rx = max(rx, float(err[~hit].max()))
        if hit.any():
            plc = max(plc, float(err[hit].max()))
    return {"worst_err_received": rx, "worst_err_concealed": plc}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path[:0] = [os.path.abspath(args.tree), ROOT]
    import torch

    import batch_stages
    from golden_streams import frame_batch, load_mono_mix, load_stereo_celt
    from mousiki_tpu_torch.pipeline import (SERVING_PROFILE,
                                            CeltStreamPipeline,
                                            OpusStreamPipeline,
                                            set_plan_profile)
    torch.set_num_threads(1)
    set_plan_profile(*SERVING_PROFILE)
    dev = torch.device(args.device)
    paths = {
        "celt": (partial(frame_batch, load_stereo_celt()), (8, 0.3, 5, 2),
                 lambda n: CeltStreamPipeline(n, 2, use_plan=True,
                                              device=dev)),
        "mixed": (partial(frame_batch, load_mono_mix(), packets=True),
                  (6, 0.15, 31, 1),
                  lambda n: OpusStreamPipeline(n, channels=1, device=dev)),
    }
    out = {"tree": os.path.abspath(args.tree), "device": str(dev)}
    if dev.type == "cuda":
        out["card"] = torch.cuda.get_device_name(dev)
    for path, (batch_fn, draw, make) in paths.items():
        frames, lost = batch_stages.lossy_frames(batch_fn, 16, *draw)
        res = batch_stages.split_errors(make, frames, 16,
                                        {"8x2": (2,) * 8, "5+11": (5, 11)})
        res.pop("decode_mem")
        if args.jax:
            res["jax"] = _jax_errors(path, frames, lost, make)
        out[path] = res
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
