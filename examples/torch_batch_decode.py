"""The serving path of the PyTorch/CUDA port: decode S parallel CELT
streams end to end through the native host stage and the device synthesis
(the twin of examples/batch_decode_tpu.py).

    python3 examples/torch_batch_decode.py [S] [--device cuda|cpu]

S defaults to 8 and --device to cuda (which raises without a GPU). As in
the reference, the pipeline is `CeltStreamPipeline(S)`: its defaults are
the non-plan path (the native host reconstructs the bands, the device
runs the synthesis, with the de-emphasis kernel once a step); pass
use_plan=True for the plan-mode serving path.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # runnable from anywhere

import argparse

import numpy as np

from mousiki_tpu_torch._device import from_cli
from mousiki_tpu_torch.hostcodec.opus_encoder import OpusEncoder
from mousiki_tpu_torch.pipeline import CeltStreamPipeline

N_FRAMES = 25


def encode_tones(n_frames: int = N_FRAMES) -> list:
    """n_frames 20 ms packets of 440 / 660 Hz tones, 48 kHz stereo at
    96 kbit/s, from the copied OpusEncoder."""
    enc = OpusEncoder(48000, 2)
    enc.set_bitrate(96000)
    t = np.arange(960 * n_frames) / 48000.0
    sig = np.stack([0.3 * np.sin(2 * np.pi * 440 * t),
                    0.3 * np.sin(2 * np.pi * 660 * t)], 1)
    return [enc.encode(sig[f * 960:(f + 1) * 960], 960)
            for f in range(n_frames)]


def decode(payloads: list, S: int, *, device) -> list:
    """Every payload to all S streams of `CeltStreamPipeline(S)`, one step
    a payload; the (S, 960, 2) PCM of each step, on `device`."""
    pipe = CeltStreamPipeline(S, device=device)
    return [pipe.step([pl] * S) for pl in payloads]


def run(S: int = 8, n_frames: int = N_FRAMES, *, device):
    """The example's body: returns (packets, the PCM of every step)."""
    pkts = encode_tones(n_frames)
    payloads = [p[1:] for p in pkts]  # strip TOC: pipeline takes payloads
    out = decode(payloads, S, device=device)
    print(f"decoded {len(payloads)} frames x {S} streams -> "
          f"last block {tuple(out[-1].shape)}")
    return pkts, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("streams", nargs="?", type=int, default=8)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    run(args.streams, device=from_cli(args.device))


if __name__ == "__main__":
    main()
