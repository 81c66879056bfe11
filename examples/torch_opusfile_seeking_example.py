"""Seek inside an Ogg Opus stream and read a window of samples with the
PyTorch/CUDA port's copy of the single-stream API (the twin of
examples/opusfile_seeking_example.py).

    python3 examples/torch_opusfile_seeking_example.py [file.opus]

Without a file it writes one to seek in. The codec is the copied numpy
host code: it runs on the host, as the reference does, and nothing of it
reaches the card, so it takes no --device.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # runnable from anywhere

import argparse

import numpy as np

import mousiki_tpu_torch as m


def synthesize(seconds: float = 2.0) -> bytes:
    """An Ogg Opus file to seek in: `seconds` of a 330 Hz tone, 48 kHz
    mono at 64 kbit/s."""
    rate = 48000
    t = np.arange(int(rate * seconds)) / rate
    oe = m.OpusEnc(rate, 1, bitrate=64000)
    oe.write((0.4 * np.sin(2 * np.pi * 330 * t))[:, None])
    return oe.finish()


def seek(data: bytes) -> tuple[int, int, np.ndarray]:
    """The example's body: the 4800 samples from the middle of the file.
    Returns (pcm_total, the sample sought, the window)."""
    rd = m.OggOpusReader(data)
    total = rd.pcm_total()
    target = total // 2
    window = rd.read_from(target, 4800)
    print(f"pcm_total={total}, read {window.shape} at sample {target}, "
          f"rms={np.sqrt((window ** 2).mean()):.3f}")
    return total, target, window


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("path", nargs="?", help="the .opus file (default: "
                    "synthesize one)")
    args = ap.parse_args(argv)
    seek(open(args.path, "rb").read() if args.path else synthesize())


if __name__ == "__main__":
    main()
