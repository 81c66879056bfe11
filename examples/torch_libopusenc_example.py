"""Write an .opus file from arbitrary-rate PCM with the PyTorch/CUDA
port's copy of the single-stream API (the twin of
examples/libopusenc_example.py; its comments are the reference's, so the
two files' bytes can be compared).

    python3 examples/torch_libopusenc_example.py [out.opus]

The encoder is the copied numpy host code: it runs on the host, as the
reference does, and nothing of it reaches the card, so it takes no
--device.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # runnable from anywhere

import argparse

import numpy as np

import mousiki_tpu_torch as m


def write(out_path: str = "tone.opus", seconds: float = 2.0) -> bytes:
    """The example's body: `seconds` of a 440 Hz tone at 44.1 kHz mono,
    64 kbit/s, written to out_path; returns the file's bytes."""
    rate = 44100
    t = np.arange(int(rate * seconds)) / rate
    pcm = (0.4 * np.sin(2 * np.pi * 440 * t))[:, None]
    oe = m.OpusEnc(rate, 1, bitrate=64000,
                   comments=["TITLE=tone", "ARTIST=mousiki_tpu"])
    for i in range(0, len(pcm), 4410):
        oe.write(pcm[i: i + 4410])
    data = oe.finish()
    open(out_path, "wb").write(data)
    print(f"wrote {out_path}")
    return data


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out_path", nargs="?", default="tone.opus")
    write(ap.parse_args(argv).out_path)


if __name__ == "__main__":
    main()
