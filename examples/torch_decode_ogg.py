"""Decode an .opus (Ogg Opus) file to raw f32 PCM on stdout with the
PyTorch/CUDA port's copy of the single-stream API (the twin of
examples/decode_ogg.py).

    python3 examples/torch_decode_ogg.py <file.opus> > out.f32

The decoder is the copied numpy host code: it runs on the host, as the
reference does, and nothing of it reaches the card, so it takes no
--device.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # runnable from anywhere

import argparse
import sys

import numpy as np

import mousiki_tpu_torch as m


def decode(data: bytes) -> np.ndarray:
    """The example's body: every sample of an Ogg Opus file, as the
    little-endian f32 array it writes; the stream's facts go to stderr."""
    f = m.OpusFile(data)
    print(f"links={f.link_count} channels={f.channel_count(0)} "
          f"pcm_total={f.pcm_total()}", file=sys.stderr)
    return f.decode_all().astype("<f4")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("path", help="the .opus file")
    pcm = decode(open(ap.parse_args(argv).path, "rb").read())
    sys.stdout.buffer.write(pcm.tobytes())


if __name__ == "__main__":
    main()
