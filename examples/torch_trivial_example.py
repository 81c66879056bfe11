"""48 kHz stereo encode -> decode round trip via the typed facade, with
the PyTorch/CUDA port's copy of the single-stream API (the twin of
examples/trivial_example.py).

    python3 examples/torch_trivial_example.py

The codec here is the copied numpy host code: it runs on the host, as the
reference does, and nothing of it reaches the card, so it takes no
--device.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # runnable from anywhere

import numpy as np

import mousiki_tpu_torch as m


def run(seconds: float = 1.0) -> np.ndarray:
    """The example's body over `seconds` of 440 / 660 Hz tones; returns
    the decoded PCM."""
    t = np.arange(int(48000 * seconds)) / 48000.0
    pcm = np.stack([0.3 * np.sin(2 * np.pi * 440 * t),
                    0.3 * np.sin(2 * np.pi * 660 * t)], 1)

    enc = m.Encoder(48000, 2).set_bitrate(96000)
    dec = m.Decoder(48000, 2)
    out = []
    for f in range(len(pcm) // 960):
        pkt = enc.encode_float(pcm[f * 960:(f + 1) * 960], 960)
        out.append(dec.decode_float(pkt, 960))
    out = np.concatenate(out)
    print(f"encoded+decoded {len(out)} samples, "
          f"rms={np.sqrt((out ** 2).mean()):.3f}")
    return out


def main():
    run()


if __name__ == "__main__":
    main()
