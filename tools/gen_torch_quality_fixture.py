#!/usr/bin/env python3
"""Make the port's encode quality fixture
(testdata/encode_quality_fixture.npz) with the system libopus, through the
port's copied oracle (mousiki_tpu_torch/hostcodec/testing/oracle.py).

    python3 tools/gen_torch_quality_fixture.py           # write the file
    python3 tools/gen_torch_quality_fixture.py --check   # make it again
                                                         # and compare

chip_smoke.py's phase encode_quality runs where libopus is missing, so
what it is held to is made here, by the port on the CPU
(mousiki_tpu_torch/quality.py):

  celt: the CPU port's packets of testdata/corpus.wav (200 frames) at 64,
        96 and 128 kbit/s (encode_celt_corpus), libopus's scores of them
        (decoded by libopus, opus_compare against the corpus) and of
        libopus's own CBR restricted-low-delay encode at the same rates;
  silk: the CPU port's packets of the 24 and 32 kbit/s lanes over the
        first 16 frames of make_speech() (encode_silk_cases), and
        libopus's float decode of them;
  libopus: the library's version string.

--check exits non-zero unless everything made now equals the file's: a
change to the port's encoders (or another libopus build) shows as a
stale fixture.
"""

import argparse
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

from mousiki_tpu_torch import quality as q  # noqa: E402
from mousiki_tpu_torch.hostcodec.testing import oracle  # noqa: E402


def make_fixture() -> dict:
    if not oracle.available():
        raise RuntimeError("libopus is not installed: the fixture needs it")
    corpus = q.load_corpus()
    ref16 = q.downmix_16k(corpus[: len(corpus) // q.FRAME * q.FRAME])
    celt = [q.encode_celt_corpus(rate, device="cpu") for rate in q.CELT_RATES]
    lib = [q.encode_libopus_celt(corpus, rate) for rate in q.CELT_RATES]
    silk, _ = q.encode_silk_cases(q.SILK_WIDEBAND, device="cpu",
                                  n_frames=q.FIXTURE_SILK_FRAMES)
    return {"libopus": oracle.version(), "celt_packets": celt,
            "celt_scores": q.score(ref16, celt, 2, q.decode_libopus),
            "celt_libopus_scores": q.score(ref16, lib, 2, q.decode_libopus),
            "silk_packets": silk,
            "silk_libopus_pcm": np.stack(q.decode_libopus(silk, 1))}


def _differences(got: dict, want: dict) -> list:
    return [key for key in got
            if not (np.array_equal(got[key], want[key])
                    if isinstance(got[key], np.ndarray)
                    else got[key] == want[key])]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="make the fixture again and compare with the file")
    ap.add_argument("--out", default=q.FIXTURE)
    args = ap.parse_args()
    fx = make_fixture()
    if args.check:
        bad = _differences(fx, q.load_fixture(args.out))
        print(f"{args.out}: " + ("matches " + fx["libopus"] if not bad
                                 else "differs in " + ", ".join(bad)))
        return 1 if bad else 0
    q.save_fixture(args.out, fx)
    print(f"wrote {args.out}: {os.path.getsize(args.out)} bytes, "
          f"{fx['libopus']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
