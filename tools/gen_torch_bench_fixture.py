#!/usr/bin/env python3
"""Make the port's bench fixture (testdata/bench_fixture.npz) with the
system libopus, through the port's copied oracle
(mousiki_tpu_torch/hostcodec/testing/oracle.py).

    python3 tools/gen_torch_bench_fixture.py           # write the file
    python3 tools/gen_torch_bench_fixture.py --check   # encode again and
                                                       # compare with it

The bench (mousiki_tpu_torch/bench.py) runs where libopus is missing, so
the packets it decodes and libopus's side of its quality gate are made
here, as bench.py makes them at run time:

  synthetic: 48 stereo frames of make_test_signal(960 * 49, 2, seed=3),
             APP_RESTRICTED_LOWDELAY at 128 kbit/s (bench.py's
             build_packets);
  corpus:    testdata/corpus.wav (200 frames), the same encoder settings
             (bench.py's quality_gate);
  each with the full packets, their CELT payloads (parse_packet's first
  frame), libopus's final range after decoding each packet, and
  downmix_16k of libopus's float decode of all frames and of the first
  16 (the quick gate's);
  mixed:     3 mono streams x 24 packets of make_test_signal(960 * 25, 1,
             seed=5): CELT at 96 kbit/s, SILK wideband at 16 kbit/s and
             hybrid super-wideband at 40 kbit/s (bench.py's
             build_mixed_packets), with libopus's final ranges;
  libopus:   the library's version string.

--check exits non-zero unless every array made now equals the file's
(another libopus build may encode other bytes).
"""

import argparse
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

from mousiki_tpu_torch import bench  # noqa: E402
from mousiki_tpu_torch.bitstream.packet import parse_packet  # noqa: E402
from mousiki_tpu_torch.hostcodec.testing import oracle  # noqa: E402

FRAME = 960


def _encode(pcm: np.ndarray, channels: int, app: int, bitrate: int,
            bandwidth=None) -> list:
    enc = oracle.RefEncoder(48000, channels, app)
    enc.ctl_set(oracle.SET_BITRATE, bitrate)
    if bandwidth is not None:
        enc.ctl_set(oracle.SET_BANDWIDTH, bandwidth)
    pcm16 = oracle.float_to_i16(pcm)
    return [enc.encode(pcm16[f * FRAME:(f + 1) * FRAME].reshape(-1))
            for f in range(len(pcm) // FRAME)]


def _decode(packets: list, channels: int):
    """libopus's float decode of every packet, and its final range after
    each."""
    dec = oracle.RefDecoder(48000, channels)
    pcm, ranges = [], []
    for p in packets:
        pcm.append(dec.decode_float(p, FRAME))
        ranges.append(dec.final_range())
    return np.concatenate(pcm, axis=0), np.asarray(ranges, np.uint32)


def _signal(pcm: np.ndarray) -> dict:
    packets = _encode(pcm, 2, oracle.APP_RESTRICTED_LOWDELAY, 128000)
    ref, ranges = _decode(packets, 2)
    n_quick = bench.QUICK.gate_frames
    return {"packets": packets,
            "payloads": [parse_packet(p).frames[0] for p in packets],
            "final_range": ranges,
            "ref16k": bench.downmix_16k(ref),
            "ref16k_quick": bench.downmix_16k(ref[:n_quick * FRAME])}


def make_fixture() -> dict:
    if not oracle.available():
        raise RuntimeError("libopus is not installed: the fixture needs it")
    corpus = bench.load_corpus()
    if corpus is None:
        raise FileNotFoundError("testdata/corpus.wav is missing")
    n = bench.N_FRAMES
    fx = {"libopus": oracle.version(),
          "synthetic": _signal(oracle.make_test_signal(FRAME * (n + 1), 2,
                                                       seed=3)[:n * FRAME]),
          "corpus": _signal(corpus)}
    mono = oracle.make_test_signal(FRAME * 25, 1, seed=5)[:24 * FRAME]
    streams = [
        _encode(mono, 1, oracle.APP_RESTRICTED_LOWDELAY, 96000),
        _encode(mono, 1, oracle.APP_VOIP, 16000,
                oracle.BANDWIDTH_WIDEBAND),
        _encode(mono, 1, oracle.APP_VOIP, 40000,
                oracle.BANDWIDTH_SUPERWIDEBAND)]
    fx["mixed"] = {"packets": streams,
                   "final_range": np.stack([_decode(s, 1)[1]
                                            for s in streams])}
    return fx


def _differences(got: dict, want: dict) -> list:
    bad = []
    if got["libopus"] != want["libopus"]:
        bad.append(f"libopus {got['libopus']!r} != {want['libopus']!r}")
    for name in bench.SIGNALS:
        for key, value in got[name].items():
            if isinstance(value, list):
                same = value == want[name][key]
            else:
                same = np.array_equal(value, want[name][key])
            if not same:
                bad.append(f"{name}.{key}")
    if got["mixed"]["packets"] != want["mixed"]["packets"]:
        bad.append("mixed.packets")
    if not np.array_equal(got["mixed"]["final_range"],
                          want["mixed"]["final_range"]):
        bad.append("mixed.final_range")
    return bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="encode again and compare with the committed file")
    ap.add_argument("--out", default=bench.FIXTURE)
    args = ap.parse_args()
    fx = make_fixture()
    if args.check:
        bad = _differences(fx, bench.load_fixture(args.out))
        print(f"{args.out}: " + ("matches " + fx["libopus"] if not bad
                                 else "differs in " + ", ".join(bad)))
        return 1 if bad else 0
    bench.save_fixture(args.out, fx)
    n = sum(len(fx[s]["packets"]) for s in bench.SIGNALS) \
        + sum(len(s) for s in fx["mixed"]["packets"])
    print(f"wrote {args.out}: {n} packets, {os.path.getsize(args.out)} "
          f"bytes, {fx['libopus']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
