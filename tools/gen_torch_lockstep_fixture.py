#!/usr/bin/env python3
"""Make the lockstep probe's fixture (testdata/lockstep_bench_fixture.npz)
with the system libopus, through the port's copied oracle
(mousiki_tpu_torch/hostcodec/testing/oracle.py).

    python3 tools/gen_torch_lockstep_fixture.py           # write the file
    python3 tools/gen_torch_lockstep_fixture.py --check   # encode again and
                                                          # compare with it
    python3 tools/gen_torch_lockstep_fixture.py --bitrate N --out PATH

tools/torch_bench_lockstep.py runs where libopus is missing, so its
packets are made here, as tools/bench_lockstep.py makes them at run time:
32 frames of make_test_signal(960 * 40, 2, kind="mix", seed=3), 16-bit,
encoded stereo by libopus (APP_RESTRICTED_LOWDELAY, 96 kbit/s unless
--bitrate says otherwise); the file holds the full packets, their CELT
payloads (parse_packet's first frame), the bitrate and libopus's version
string. --check exits non-zero unless the packets made now equal the
file's (another libopus build may encode other bytes).
"""

import argparse
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)

import torch_bench_lockstep as probe  # noqa: E402
from mousiki_tpu_torch.bitstream.packet import parse_packet  # noqa: E402
from mousiki_tpu_torch.hostcodec.testing import oracle  # noqa: E402


def make_fixture(bitrate: int = probe.BITRATE) -> dict:
    if not oracle.available():
        raise RuntimeError("libopus is not installed: the fixture needs it")
    enc = oracle.RefEncoder(48000, probe.C, oracle.APP_RESTRICTED_LOWDELAY)
    enc.ctl_set(oracle.SET_BITRATE, bitrate)
    sig = oracle.make_test_signal(probe.FRAME * 40, probe.C, kind="mix",
                                  seed=3)
    pcm16 = oracle.float_to_i16(sig)
    frame = probe.FRAME
    pkts = [enc.encode(pcm16[f * frame:(f + 1) * frame].reshape(-1))
            for f in range(probe.N_PACKETS)]
    return {"libopus": oracle.version(), "bitrate": bitrate,
            "packets": pkts,
            "payloads": [parse_packet(p).frames[0] for p in pkts]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="encode again and compare with the file")
    ap.add_argument("--bitrate", type=int, default=probe.BITRATE)
    ap.add_argument("--out", default=probe.FIXTURE)
    args = ap.parse_args(argv)
    fx = make_fixture(args.bitrate)
    if args.check:
        want = probe.load_fixture(args.out)
        bad = [k for k in fx if fx[k] != want[k]]
        print(f"{args.out}: " + ("matches " + fx["libopus"] if not bad
                                 else "differs in " + ", ".join(bad)))
        return 1 if bad else 0
    probe.save_fixture(args.out, fx)
    print(f"wrote {args.out}: {len(fx['packets'])} packets at "
          f"{args.bitrate} bit/s, {os.path.getsize(args.out)} bytes, "
          f"{fx['libopus']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
