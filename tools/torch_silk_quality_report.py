#!/usr/bin/env python3
"""SILK encoder quality of the PyTorch port against libopus, on the
synthetic speech corpus: the port's twin of tools/silk_quality_report.py.
Writes QUALITY_SILK_TORCH.md.

    python3 tools/torch_silk_quality_report.py [--device cuda] \\
        [--out QUALITY_SILK_TORCH.md] [--reference] [--card JSON]

Encodes the reference's make_speech() corpus (300 frames) with ONE port
SilkEncodePipeline on --device (default cuda), lane k at the reference's
case k (6-32 kbit/s), and with libopus at the same targets (the
reference tool's settings), decodes both with libopus and scores each
against the original with tools/opus_compare.py
(mousiki_tpu_torch/quality.py). Each row gives the device quantizer
calls that held its lane: only the 24 and 32 kbit/s lanes (16 kHz
internal rate) reach ops/silk_nsq.py. --reference also encodes every
case with the JAX package's SilkEncodePipeline (one a case) and reports
the share of packets byte-equal to it. --card takes the
chip_smoke.json of a run on the card and adds its phase encode_quality.
Needs the system libopus: without it the run raises. About 11 minutes on
one CPU core for the port, 8-10 more with --reference.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mousiki_tpu_torch import quality as q  # noqa: E402


def _jax_lane(rate: int, sig) -> tuple[list, int]:
    """One lane of the JAX package's SilkEncodePipeline at `rate`: its
    packets and its device quantizer calls."""
    from mousiki_tpu.pipeline import SilkEncodePipeline
    pipe = SilkEncodePipeline(1)
    calls = [0]
    dispatch = pipe._ex._dispatch

    def counted(reqs):
        calls[0] += 1
        return dispatch(reqs)

    pipe._ex._dispatch = counted
    return q.silk_packets(pipe, [rate], sig)[0], calls[0]


def run(device: str, reference: bool = False) -> list:
    sig = q.speech_frames()
    ref16 = q.downmix_16k(sig)
    packets, calls = q.encode_silk_cases(q.SILK_CASES, device=device)
    port = q.score(ref16, packets, 1, q.decode_libopus)
    rows = []
    for k, case in enumerate(q.SILK_CASES):
        lib = q.encode_libopus_silk(sig, case[1])
        row = {"case": case, "port": port[k], "device_calls": calls[k],
               "libopus": q.score(ref16, [lib], 1, q.decode_libopus)[0]}
        if reference:
            jax, n = _jax_lane(case[0], sig)
            row.update(jax=q.score(ref16, [jax], 1, q.decode_libopus)[0],
                       jax_device_calls=n,
                       equal_to_jax=q.equal_share(packets[k], jax))
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(ROOT,
                                                  "QUALITY_SILK_TORCH.md"))
    ap.add_argument("--reference", action="store_true",
                    help="also run the JAX package's pipeline")
    ap.add_argument("--card", help="chip_smoke.json of a run on the card")
    args = ap.parse_args(argv)
    card = None
    if args.card:
        with open(args.card) as fh:
            card = json.load(fh)["encode_quality"]
    rows = run(args.device, args.reference)
    q.write_silk_report(args.out, rows, args.device, card)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
