#!/usr/bin/env python3
"""CELT encoder quality of the PyTorch port against libopus, on the music
corpus: the port's twin of tools/celt_quality_report.py. Writes
QUALITY_CELT_TORCH.md.

    python3 tools/torch_celt_quality_report.py [--device cuda] \\
        [--out QUALITY_CELT_TORCH.md] [--reference] [--card JSON]

Encodes testdata/corpus.wav with the port's CeltEncodePipeline on
--device (default cuda) at 64, 96 and 128 kbit/s CBR and with libopus
(CELT-only restricted low delay, the same CBR rates), decodes both with
libopus and scores each against the original with tools/opus_compare.py
(mousiki_tpu_torch/quality.py). --reference also encodes the corpus with
the JAX package's CeltEncodePipeline (run live: QUALITY_CELT.md's rows
predate later changes of that encoder) and reports the share of packets
byte-equal to it. --card takes the chip_smoke.json of a run on the card
(`python3 chip_smoke.py --out DIR`) and adds its phase encode_quality.
Needs the system libopus: without it the run raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mousiki_tpu_torch import quality as q  # noqa: E402


def _jax_packets(rate: int, sig) -> list:
    from mousiki_tpu.pipeline import CeltEncodePipeline
    return q.celt_packets(CeltEncodePipeline(1, channels=2, bitrate=rate),
                          sig)


def run(device: str, reference: bool = False) -> list:
    sig = q.load_corpus()
    ref16 = q.downmix_16k(sig[: len(sig) // q.FRAME * q.FRAME])

    def scored(packets):
        return q.score(ref16, [packets], 2, q.decode_libopus)[0]

    rows = []
    for rate in q.CELT_RATES:
        port = q.encode_celt_corpus(rate, device=device)
        row = {"rate": rate, "port": scored(port),
               "libopus": scored(q.encode_libopus_celt(sig, rate))}
        if reference:
            jax = _jax_packets(rate, sig)
            row.update(jax=scored(jax), equal_to_jax=q.equal_share(port, jax))
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(ROOT,
                                                  "QUALITY_CELT_TORCH.md"))
    ap.add_argument("--reference", action="store_true",
                    help="also run the JAX package's pipeline")
    ap.add_argument("--card", help="chip_smoke.json of a run on the card")
    args = ap.parse_args(argv)
    card = None
    if args.card:
        with open(args.card) as fh:
            card = json.load(fh)["encode_quality"]
    rows = run(args.device, args.reference)
    q.write_celt_report(args.out, rows, args.device, card)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
