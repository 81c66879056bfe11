#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port: end-to-end aggregate
realtime-x of batched 48 kHz stereo CELT decode on one NVIDIA GPU, with
its opus_compare quality gate (mousiki_tpu_torch/bench.py).

    python3 bench_torch.py [S] [--quick] [--s-big N] [--device cpu]

Prints one JSON line with bench.py's keys; phase seconds go to stderr.
"""

import sys

from mousiki_tpu_torch.bench import main

if __name__ == "__main__":
    sys.exit(main())
