"""The 48 kHz / 960-sample CELT mode, as far as the port reads it.

Copies of mousiki_tpu/celt/modes.py (`EBAND5MS`, `_mdct_window`),
mousiki_tpu/celt/quant_bands.py (`E_MEANS`) and the decoder constants of
mousiki_tpu/celt/decoder.py. The JAX package builds every mode from first
principles; the port decodes the one 48 kHz family only, so `MODE` holds
just the fields the device half uses (tests/test_torch_tables.py checks
each against `opus_custom_mode(48000, 960)`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

# Band edges in units of (fs/400)/2-sample bins (2.5 ms MDCT at LM=0), the
# universal 21-band Bark-derived layout every Opus stream uses at 48 kHz.
EBAND5MS = [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16,
            20, 24, 28, 34, 40, 48, 60, 78, 100]

# Mean band energies (log2 units) removed before energy coding.
E_MEANS = np.array([
    6.4375, 6.25, 5.75, 5.3125, 5.0625, 4.8125, 4.5, 4.375, 4.875, 4.6875,
    4.5625, 4.4375, 4.875, 4.625, 4.3125, 4.5, 4.375, 4.625, 4.75, 4.4375,
    3.75, 3.75, 3.75, 3.75, 3.75,
], np.float32)

DECODE_BUFFER_SIZE = 2048
COMBFILTER_MINPERIOD = 15
COMBFILTER_MAXPERIOD = 1024
CELT_LPC_ORDER = 24
PLC_PITCH_LAG_MAX = 720
PLC_PITCH_LAG_MIN = 100


def _mdct_window(overlap: int) -> np.ndarray:
    i = np.arange(overlap, dtype=np.float64)
    inner = np.sin(0.5 * math.pi * (i + 0.5) / overlap)
    return np.sin(0.5 * math.pi * inner * inner).astype(np.float32)


class CeltMode(NamedTuple):
    fs: int
    overlap: int
    num_ebands: int
    short_mdct_size: int
    ebands: np.ndarray      # int16, num_ebands + 1 edges
    window: np.ndarray      # float32, len overlap


MODE = CeltMode(fs=48000, overlap=120, num_ebands=21, short_mdct_size=120,
                ebands=np.array(EBAND5MS, np.int16), window=_mdct_window(120))
