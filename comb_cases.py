"""Seeded rows for the synthesis postfilter's comb filter (the port's
ops/synthesis.comb_filter_batched): decode memory and postfilter
parameters that cover the filter's cases beyond what the golden streams
reach. Shared by the port's tests and chip_smoke.py; it is not part of
any installed package.
"""

from __future__ import annotations

import numpy as np

from mousiki_tpu_torch.celt.modes import DECODE_BUFFER_SIZE

# the longest pitch period the CELT decoder sends
MAX_PERIOD = 1022
# the filter's blend region, OVERLAP samples of each call
BLEND = 120
ROW_LEN = DECODE_BUFFER_SIZE + BLEND // 2


# the special rows of comb_rows past the first six: name -> (t0, t1),
# min(t0, t1) at the edges of the comb kernel's chunk (min(t0, t1) - 2,
# at least 13, at most the 128 lanes of a row; up to 32 on one warp)
EDGE_ROWS = {
    "lag_33": (33, 33),
    "lag_34": (34, 34),
    "lag_35": (35, 35),
    "lag_130": (130, 130),
    "lag_131": (131, 131),
    "one_short": (17, MAX_PERIOD),
}


def comb_rows(rng, n_streams: int, channels: int = 2) -> dict:
    """Decode memory (n_streams, channels, ROW_LEN) float32 and the
    postfilter's parameters (int32 periods and tapsets, float32 gains)
    from a numpy Generator: periods 15..MAX_PERIOD, tapsets 0-2, gains in
    [0.05, 0.75), with the special rows 0 the shortest period, 1 the
    longest, 2 g1 = 0 (the filter stops after the blend), 3 g0 = g1 = 0
    (the row left as it is), 4 the same filter before and after (no
    blend), 5 only g0 = 0, and 6-11 the EDGE_ROWS in order. Needs
    n_streams >= 12."""
    S = n_streams
    buf = (rng.standard_normal((S, channels, ROW_LEN)) * 3000).astype(
        np.float32)
    t0 = rng.integers(15, MAX_PERIOD + 1, S).astype(np.int32)
    t1 = rng.integers(15, MAX_PERIOD + 1, S).astype(np.int32)
    g0 = rng.uniform(0.05, 0.75, S).astype(np.float32)
    g1 = rng.uniform(0.05, 0.75, S).astype(np.float32)
    tap0 = rng.integers(0, 3, S).astype(np.int32)
    tap1 = rng.integers(0, 3, S).astype(np.int32)
    t0[0] = t1[0] = 15
    t0[1] = t1[1] = MAX_PERIOD
    g1[2] = 0.0
    g0[3] = g1[3] = 0.0
    t1[4], g1[4], tap1[4] = t0[4], g0[4], tap0[4]
    g0[5] = 0.0
    for k, (a, b) in enumerate(EDGE_ROWS.values(), start=6):
        t0[k], t1[k] = a, b
    return dict(buf=buf, t0=t0, t1=t1, g0=g0, g1=g1, tap0=tap0, tap1=tap1)


def comb_calls(n: int) -> list:
    """(pos, N) of the comb filter calls a frame of n samples makes
    (ops/synthesis.synthesis_step): the blend over the first
    min(BLEND, n) samples, then the rest."""
    pos = DECODE_BUFFER_SIZE - n
    blend = min(BLEND, n)
    return [(pos, blend)] + ([(pos + blend, n - blend)] if n > blend else [])
