"""Seeded synthetic leaves for the PVQ leaf stage (the port's
ops/pvq_leaves.py): leaves that cover the kernels' domain for a tier,
beyond what the golden streams reach. Shared by the port's tests and
chip_smoke.py; it is not part of any installed package.
"""

from __future__ import annotations

import numpy as np

from mousiki_tpu_torch.ops._tables import U_K, u_table


def synthetic_leaves(nmax: int, seed: int, per_nk: int = 2) -> dict:
    """Leaves for a tier of width nmax, from a numpy seed: every (n, k)
    with 1 <= n <= nmax, 1 <= k < U_K - 1 and V(n, k) = U(n, k) +
    U(n, k + 1) < 2^32, each with idx 0, V - 1 and `per_nk` random values
    in between; spread cycling 0-3 and b cycling over those of 1, 2, 4, 8
    that divide n; gains in [0.1, 1); and one inactive leaf (random n, k,
    idx) every 8. Returns numpy planes: active bool, n, k, idx, b, spread
    int64, gain float32."""
    rng = np.random.default_rng(seed)
    U = u_table().astype(np.int64)
    rows = []
    for n in range(1, nmax + 1):
        for k in range(1, U_K - 1):
            v = int(U[n, k] + U[n, k + 1])
            if v >= 1 << 32:
                break
            picks = [0, v - 1] + rng.integers(0, v, per_nk).tolist()
            rows.extend((n, k, i) for i in picks)
    a = np.array(rows, np.int64)
    count = len(a)
    divs = {n: [b for b in (1, 2, 4, 8) if n % b == 0]
            for n in range(1, nmax + 1)}
    r = np.arange(count)
    b = np.array([divs[n][i % len(divs[n])] for i, n in zip(r, a[:, 0])],
                 np.int64)
    active = r % 8 != 7
    n = np.where(active, a[:, 0], rng.integers(1, nmax + 1, count))
    k = np.where(active, a[:, 1], rng.integers(0, 64, count))
    idx = np.where(active, a[:, 2], rng.integers(0, 1 << 32, count))
    return {"active": active, "n": n, "k": k, "idx": idx, "b": b,
            "spread": (r % 4).astype(np.int64),
            "gain": rng.uniform(0.1, 1.0, count).astype(np.float32)}
