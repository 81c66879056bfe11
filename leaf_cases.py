"""Seeded synthetic leaves for the PVQ leaf stage (the port's
ops/pvq_leaves.py): leaves that cover the kernels' domain for a tier,
beyond what the golden streams reach, and a plan's leaf planes built from
them. Shared by the port's tests and chip_smoke.py; it is not part of any
installed package.
"""

from __future__ import annotations

import numpy as np

from mousiki_tpu_torch.celt.plan import TIERS
from mousiki_tpu_torch.ops._tables import U_K, u_table

PLAN_PLANES = ("active", "n", "k", "idx", "gain", "b", "spread", "dst")


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


def outside_leaves(nmax: int, seed: int, per_n: int = 4) -> dict:
    """Leaves no valid codeword has, from a numpy seed: for every n in
    1..nmax whose kmax(n) (the largest k with V(n, k) < 2^32) is below
    U_K - 2, `per_n` leaves with k in (kmax(n), U_K - 2] (its ends among
    them) and idx in [0, 2^32) (0 and 2^32 - 1 among them). Their descent
    reads past the packed part of the U table and into its saturated
    entries. Planes as synthetic_leaves', every leaf active."""
    rng = np.random.default_rng(seed)
    U = u_table().astype(np.int64)
    V = U[:, :-1] + U[:, 1:]
    rows = []
    for n in range(1, nmax + 1):
        fits = V[n] < 1 << 32
        kmax = U_K - 2 if fits.all() else int(fits.argmin()) - 1
        if kmax >= U_K - 2:
            continue
        ks = [kmax + 1, U_K - 2] + rng.integers(kmax + 1, U_K - 1,
                                                 per_n - 2).tolist()
        idx = [0, (1 << 32) - 1] + rng.integers(0, 1 << 32,
                                                 per_n - 2).tolist()
        rows.extend((n, k, i) for k, i in zip(ks, idx))
    a = np.array(rows, np.int64).reshape(-1, 3)
    count = len(a)
    return {"active": np.ones(count, bool), "n": a[:, 0], "k": a[:, 1],
            "idx": a[:, 2], "b": np.ones(count, np.int64),
            "spread": (np.arange(count) % 4).astype(np.int64),
            "gain": rng.uniform(0.1, 1.0, count).astype(np.float32)}


def synthetic_plan(seed: int, leaves: int | None = None,
                   source=None) -> dict:
    """The leaf planes of a stereo 20 ms plan (X rows of 2 x 960 values)
    of S streams holding the synthetic leaves of all three tiers (seeds
    seed, seed + 1, seed + 2, one random idx an (n, k)), shuffled (with
    `leaves`, a seeded subset of that many a tier), a tier's (S, slots)
    each, S chosen so that a stream's leaves span about 90% of its row.
    A stream's spans (pvq_dst) follow one another, its tier 0 slots
    first, from a seeded start in [-8, 240): the first stream's start is
    -8, so that points before 0 are dropped, and heavy streams run past
    the row's end. Slots left over hold inactive leaves. Returns numpy
    planes {"pvq_<name>": [per tier (S, slots)], "direct": (S,) bool}, as
    the executor's (band_exec._normalize_plan) dtypes. `source(nmax,
    seed)` gives a tier's leaves in place of synthetic_leaves(nmax, seed,
    per_nk=1) (outside_leaves, say)."""
    rng = np.random.default_rng(seed)
    tiers = []
    for t, (nmax, _) in enumerate(TIERS):
        d = (source(nmax, seed + t) if source is not None
             else synthetic_leaves(nmax, seed + t, per_nk=1))
        keep = rng.permutation(len(d["n"]))[:leaves]
        tiers.append({name: v[keep] for name, v in d.items()})
    cols = 2 * 960
    S = -(-sum(int(d["n"].sum()) for d in tiers) // int(0.9 * cols))
    pad = {"active": False, "n": 1, "k": 0, "idx": 0, "gain": 0.0, "b": 1,
           "spread": 0}
    out = {f"pvq_{name}": [] for name in PLAN_PLANES}
    for d in tiers:
        count = len(d["n"])
        slots = -(-count // S)
        perm = rng.permutation(count)
        for name, fillv in pad.items():
            v = np.full(S * slots, fillv, d[name].dtype)
            v[:count] = d[name][perm]
            out[f"pvq_{name}"].append(v.reshape(S, slots))
    start = rng.integers(-8, cols // 8, S)
    start[0] = -8
    ends = start.astype(np.int64)
    for t in range(len(TIERS)):
        n = out["pvq_n"][t]
        first = ends[:, None] + np.cumsum(n, axis=1) - n
        out["pvq_dst"].append(first.astype(np.int64))
        ends = first[:, -1] + n[:, -1]
    out["direct"] = np.zeros(S, bool)
    return out
