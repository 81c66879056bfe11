"""The PVQ leaf stage (mousiki_tpu_torch.ops.pvq_leaves) against the
serial algorithm its CUDA kernels run and against the JAX reference, on
the CPU.

The kernels run libopus's cwrsi and exp_rotation one leaf at a time
(the port's copies: hostcodec/celt/cwrs.cwrsi, hostcodec/celt/vq.
exp_rotation) and write each leaf's values straight into the X plane at
its pvq_dst span. Here the plain versions, which the wrappers take for
CPU tensors, are held to that serial algorithm and to the JAX package's
cwrs_walk, on the leaves of golden stereo arenas at S = 3 (frames 0, 4
and 11, all three tiers, the serving profile) and on seeded synthetic
leaves; the packed U table the kernels stage is held to the full table
on the region a valid leaf's descent reads; and the plain stage's gather
is held to a scatter of each leaf's values, the kernel's formulation.
Bars: pulse vectors exactly equal; values within 1e-5 (the X plane's bar
of test_band_exec.py: float32 round-off on unit-norm vectors, the serial
rotation against the doubling scan); the scatter bit for bit.
"""

import numpy as np
import pytest
import torch

from golden_streams import frame_batch, load_mono_mix, load_stereo_celt
from leaf_cases import outside_leaves, synthetic_leaves, synthetic_plan
from mousiki_tpu_torch.celt.host_native import NativeCeltHostBatch
from mousiki_tpu_torch.celt.plan import TIERS
from mousiki_tpu_torch.hostcodec.celt.cwrs import cwrsi
from mousiki_tpu_torch.hostcodec.celt.vq import exp_rotation
from mousiki_tpu_torch.opus_host_native import NativeOpusHostBatch
from mousiki_tpu_torch.ops import band_exec, pvq_leaves
from mousiki_tpu_torch.ops._tables import U_K, u_table
from mousiki_tpu_torch.pipeline import SERVING_PROFILE, set_plan_profile
from torch_threads import one_torch_thread  # noqa: F401

S = 3
FRAME = 960
FRAMES = (0, 4, 11)
TOL = 1e-5
PLANES = ("active", "n", "k", "idx", "gain", "b", "spread")
# the mono mix's CELT stream and its two hybrid streams
MONO_STREAMS = (0, 3, 4)
MONO_FRAME = 3
# synthetic leaves a tier in the scatter check (a seeded subset)
SCATTER_LEAVES = 800


def _plan(backing, n_streams, channels):
    p, *_ = band_exec.unpack_plan_arenas(
        *band_exec.split_backing(torch.from_numpy(backing.copy()),
                                 channels=channels, frame=FRAME,
                                 n_streams=n_streams),
        channels=channels, frame=FRAME)
    return band_exec._normalize_plan(p)


@pytest.fixture(scope="module")
def golden_plans():
    """{frame: the executor's planes} of the golden stereo streams'
    arenas, decoded by the port's native host stage under the serving
    profile and unpacked by the port."""
    streams = load_stereo_celt()
    set_plan_profile(*SERVING_PROFILE)
    try:
        batch = NativeCeltHostBatch(S)
        out = {}
        for f in range(max(FRAMES) + 1):
            arenas, aux, _ = batch.decode_plan_arenas(
                frame_batch(streams, S, f), FRAME)
            assert (aux["rcs"] >= 0).all()
            if f in FRAMES:
                out[f] = _plan(arenas["backing"], S, 2)
    finally:
        set_plan_profile()
    return out


@pytest.fixture(scope="module")
def golden_leaves(golden_plans):
    """{frame: [per tier {plane: 1-D tensor}]} of golden_plans."""
    return {f: [{name: p[f"pvq_{name}"][t].reshape(-1) for name in PLANES}
                for t in range(3)] for f, p in golden_plans.items()}


def _mono_plan():
    """The executor's planes of the mixed host stage at S = 3, channels =
    1, under the serving profile, frame MONO_FRAME."""
    mix = load_mono_mix()
    streams = [mix[s] for s in MONO_STREAMS]
    set_plan_profile(*SERVING_PROFILE)
    try:
        host = NativeOpusHostBatch(len(streams), channels=1)
        for f in range(MONO_FRAME + 1):
            arenas, aux, *_ = host.decode(
                frame_batch(streams, len(streams), f, packets=True), FRAME)
            assert (aux["rcs"] >= 0).all()
        # the arena layout follows the profile
        return _plan(arenas["backing"], len(streams), 1)
    finally:
        set_plan_profile()


def _synthetic_plan(leaves=None, source=None):
    return {k: ([torch.as_tensor(t) for t in v] if isinstance(v, list)
                else torch.as_tensor(v))
            for k, v in synthetic_plan(3, leaves=leaves,
                                       source=source).items()}


def _synthetic(nmax, seed, source=None):
    d = (source(nmax, seed) if source is not None
         else synthetic_leaves(nmax, seed, per_nk=1))
    return {name: torch.as_tensor(d[name]) for name in PLANES}


def _check_walk(leaves, nmax, with_jax):
    iy = pvq_leaves.cwrs_walk_reference(
        leaves["active"], leaves["n"], leaves["k"], leaves["idx"], nmax)
    assert iy.dtype == torch.int32 and iy.shape == (len(leaves["n"]), nmax)
    if with_jax:
        import jax
        import jax.numpy as jnp
        from mousiki_tpu.ops import band_exec_jax
        jiy = np.asarray(jax.jit(band_exec_jax.cwrs_walk, static_argnums=4)(
            jnp.asarray(leaves["active"].numpy()),
            jnp.asarray(leaves["n"].numpy().astype(np.int32)),
            jnp.asarray(leaves["k"].numpy().astype(np.int32)),
            jnp.asarray(leaves["idx"].numpy().astype(np.uint32)), nmax))
        np.testing.assert_array_equal(iy.numpy(), jiy)
    got = iy.numpy()
    act = leaves["active"].numpy()
    assert not got[~act].any()
    nki = np.stack([leaves[x].numpy() for x in ("n", "k", "idx")], 1)
    for r in np.flatnonzero(act):
        n, k, i = nki[r].tolist()
        want = cwrsi(n, k, i) if n > 1 else [-k if i else k]
        assert got[r, :n].tolist() == want, (n, k, i)
        assert not got[r, n:].any()
    return iy


def _check_values(leaves, iy, nmax):
    got = pvq_leaves.pvq_leaf_values_reference(
        iy, leaves["active"], leaves["n"], leaves["k"], leaves["gain"],
        leaves["b"], leaves["spread"], nmax).numpy()
    assert got.dtype == np.float32 and got.shape == iy.shape
    act = leaves["active"].numpy()
    assert not got[~act].any()
    nkbs = np.stack([leaves[x].numpy() for x in ("n", "k", "b", "spread")],
                    1)
    gain = leaves["gain"].numpy()
    pulses = iy.numpy().astype(np.float32)
    worst = 0.0
    for r in np.flatnonzero(act):
        n, k, b, spread = nkbs[r].tolist()
        y = pulses[r, :n]
        ryy = np.float32((y * y).sum())
        x = y * (gain[r] / np.sqrt(ryy))
        exp_rotation(x, n, -1, b, k, spread)
        worst = max(worst, float(np.abs(got[r, :n] - x).max()))
        assert not got[r, n:].any()
    assert worst <= TOL
    return worst


@pytest.mark.parametrize("frame", FRAMES)
def test_walk_reference_matches_cwrsi_and_jax(golden_leaves, frame):
    for t, (nmax, _) in enumerate(TIERS):
        leaves = golden_leaves[frame][t]
        _check_walk(leaves, nmax, with_jax=True)
        # the dispatcher the lockstep emission calls takes the plain
        # version here
        before = pvq_leaves.cwrs_walk_launches
        torch.testing.assert_close(
            band_exec.cwrs_walk(leaves["active"], leaves["n"], leaves["k"],
                                leaves["idx"], nmax),
            pvq_leaves.cwrs_walk_reference(
                leaves["active"], leaves["n"], leaves["k"], leaves["idx"],
                nmax), rtol=0, atol=0)
        assert pvq_leaves.cwrs_walk_launches == before
    assert sum(int(golden_leaves[frame][t]["active"].sum())
               for t in range(3)) > 100


@pytest.mark.parametrize("frame", FRAMES)
def test_leaf_values_reference_matches_exp_rotation(golden_leaves, frame):
    rotated = 0
    for t, (nmax, _) in enumerate(TIERS):
        leaves = golden_leaves[frame][t]
        iy = pvq_leaves.cwrs_walk_reference(
            leaves["active"], leaves["n"], leaves["k"], leaves["idx"], nmax)
        _check_values(leaves, iy, nmax)
        rotated += int((leaves["active"] & (2 * leaves["k"] < leaves["n"])
                        & (leaves["spread"] != 0)).sum())
    assert rotated > 0


@pytest.mark.parametrize("tier", range(3))
def test_walk_reference_on_synthetic_leaves(tier):
    nmax = TIERS[tier][0]
    leaves = _synthetic(nmax, tier)
    assert (~leaves["active"]).any()
    _check_walk(leaves, nmax, with_jax=False)


@pytest.mark.parametrize("tier", range(3))
def test_leaf_values_reference_on_synthetic_leaves(tier):
    nmax = TIERS[tier][0]
    leaves = _synthetic(nmax, tier)
    # every spread and every b that divides n, on leaves that rotate
    rot = leaves["active"] & (2 * leaves["k"] < leaves["n"])
    assert set(leaves["spread"][rot].tolist()) == {0, 1, 2, 3}
    assert set(leaves["b"][rot].tolist()) == {1, 2, 4, 8}
    iy = pvq_leaves.cwrs_walk_reference(
        leaves["active"], leaves["n"], leaves["k"], leaves["idx"], nmax)
    _check_values(leaves, iy, nmax)


def _descent_reads(n, k, idx):
    """The (row, column) entries of the U table the kernels' descent
    (csrc/pvq_leaves.cu descend) reads for one leaf, prefetches
    included, and its pulse vector."""
    U = u_table()
    reads = []

    def get(m, kk):
        reads.append((m, kk))
        return int(U[m, kk])

    y = [0] * n
    if n > 1:
        m = n
        above, p = get(m, k + 1), get(m, k)
        for j in range(n - 1):
            if k == 0:
                break
            k0 = k
            next_above, next_p = get(m - 1, k + 1), get(m - 1, k)
            neg = idx >= above
            if neg:
                idx -= above
            while p > idx:
                k -= 1
                p = get(m, k)
            idx -= p
            y[j] = k - k0 if neg else k0 - k
            if k != k0:
                next_above, next_p = get(m - 1, k + 1), get(m - 1, k)
            above, p, m = next_above, next_p, m - 1
    y[n - 1] = -k if idx else k
    return reads, y


@pytest.mark.parametrize("tier", range(3))
def test_packed_u_region(golden_leaves, tier):
    """The packed table the kernels stage equals the U table on its
    region; kmax(n) does not grow with n; and the descent of every active
    synthetic leaf of the tier and every active golden leaf of frames 0,
    4 and 11 reads inside that region."""
    nmax = TIERS[tier][0]
    kmax, off, entries = pvq_leaves.packed_u_table()
    U = u_table()
    assert (np.diff(kmax[1:]) <= 0).all()
    cols = np.diff(off)
    assert cols[0] == 0 and (cols[1:] == np.minimum(kmax[1:] + 2, U_K)).all()
    for r in range(1, nmax + 1):
        np.testing.assert_array_equal(entries[off[r]:off[r + 1]],
                                      U[r, :cols[r]])
    # V(n, k) < 2^32 exactly up to kmax(n)
    V = U[1:, :-1].astype(np.int64) + U[1:, 1:]
    assert ((V < 1 << 32) == (np.arange(U_K - 1)[None, :]
                              <= kmax[1:, None])).all()
    # the staged words: the header, then rows 1..nmax, in 16-byte units
    staged = pvq_leaves._packed_u_t(torch.device("cpu")).numpy()
    words = pvq_leaves.packed_words(nmax)
    assert words % 4 == 0 and words >= pvq_leaves.HEADER_WORDS + off[nmax + 1]
    np.testing.assert_array_equal(staged[:len(off)], off)
    np.testing.assert_array_equal(
        staged[pvq_leaves.HEADER_WORDS:].view(np.uint32)[:off[nmax + 1]],
        entries[:off[nmax + 1]])

    leaves = [_synthetic(nmax, tier)] + [golden_leaves[f][tier]
                                         for f in FRAMES]
    count = 0
    for d in leaves:
        act = d["active"].numpy()
        for n, k, idx in zip(*(d[x].numpy()[act].tolist()
                               for x in ("n", "k", "idx"))):
            assert k <= kmax[n]
            reads, y = _descent_reads(n, k, idx)
            assert y == (cwrsi(n, k, idx) if n > 1 else [-k if idx else k])
            rows, ks = np.array(reads, np.int64).reshape(-1, 2).T
            assert (rows >= 1).all() and (rows <= n).all()
            assert (ks < cols[rows]).all(), (n, k, idx)
            count += 1
    assert count > 1000


@pytest.mark.parametrize("tier", range(3))
def test_walk_reference_outside_the_packed_region(tier):
    """Leaves with k past kmax(n) (no valid codeword has them): the plain
    walk equals libopus's serial descent over the full, saturated U
    table, and that descent reads outside the packed region, so that
    the kernels take their full-table descent on them."""
    nmax = TIERS[tier][0]
    kmax, off, _ = pvq_leaves.packed_u_table()
    cols = np.diff(off)
    leaves = _synthetic(nmax, 100 + tier, source=outside_leaves)
    iy = pvq_leaves.cwrs_walk_reference(
        leaves["active"], leaves["n"], leaves["k"], leaves["idx"],
        nmax).numpy()
    nki = np.stack([leaves[x].numpy() for x in ("n", "k", "idx")], 1)
    assert len(nki) >= 40
    for r, (n, k, idx) in enumerate(nki.tolist()):
        assert kmax[n] < k <= U_K - 2 and k + 2 > cols[n]
        reads, y = _descent_reads(n, k, idx)
        assert iy[r, :n].tolist() == y, (n, k, idx)
        assert not iy[r, n:].any()
        rows, ks = np.array(reads, np.int64).reshape(-1, 2).T
        assert (ks >= cols[rows]).any()


def _scatter(p, channels, iys):
    """X as a scatter of each active slot's plain values (from its pulse
    vectors iys, a tier's each) at dst .. dst + n - 1, the points outside
    [0, channels * FRAME) dropped, 0 elsewhere; and the mask of the
    points written."""
    S = p["direct"].shape[0]
    cols = channels * FRAME
    X = np.zeros((S, cols))
    written = np.zeros((S, cols), bool)
    for t, (nmax, slots) in enumerate(pvq_leaves._stage_tiers(p)):
        leaves = [p[f"pvq_{x}"][t].reshape(-1).contiguous() for x in PLANES]
        iy = iys[t]
        vals = pvq_leaves.pvq_leaf_values_reference(
            iy, *leaves[:3], *leaves[4:], nmax).numpy()
        act, n, dst = (p[f"pvq_{x}"][t].numpy() for x in ("active", "n",
                                                          "dst"))
        for s, slot in zip(*np.nonzero(act)):
            pos = dst[s, slot] + np.arange(n[s, slot])
            keep = (pos >= 0) & (pos < cols)
            X[s, pos[keep]] = vals[s * slots + slot, :n[s, slot]][keep]
            written[s, pos[keep]] = True
    return X, written


@pytest.mark.parametrize("case", ["frame0", "frame4", "frame11", "mono",
                                  "synthetic", "outside"])
def test_leaf_stage_reference_is_a_scatter(golden_plans, case):
    """leaf_stage_reference's gather map equals a scatter of the leaves'
    values at their spans bit for bit (the kernel's formulation), and
    the wrapper takes it for CPU planes."""
    if case.startswith("frame"):
        p, channels = golden_plans[int(case[len("frame"):])], 2
    elif case == "mono":
        p, channels = _mono_plan(), 1
    elif case == "outside":
        p, channels = _synthetic_plan(source=outside_leaves), 2
    else:
        p, channels = _synthetic_plan(SCATTER_LEAVES), 2
    X, iys = pvq_leaves.leaf_stage_reference(p, channels=channels,
                                             frame=FRAME, pulses=True)
    want, written = _scatter(p, channels, iys)
    assert X.dtype == torch.float64
    np.testing.assert_array_equal(X.numpy(), want)
    assert not X.numpy()[~written].any()
    assert written.sum() > 100
    for t, (nmax, _) in enumerate(TIERS):
        leaves = [p[f"pvq_{x}"][t].reshape(-1) for x in PLANES[:4]]
        assert torch.equal(iys[t],
                           pvq_leaves.cwrs_walk_reference(*leaves, nmax))
    if case == "synthetic":
        # spans cut at both edges of the plane
        dst, n = p["pvq_dst"][0].numpy(), p["pvq_n"][0].numpy()
        assert (dst < 0).any()
        ends = p["pvq_dst"][2].numpy() + p["pvq_n"][2].numpy()
        assert (ends > channels * FRAME).any() and (n >= 1).all()


def test_wrappers_take_plain_versions_on_cpu_and_refuse_bad_input(
        golden_plans):
    p = golden_plans[4]
    nmax = TIERS[1][0]
    leaves = _synthetic(nmax, 5)
    pvq_leaves.reset_launches()
    walk_args = [leaves[x] for x in ("active", "n", "k", "idx")]
    iy = pvq_leaves.cwrs_walk(*walk_args, nmax)
    assert torch.equal(iy, pvq_leaves.cwrs_walk_reference(*walk_args, nmax))
    X = pvq_leaves.leaf_stage(p, channels=2, frame=FRAME)
    assert torch.equal(X, pvq_leaves.leaf_stage_reference(p, channels=2,
                                                          frame=FRAME))
    assert pvq_leaves.cwrs_walk_launches == 0
    assert pvq_leaves.leaf_stage_launches == 0

    with pytest.raises(TypeError, match="n must be torch.int64"):
        pvq_leaves.cwrs_walk(walk_args[0], walk_args[1].int(),
                             *walk_args[2:], nmax)
    with pytest.raises(ValueError, match="leaves"):
        pvq_leaves.cwrs_walk(walk_args[0][:-1], *walk_args[1:], nmax)
    with pytest.raises(ValueError, match="contiguous"):
        pvq_leaves.cwrs_walk(
            walk_args[0], torch.zeros(2 * len(iy), dtype=torch.int64)[::2],
            *walk_args[2:], nmax)
    with pytest.raises(ValueError, match="nmax"):
        pvq_leaves.cwrs_walk(*walk_args, 300)
    meta = [t.to("meta") for t in walk_args]
    with pytest.raises(ValueError, match="cpu or cuda, not meta"):
        pvq_leaves.cwrs_walk(*meta, nmax)

    def changed(key, t, v):
        q = dict(p)
        q[key] = [v if i == t else x for i, x in enumerate(p[key])]
        return q

    with pytest.raises(TypeError, match="pvq_gain must be torch.float32"):
        pvq_leaves.leaf_stage(
            changed("pvq_gain", 1, p["pvq_gain"][1].double()), channels=2,
            frame=FRAME)
    with pytest.raises(TypeError, match="pvq_dst must be torch.int64"):
        pvq_leaves.leaf_stage(changed("pvq_dst", 0, p["pvq_dst"][0].int()),
                              channels=2, frame=FRAME)
    with pytest.raises(ValueError, match="bad shape of pvq_n tier 2"):
        pvq_leaves.leaf_stage(changed("pvq_n", 2, p["pvq_n"][2][:, :-1]),
                              channels=2, frame=FRAME)
    with pytest.raises(ValueError, match="holds 2 tiers"):
        pvq_leaves.leaf_stage(dict(p, pvq_idx=p["pvq_idx"][:2]), channels=2,
                              frame=FRAME)
    with pytest.raises(ValueError, match="channels 1 or 2"):
        pvq_leaves.leaf_stage(p, channels=3, frame=FRAME)
    with pytest.raises(ValueError, match="cpu or cuda, not meta"):
        pvq_leaves.leaf_stage(
            {k: ([t.to("meta") for t in v] if isinstance(v, list)
                 else v.to("meta")) for k, v in p.items()},
            channels=2, frame=FRAME)
    with pytest.raises(ValueError, match="pvq_k is on meta"):
        pvq_leaves.leaf_stage(changed("pvq_k", 0, p["pvq_k"][0].to("meta")),
                              channels=2, frame=FRAME)


@pytest.mark.cuda
def test_leaf_kernels_match_plain_versions_on_gpu():
    """The kernels on the card against the plain versions: the stage on
    the synthetic plan and on a plan of leaves outside the packed region
    (iy equal, X within 1e-5 and 0.0 where no leaf writes), and the walk
    on every tier's synthetic and outside leaves (iy equal)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    for p in (_synthetic_plan(), _synthetic_plan(source=outside_leaves)):
        _, want_iy = pvq_leaves.leaf_stage_reference(
            p, channels=2, frame=FRAME, pulses=True)
        want, written = _scatter(p, 2, want_iy)
        gp = {k: ([t.cuda() for t in v] if isinstance(v, list) else v.cuda())
              for k, v in p.items()}
        before = pvq_leaves.leaf_stage_launches
        X, iys = pvq_leaves.leaf_stage(gp, channels=2, frame=FRAME,
                                       pulses=True)
        torch.cuda.synchronize()
        assert pvq_leaves.leaf_stage_launches == before + 1
        for t in range(3):
            assert torch.equal(iys[t].cpu(), want_iy[t])
        got = X.cpu().numpy()
        assert np.abs(got - want).max() <= TOL
        assert not got[~written].any()
    for tier, (nmax, _) in enumerate(TIERS):
        for source in (None, outside_leaves):
            leaves = {k: v.cuda()
                      for k, v in _synthetic(nmax, tier, source).items()}
            walk_args = [leaves[x] for x in ("active", "n", "k", "idx")]
            before = pvq_leaves.cwrs_walk_launches
            iy = pvq_leaves.cwrs_walk(*walk_args, nmax)
            torch.cuda.synchronize()
            assert pvq_leaves.cwrs_walk_launches == before + 1
            assert torch.equal(iy.cpu(), pvq_leaves.cwrs_walk_reference(
                *(t.cpu() for t in walk_args), nmax))
    with pytest.raises(ValueError, match="multiple of 4"):
        pvq_leaves.cwrs_walk(*walk_args, 18)
