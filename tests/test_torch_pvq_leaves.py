"""The PVQ leaf stage (mousiki_tpu_torch.ops.pvq_leaves) against the
serial algorithm its CUDA kernels run and against the JAX reference, on
the CPU.

The kernels run libopus's cwrsi and exp_rotation one leaf at a time
(the port's copies: hostcodec/celt/cwrs.cwrsi, hostcodec/celt/vq.
exp_rotation). Here the plain versions, which the wrappers take for CPU
tensors, are held to that serial algorithm and to the JAX package's
cwrs_walk, on the leaves of golden stereo arenas at S = 3 (frames 0, 4
and 11, all three tiers, the serving profile) and on seeded synthetic
leaves. Bars: pulse vectors exactly equal; values within 1e-5 (the X
plane's bar of test_band_exec.py: float32 round-off on unit-norm
vectors, the serial rotation against the doubling scan).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_streams import frame_batch, load_stereo_celt
from leaf_cases import synthetic_leaves
from mousiki_tpu.ops import band_exec_jax
from mousiki_tpu_torch.celt.host_native import NativeCeltHostBatch
from mousiki_tpu_torch.celt.plan import TIERS
from mousiki_tpu_torch.hostcodec.celt.cwrs import cwrsi
from mousiki_tpu_torch.hostcodec.celt.vq import exp_rotation
from mousiki_tpu_torch.ops import band_exec, pvq_leaves
from mousiki_tpu_torch.pipeline import SERVING_PROFILE, set_plan_profile
from torch_threads import one_torch_thread  # noqa: F401

S = 3
FRAME = 960
FRAMES = (0, 4, 11)
TOL = 1e-5
PLANES = ("active", "n", "k", "idx", "gain", "b", "spread")


@pytest.fixture(scope="module")
def golden_leaves():
    """{frame: [per tier {plane: 1-D tensor}]} of the golden stereo
    streams' arenas, decoded by the port's native host stage under the
    serving profile and unpacked by the port."""
    streams = load_stereo_celt()
    set_plan_profile(*SERVING_PROFILE)
    try:
        batch = NativeCeltHostBatch(S)
        out = {}
        for f in range(max(FRAMES) + 1):
            arenas, aux, _ = batch.decode_plan_arenas(
                frame_batch(streams, S, f), FRAME)
            assert (aux["rcs"] >= 0).all()
            if f not in FRAMES:
                continue
            backing = torch.from_numpy(arenas["backing"].copy())
            p, *_ = band_exec.unpack_plan_arenas(
                *band_exec.split_backing(backing, channels=2, frame=FRAME,
                                         n_streams=S),
                channels=2, frame=FRAME)
            p = band_exec._normalize_plan(p)
            out[f] = [{name: p[f"pvq_{name}"][t].reshape(-1)
                       for name in PLANES} for t in range(3)]
    finally:
        set_plan_profile()
    return out


def _synthetic(nmax, seed):
    d = synthetic_leaves(nmax, seed, per_nk=1)
    return {name: torch.as_tensor(d[name]) for name in PLANES}


def _check_walk(leaves, nmax, with_jax):
    iy = pvq_leaves.cwrs_walk_reference(
        leaves["active"], leaves["n"], leaves["k"], leaves["idx"], nmax)
    assert iy.dtype == torch.int32 and iy.shape == (len(leaves["n"]), nmax)
    if with_jax:
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
        # the dispatcher the executor calls takes the plain version here
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


def test_wrappers_take_plain_versions_on_cpu_and_refuse_bad_input():
    nmax = TIERS[1][0]
    leaves = _synthetic(nmax, 5)
    pvq_leaves.reset_launches()
    walk_args = [leaves[x] for x in ("active", "n", "k", "idx")]
    iy = pvq_leaves.cwrs_walk(*walk_args, nmax)
    assert torch.equal(iy, pvq_leaves.cwrs_walk_reference(*walk_args, nmax))
    value_args = [leaves[x] for x in ("active", "n", "k", "gain", "b",
                                      "spread")]
    vals = pvq_leaves.pvq_leaf_values(iy, *value_args, nmax)
    assert torch.equal(vals, pvq_leaves.pvq_leaf_values_reference(
        iy, *value_args, nmax))
    assert pvq_leaves.cwrs_walk_launches == 0
    assert pvq_leaves.pvq_leaf_values_launches == 0

    with pytest.raises(TypeError, match="n must be torch.int64"):
        pvq_leaves.cwrs_walk(walk_args[0], walk_args[1].int(),
                             *walk_args[2:], nmax)
    with pytest.raises(TypeError, match="iy must be torch.int32"):
        pvq_leaves.pvq_leaf_values(iy.long(), *value_args, nmax)
    with pytest.raises(ValueError, match="bad shape of iy"):
        pvq_leaves.pvq_leaf_values(iy[:, :16].contiguous(), *value_args,
                                   nmax)
    with pytest.raises(ValueError, match="leaves"):
        pvq_leaves.cwrs_walk(walk_args[0][:-1], *walk_args[1:], nmax)
    with pytest.raises(ValueError, match="contiguous"):
        pvq_leaves.pvq_leaf_values(
            torch.zeros((len(iy), 2 * nmax), dtype=torch.int32)[:, ::2],
            *value_args, nmax)
    with pytest.raises(ValueError, match="nmax"):
        pvq_leaves.cwrs_walk(*walk_args, 300)
    meta = [t.to("meta") for t in walk_args]
    with pytest.raises(ValueError, match="cpu or cuda, not meta"):
        pvq_leaves.cwrs_walk(*meta, nmax)
    with pytest.raises(ValueError, match="cpu or cuda, not meta"):
        pvq_leaves.pvq_leaf_values(
            iy.to("meta"), *(t.to("meta") for t in value_args), nmax)


@pytest.mark.cuda
def test_leaf_kernels_match_plain_versions_on_gpu():
    """The kernels on the card against the plain versions (iy equal,
    values within 1e-5), every tier on synthetic leaves."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    for tier, (nmax, _) in enumerate(TIERS):
        leaves = {k: v.cuda() for k, v in _synthetic(nmax, tier).items()}
        walk_args = [leaves[x] for x in ("active", "n", "k", "idx")]
        value_args = [leaves[x] for x in ("active", "n", "k", "gain", "b",
                                          "spread")]
        before = pvq_leaves.cwrs_walk_launches
        iy = pvq_leaves.cwrs_walk(*walk_args, nmax)
        vals = pvq_leaves.pvq_leaf_values(iy, *value_args, nmax)
        torch.cuda.synchronize()
        assert pvq_leaves.cwrs_walk_launches == before + 1
        assert torch.equal(iy, pvq_leaves.cwrs_walk_reference(*walk_args,
                                                               nmax))
        want = pvq_leaves.pvq_leaf_values_reference(iy, *value_args, nmax)
        assert (vals - want).abs().max().item() <= TOL
