"""The band assembly (mousiki_tpu_torch.ops.band_assembly: P3 of the
band-plan executor) against the JAX reference on the CPU.

The stereo frames are held by tests/test_torch_band_exec.py. Here the
plain version, which the wrapper takes for CPU tensors, runs inside the
port's execute_packed on mono arenas from the mixed path's host stage
(the port's NativeOpusHostBatch, channels = 1) at S = 3: the golden CELT
stream and the two hybrid ones, whose calls start at band 17. Against
band_exec_jax.execute_packed on the same arenas. Bar: the X plane within
1e-5 (the bar of test_band_exec.py: f32 round-off on unit-norm spectra).

The kernel reads the operators as their nonzeros
(band_assembly.packed_operators); rebuilt dense, they are held to the
stacks the plain version reads, at every frame size. It runs a stream's
bands in two passes (band_assembly.band_passes); the premise of that
split is held on golden, mono-arena and LM 0-2 plans: only the bands
with a live fold fill are ordered, and no band of the parallel pass
writes a norm position that an ordered band before it reads. The kernel
itself runs only on a GPU: a `cuda` test holds it to the plain version
there, within KERNEL_TOL (both compute in float64 and differ only in the
order of a product's terms). The JAX package is imported inside the
tests that compare with it, so that the file imports where JAX is not
(the GPU machine runs the `cuda` test: pytest -m cuda).
"""

import contextlib
from functools import lru_cache, partial

import numpy as np
import pytest
import torch

from golden_streams import frame_batch, load_mono_mix, load_stereo_celt
from mousiki_tpu_torch.celt.host_native import NativeCeltHostBatch
from mousiki_tpu_torch.celt.plan import combos_for_m
from mousiki_tpu_torch.opus_host_native import NativeOpusHostBatch
from mousiki_tpu_torch.ops import band_assembly, band_exec
from mousiki_tpu_torch.ops._tables import plan_combo_mats_np
from mousiki_tpu_torch.pipeline import (SERVING_PROFILE, CeltEncodePipeline,
                                        set_plan_profile)
from torch_threads import one_torch_thread  # noqa: F401

FRAME = 960
TOL = 1e-5
KERNEL_TOL = 1e-12
# the mono mix's CELT stream and its two hybrid streams
MONO_STREAMS = (0, 3, 4)
MONO_FRAMES = (0, 3)


@contextlib.contextmanager
def _profile(profile):
    """The profile in both host libraries: the arenas come from the
    port's, the JAX package unpacks them with its own layout."""
    from mousiki_tpu.celt import host_native as jax_host
    set_plan_profile(*profile)
    jax_host.set_plan_profile(*profile)
    try:
        yield
    finally:
        set_plan_profile()
        jax_host.set_plan_profile()


@pytest.fixture(scope="module")
def mono_arenas():
    """{frame: (backing, x_direct)} of the mixed host stage at S = 3,
    channels = 1, under the serving profile."""
    mix = load_mono_mix()
    streams = [mix[s] for s in MONO_STREAMS]
    with _profile(SERVING_PROFILE):
        host = NativeOpusHostBatch(len(streams), channels=1)
        out = {}
        for f in range(max(MONO_FRAMES) + 1):
            arenas, aux, *_ = host.decode(
                frame_batch(streams, len(streams), f, packets=True), FRAME)
            assert (aux["rcs"] >= 0).all()
            if f in MONO_FRAMES:
                out[f] = (arenas["backing"].copy(), aux["x_direct"].copy())
        yield out


def _jax_split(backing, S, channels, frame=FRAME):
    import jax.numpy as jnp
    from mousiki_tpu.celt import host_native as jax_host
    n32, o16, n16, o8, n8, _ = jax_host.arena_word_layout(S, channels, frame)
    a32 = jnp.asarray(backing[:n32])
    a16 = jnp.asarray(backing[o16:o16 + (n16 + 1) // 2].view(np.int16)[:n16])
    a8 = jnp.asarray(backing[o8:o8 + (n8 + 3) // 4].view(np.uint8)[:n8])
    return a32, a16, a8


def _port_plan(backing, S, channels, frame=FRAME):
    p, *_ = band_exec.unpack_plan_arenas(
        *band_exec.split_backing(torch.from_numpy(backing.copy()),
                                 channels=channels, frame=frame,
                                 n_streams=S),
        channels=channels, frame=frame)
    return p


@pytest.mark.parametrize("frame", MONO_FRAMES)
def test_reference_matches_jax_on_mono_arenas(mono_arenas, frame):
    import jax
    import jax.numpy as jnp
    from mousiki_tpu.ops import band_exec_jax
    backing, x_direct = mono_arenas[frame]
    S = len(MONO_STREAMS)
    with _profile(SERVING_PROFILE):
        jp, *_ = jax.jit(partial(band_exec_jax.unpack_plan_arenas,
                                 channels=1, frame=FRAME))(
            *_jax_split(backing, S, 1))
        want = np.asarray(band_exec_jax.execute_packed(
            jp, jnp.asarray(x_direct), channels=1, frame=FRAME, lm=3,
            start=0, end=21, mats=band_exec_jax.plan_combo_mats(1, FRAME)))
        tp = _port_plan(backing, S, 1)
    band_assembly.reset_launches()
    got = band_exec.execute_packed(
        tp, torch.from_numpy(x_direct),
        band_exec.plan_combo_mats(1, FRAME, "cpu"), channels=1,
        frame=FRAME, lm=3, start=0, end=21).numpy()
    assert band_assembly.band_assembly_launches == 0
    assert not tp["direct"].any()
    # every stream runs CELT calls (the hybrid ones from band 17)
    assert (tp["call_active"].reshape(S, -1) != 0).any(dim=1).all()
    assert got.shape == want.shape == (S, FRAME)
    assert np.abs(got - want).max() <= TOL


def _encoded_arenas(frame):
    """(backing, x_direct) of plan arenas at `frame` (full profile) that
    the golden stereo PCM makes when the port's CeltEncodePipeline
    encodes it at S = 3 and the native host stage decodes it: the second
    frame's (copies of one encode a frame size)."""
    return tuple(a.copy() for a in _encode_once(frame))


@lru_cache(maxsize=None)
def _encode_once(frame):
    S = 3
    streams = load_stereo_celt()
    enc = CeltEncodePipeline(S, 2, 96000, frame_size=frame, device="cpu")
    host = NativeCeltHostBatch(S)
    for f in range(2):
        pcm = np.stack([st.pcm[f * frame:(f + 1) * frame]
                        for st in streams]).astype(np.float32)
        arenas, aux, _ = host.decode_plan_arenas(enc.step(pcm), frame)
        assert (aux["rcs"] >= 0).all()
    return arenas["backing"].copy(), aux["x_direct"].copy()


@pytest.mark.parametrize("frame", [120, 240])
def test_reference_matches_jax_on_short_frames(frame):
    """LM 0-1, which the golden streams do not reach: the golden stereo
    PCM encoded by the port's CeltEncodePipeline at 2.5 and 5 ms, decoded
    into plan arenas (full profile), through both executors. The n = 1
    sign path (LM 0) and the N = 2 stereo butterfly (LM 0-1) run only
    here."""
    import jax
    import jax.numpy as jnp
    from mousiki_tpu.ops import band_exec_jax
    lm = {120: 0, 240: 1}[frame]
    S = 3
    backing, x_direct = _encoded_arenas(frame)
    jp, *_ = jax.jit(partial(band_exec_jax.unpack_plan_arenas, channels=2,
                             frame=frame))(*_jax_split(backing, S, 2, frame))
    want = np.asarray(band_exec_jax.execute_packed(
        jp, jnp.asarray(x_direct), channels=2, frame=frame, lm=lm, start=0,
        end=21, mats=band_exec_jax.plan_combo_mats(2, frame)))
    tp = _port_plan(backing, S, 2, frame)
    got = band_exec.execute_packed(
        tp, torch.from_numpy(x_direct),
        band_exec.plan_combo_mats(2, frame, "cpu"), channels=2, frame=frame,
        lm=lm, start=0, end=21).numpy()
    assert got.shape == want.shape == (S, 2 * frame)
    assert np.abs(got - want).max() <= TOL
    assert tp["theta2_active"].any()
    if lm == 0:
        assert tp["n1_active"].any()


@pytest.mark.parametrize("frame", [120, 240, 480, 960])
def test_packed_operators_hold_the_stacks_as_nonzeros(frame):
    """The kernel's operator rows, rebuilt dense, are the stacks' n_b x
    n_b blocks of every band and combo, bit for bit in float32: at most
    NZ nonzeros a row, their columns ascending, then (0, 0.0) pads."""
    lm = {120: 0, 240: 1, 480: 2, 960: 3}[frame]
    offs, rows = band_assembly._row_offsets(lm)
    nc = len(combos_for_m(1 << lm))
    widths = band_assembly._band_widths(lm)
    packed = band_assembly.packed_operators(frame, "cpu")
    nz = band_assembly.NZ
    for stack, ops in zip(plan_combo_mats_np(frame), packed):
        assert stack.shape[1] == nc
        assert ops.cols.dtype == torch.uint8
        assert ops.vals.dtype == torch.float32
        assert ops.cols.shape == ops.vals.shape == (rows, nz)
        cols, vals = ops.cols.numpy().astype(np.int64), ops.vals.numpy()
        on = vals != 0
        # nonzeros first, in ascending column order, then pads
        assert not (~on[:, :-1] & on[:, 1:]).any()
        assert (cols[~on] == 0).all()
        step = np.diff(cols, axis=1)
        assert (step[on[:, 1:]] > 0).all()
        for i, n_b in enumerate(widths):
            if n_b == 1:
                continue
            r = slice(offs[i], offs[i] + nc * n_b)
            assert cols[r].max() < n_b
            dense = np.zeros((nc * n_b, n_b), np.float32)
            for k in range(nz):
                at = on[r][:, k]
                dense[np.flatnonzero(at), cols[r][at, k]] = vals[r][at, k]
            np.testing.assert_array_equal(
                dense.reshape(nc, n_b, n_b), stack[i, :, :n_b, :n_b])
    # the band table the kernel reads: the plain version's derivation
    table = band_assembly._band_table(lm, 0)
    assert list(table.n) == widths
    assert list(table.row_off) == offs
    assert list(table.scale) == [
        float(np.float32(np.sqrt(n))) if n > 1 else 1.0 for n in widths]


def _stereo_plan(S=3, f=4):
    streams = load_stereo_celt()
    set_plan_profile(*SERVING_PROFILE)
    try:
        host = NativeCeltHostBatch(S)
        for k in range(f + 1):
            arenas, aux, _ = host.decode_plan_arenas(
                frame_batch(streams, S, k), FRAME)
        p = band_exec._normalize_plan(_port_plan(arenas["backing"], S, 2))
    finally:
        set_plan_profile()
    p = {k: p[k].contiguous() for k in band_assembly.PLANE_KEYS}
    X = torch.as_tensor(np.random.default_rng(f).standard_normal(
        (S, 2 * FRAME)) * 0.1)
    return p, X


def _split_plan(name, mono_arenas):
    """(planes, channels, lm) of a plan the split is held on."""
    if name == "stereo_frame4":
        return _stereo_plan()[0], 2, 3
    if name.startswith("mono_frame"):
        backing, _ = mono_arenas[int(name[len("mono_frame"):])]
        return (band_exec._normalize_plan(
            _port_plan(backing, len(MONO_STREAMS), 1)), 1, 3)
    frame = {"lm0": 120, "lm1": 240, "lm2": 480}[name]
    backing, _ = _encoded_arenas(frame)
    return (band_exec._normalize_plan(_port_plan(backing, 3, 2, frame)), 2,
            int(name[2:]))


def _live_fold(p, channels, lm):
    """(S, 21, C): the calls with a live fold fill (a fill slot active and
    folding on an active call of a band wider than one bin)."""
    wide = np.array(band_assembly._band_widths(lm)) > 1
    q = {k: p[k].numpy() for k in ("fill_active", "fill_fold",
                                   "call_active")}
    return ((q["fill_active"] & q["fill_fold"]).any(axis=3)
            & q["call_active"])[:, :, :channels] & wide[None, :, None]


def _norm_reads(p, s, i, slot, lm):
    """The norm positions a fold call's source reads (in both buffers),
    gathered position by position as the plain version gathers them."""
    n_b = band_assembly._band_widths(lm)[i]
    npad = band_assembly.norm_geometry(lm, 0)[2]
    src = int(p["call_lb_src"][s, i, slot])
    dup = p["call_dup"][s, i, slot].numpy()
    pos = np.arange(n_b)
    d_rel = pos - dup[0]
    in_dup = (d_rel >= 0) & (d_rel < dup[2])
    at = np.where(in_dup, src + np.clip(dup[1] + d_rel, 0, n_b - 1),
                  src + pos)
    return set(np.clip(at, 0, npad - 1).tolist())


def _norm_writes(p, s, i, channels, lm):
    """The norm positions band i of stream s writes (either buffer)."""
    t = band_assembly._band_table(lm, 0)
    on = (p["call_norm_write"][s, i, :channels]
          & p["call_active"][s, i, :channels]).any()
    if t.nwoff[i] < 0 or not on:
        return set()
    return set(range(t.nwoff[i], t.nwoff[i] + t.n[i]))


@pytest.mark.parametrize("name", ["stereo_frame4", "mono_frame0",
                                  "mono_frame3", "lm0", "lm1", "lm2"])
def test_band_passes_order_exactly_the_live_fold_bands(name, mono_arenas):
    """The kernel's split (band_assembly.band_passes) on CELT plans: the
    ordered pass holds exactly the bands with a live fold fill, and no
    band of the parallel pass writes a norm position that an ordered band
    before it reads."""
    p, C, lm = _split_plan(name, mono_arenas)
    passes = band_assembly.band_passes(p, channels=C, lm=lm, start=0,
                                       end=21)
    live = _live_fold(p, C, lm)
    S = passes.shape[0]
    assert passes.shape == (S, 21) and (passes >= 1).all()
    np.testing.assert_array_equal(passes == 2, live.any(axis=2))
    for s in range(S):
        for j in np.flatnonzero(passes[s] == 2):
            reads = set().union(*(_norm_reads(p, s, j, slot, lm)
                                  for slot in range(C) if live[s, j, slot]))
            for k in range(j + 1, 21):
                if passes[s, k] == 1:
                    assert not reads & _norm_writes(p, s, k, C, lm), (s, j, k)


def test_band_passes_force_a_band_that_writes_a_fold_source():
    """A fold call whose source window is moved onto a later band's norm
    region sends that band to the ordered pass too."""
    p, _ = _stereo_plan()
    lm = 3
    passes = band_assembly.band_passes(p, channels=2, lm=lm, start=0,
                                       end=21)
    live = _live_fold(p, 2, lm)
    t = band_assembly._band_table(lm, 0)
    s, j, slot = (int(v) for v in np.argwhere(live)[0])
    k = next(k for k in range(j + 1, 21)
             if passes[s, k] == 1 and _norm_writes(p, s, k, 2, lm))
    moved = {key: v.clone() for key, v in p.items()}
    moved["call_lb_src"][s, j, slot] = t.nwoff[k]
    assert _norm_reads(moved, s, j, slot, lm) & _norm_writes(moved, s, k, 2,
                                                             lm)
    after = band_assembly.band_passes(moved, channels=2, lm=lm, start=0,
                                      end=21)
    assert after[s, k] == 2 and after[s, j] == 2
    # nothing else moves
    after[s, k] = 1
    np.testing.assert_array_equal(after, passes)


def test_wrapper_takes_plain_version_on_cpu_and_refuses_bad_input():
    p, X = _stereo_plan()
    mats = band_exec.plan_combo_mats(2, FRAME, "cpu")
    kw = dict(channels=2, frame=FRAME, lm=3, start=0, end=21)
    band_assembly.reset_launches()
    got = band_assembly.band_assembly(p, X.clone(), mats, **kw)
    want = band_assembly.band_assembly_reference(p, X.clone(), mats, **kw)
    assert torch.equal(got, want)
    assert band_assembly.band_assembly_launches == 0

    with pytest.raises(TypeError, match="X must be torch.float64"):
        band_assembly.band_assembly(p, X.float(), mats, **kw)
    with pytest.raises(ValueError, match="bad shape of X"):
        band_assembly.band_assembly(p, X[:, :FRAME].contiguous(), mats, **kw)
    with pytest.raises(TypeError, match="call_lb_src must be torch.int64"):
        band_assembly.band_assembly(
            {**p, "call_lb_src": p["call_lb_src"].int()}, X, mats, **kw)
    with pytest.raises(ValueError, match="bad shape of merge_mid"):
        band_assembly.band_assembly(
            {**p, "merge_mid": p["merge_mid"][:2].contiguous()}, X, mats,
            **kw)
    # the plain version takes any layout and fill-slot count; what only
    # the kernel needs is checked on the CUDA route (_check_kernel)
    strided = {**p, "fill_off": p["fill_off"].transpose(0, 1).contiguous()
               .transpose(0, 1)}
    nine = {k: torch.cat([p[k], p[k][..., :1].expand(*p[k].shape[:3], 7)],
                         dim=3).contiguous()
            for k in band_assembly.PLANE_KEYS if k.startswith("fill_")}
    nine["fill_active"] = torch.cat(
        [p["fill_active"], torch.zeros((*p["fill_active"].shape[:3], 7),
                                       dtype=torch.bool)], dim=3)
    assert torch.equal(
        band_assembly.band_assembly(strided, X.clone(), mats, **kw), want)
    assert torch.equal(
        band_assembly.band_assembly({**p, **nine}, X.clone(), mats, **kw),
        want)
    packed = band_assembly.packed_operators(FRAME, "cpu")
    band_assembly._check_kernel(p, X, packed, FRAME, 3)
    gapped = {k: torch.cat([p[k], p[k][:, :1]], dim=1)[:, :21]
              for k in band_assembly.PLANE_KEYS}
    assert not gapped["call_dup"].is_contiguous()
    band_assembly._check_kernel(gapped, X, packed, FRAME, 3)
    with pytest.raises(ValueError, match="contiguous rows of each plane"):
        band_assembly._check_kernel(strided, X, packed, FRAME, 3)
    with pytest.raises(ValueError, match="fill slots a call, got 9"):
        band_assembly._check_kernel({**p, **nine}, X, packed, FRAME, 3)
    with pytest.raises(ValueError, match="contiguous X"):
        band_assembly._check_kernel(p, X.t().contiguous().t(), packed, FRAME,
                                    3)
    with pytest.raises(ValueError, match="takes the packed operators"):
        band_assembly._check_kernel(p, X, mats, FRAME, 3)
    with pytest.raises(ValueError, match="takes the packed operators"):
        band_assembly._check_kernel(
            p, X, tuple(band_assembly.SparseOperators(m.cols, m.vals.double())
                        for m in packed), FRAME, 3)
    with pytest.raises(ValueError, match="takes the packed operators"):
        band_assembly._check_kernel(
            p, X, tuple(band_assembly.SparseOperators(m.cols, m.vals[1:])
                        for m in packed), FRAME, 3)
    with pytest.raises(ValueError, match="band range"):
        band_assembly.band_assembly(p, X, mats, **{**kw, "end": 22})
    with pytest.raises(ValueError, match="frame 120 << lm"):
        band_assembly.band_assembly(p, X, mats, **{**kw, "lm": 2})
    with pytest.raises(ValueError, match="cpu or cuda, not meta"):
        band_assembly.band_assembly({k: v.to("meta") for k, v in p.items()},
                                    X.to("meta"), mats, **kw)


@pytest.mark.cuda
def test_band_assembly_kernel_matches_plain_version_on_gpu():
    """The kernel on the card against the plain version on the same card
    (golden stereo arenas at S = 3, frame 4), X within KERNEL_TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    p, X = _stereo_plan()
    p = {k: v.cuda() for k, v in p.items()}
    X = X.cuda()
    kw = dict(channels=2, frame=FRAME, lm=3, start=0, end=21)
    stacks = tuple(torch.as_tensor(a, dtype=torch.float64, device="cuda")
                   for a in plan_combo_mats_np(FRAME))
    want = band_assembly.band_assembly_reference(p, X.clone(), stacks, **kw)
    before = band_assembly.band_assembly_launches
    mats = band_exec.plan_combo_mats(2, FRAME, "cuda")
    got = band_assembly.band_assembly(p, X.clone(), mats, **kw)
    # the planes' streams further apart than a row, as the arena's are
    gapped = {k: torch.cat([p[k], p[k][:, :1]], dim=1)[:, :21]
              for k in band_assembly.PLANE_KEYS}
    strided = band_assembly.band_assembly(gapped, X.clone(), mats, **kw)
    torch.cuda.synchronize()
    assert band_assembly.band_assembly_launches == before + 2
    assert (got - want).abs().max().item() <= KERNEL_TOL
    assert torch.equal(strided, got)
