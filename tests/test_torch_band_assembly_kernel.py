"""The band assembly's wrapper: a band forced into the kernel's ordered
pass, the plain version on the CPU and the refused inputs, and (on the
card, `cuda`) the kernel against its plain version (split from
tests/test_torch_band_assembly.py so that the tier-1 suite's files stay
short).
"""

import numpy as np
import pytest
import torch

from mousiki_tpu_torch.ops import band_assembly, band_exec
from mousiki_tpu_torch.ops._tables import plan_combo_mats_np
from test_torch_band_assembly import (FRAME, KERNEL_TOL, _live_fold,
                                      _norm_reads, _norm_writes,
                                      _stereo_plan)
from torch_threads import one_torch_thread  # noqa: F401


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
