"""The band assembly's plain version against the JAX executor on 2.5 and
5 ms frames, and the packed operators against the float64 stacks at
every frame size (split from tests/test_torch_band_assembly.py so that
the tier-1 suite's files stay short).
"""

from functools import partial

import numpy as np
import pytest
import torch

from mousiki_tpu_torch.celt.plan import combos_for_m
from mousiki_tpu_torch.ops import band_assembly, band_exec
from mousiki_tpu_torch.ops._tables import plan_combo_mats_np
from test_torch_band_assembly import (TOL, _encoded_arenas, _jax_split,
                                      _port_plan)
from torch_threads import one_torch_thread  # noqa: F401


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
