"""mousiki_tpu_torch constants and package hygiene: the numpy tables
copied out of the JAX modules equal their originals, the port's device
constants equal the JAX ones, the package never imports jax, and the
de-emphasis wrapper takes its plain path on CPU tensors."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch


from mousiki_tpu.celt.modes import opus_custom_mode
from mousiki_tpu.ops import band_exec_jax, encode_front_jax, plc_jax
from mousiki_tpu.ops import synthesis_jax
from mousiki_tpu_torch.ops import _tables, band_exec, deemphasis, plc
from mousiki_tpu_torch.ops import synthesis

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_copied_tables_equal_originals():
    np.testing.assert_array_equal(_tables.u_table(), band_exec_jax._u_table())
    for got, want in zip(_tables.lcg_jump(), band_exec_jax._lcg_jump()):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_tables.SPREAD_FACTOR,
                                  band_exec_jax._SPREAD_FACTOR)
    for frame in (120, 960):
        for got, want in zip(_tables.plan_combo_mats_np(frame),
                             band_exec_jax._plan_combo_mats_np(frame)):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_tables.COMB_GAINS,
                                  synthesis_jax._COMB_GAINS)
    mode = opus_custom_mode()
    for M in (1, 2, 4, 8):
        np.testing.assert_array_equal(_tables.bin_band_map(mode, M),
                                      synthesis_jax._bin_band_map(mode, M))
    w = np.asarray(mode.window, np.float32)
    for n2 in (120, 240, 480, 960):
        for got, want in zip(_tables.fold_operator(n2, w),
                             encode_front_jax._fold_operator(n2, w)):
            np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("n", [120, 960])
def test_device_constants_equal_jax(n):
    got = synthesis.make_consts(n, "cpu")
    want = synthesis_jax.make_consts(n=n)
    for field in synthesis_jax.SynthesisConsts._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    window = opus_custom_mode(48000, 960).window
    pg = plc.make_plc_consts(n, window, "cpu")
    pw = plc_jax.make_plc_consts(n, window)
    for key in ("F", "han", "lagw", "comb_gains"):
        np.testing.assert_array_equal(pg[key].numpy(), np.asarray(pw[key]),
                                      err_msg=key)
    for got_t, want_t in zip(pg["fold"], pw["fold"]):
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    for got_m, want_m in zip(band_exec.plan_combo_mats(2, n, "cpu"),
                             band_exec_jax.plan_combo_mats(2, n)):
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


_BLOCK_JAX = r"""
import importlib, pkgutil, sys

class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax.") or name == "jaxlib" \
                or name.startswith("jaxlib."):
            raise ImportError("jax is blocked: " + name)
        return None

sys.meta_path.insert(0, _NoJax())
import mousiki_tpu_torch
names = ["mousiki_tpu_torch"]
for info in pkgutil.walk_packages(mousiki_tpu_torch.__path__,
                                  "mousiki_tpu_torch."):
    names.append(info.name)
# the smoke run and its fixture loader import nothing of JAX either
for name in names + ["golden_streams", "chip_smoke"]:
    importlib.import_module(name)
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
print("imported", len(names))
"""


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _BLOCK_JAX], cwd=_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.split()[-1])
    assert n >= 9, proc.stdout


def test_deemphasis_cpu_takes_plain_path():
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((2, 2, 240)).astype(np.float32))
    mem = torch.as_tensor(rng.standard_normal((2, 2)).astype(np.float32))
    deemphasis.reset_launches()
    y, m = deemphasis.deemphasis(x, mem)
    want_y, want_m = deemphasis.deemphasis_reference(x, mem)
    assert deemphasis.deemphasis_launches == 0
    assert torch.equal(y, want_y) and torch.equal(m, want_m)
    with pytest.raises(TypeError):
        deemphasis.deemphasis(x.double(), mem.double())
    with pytest.raises(ValueError):
        deemphasis.deemphasis(x, mem[:1])


@pytest.mark.cuda
def test_deemphasis_kernel_matches_plain_on_gpu():
    """The CUDA kernel against its plain version (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the GPU")
    rng = np.random.default_rng(4)
    for S, N in ((256, 960), (256, 120), (7, 960)):
        x = torch.as_tensor((rng.standard_normal((S, 2, N)) * 1000)
                            .astype(np.float32), device="cuda")
        mem = torch.as_tensor((rng.standard_normal((S, 2)) * 100)
                              .astype(np.float32), device="cuda")
        before = deemphasis.deemphasis_launches
        y, m = deemphasis.deemphasis(x, mem)
        torch.cuda.synchronize()
        assert deemphasis.deemphasis_launches == before + 1
        want_y, want_m = deemphasis.deemphasis_reference(x, mem)
        scale = want_y.abs().max().item()
        assert (y - want_y).abs().max().item() < 1e-4 * scale
        assert (m - want_m).abs().max().item() < 1e-4 * scale


def test_device_is_required():
    """No default device: leaving it out raises instead of running on
    the CPU."""
    from mousiki_tpu_torch.pipeline import CeltStreamPipeline
    with pytest.raises(TypeError):
        CeltStreamPipeline(3)
    with pytest.raises(ValueError):
        synthesis.make_consts(960, None)
    with pytest.raises(ValueError):
        plc.init_plc_state(3, 2, None)
