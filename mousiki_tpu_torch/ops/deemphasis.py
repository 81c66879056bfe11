"""CELT de-emphasis y[n] = x[n] + coef*y[n-1]: the CUDA kernel and its
plain PyTorch version.

Port of mousiki_tpu/ops/pallas_kernels.py (deemphasis_pallas) and of the
associative-scan fallback in synthesis_jax.deemphasis. A CUDA tensor
always goes to the hand-written kernel (csrc/deemphasis.cu), a CPU
tensor to `deemphasis_reference`; there is no other route.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# kernel launches made by `deemphasis` (not by `deemphasis_reference`)
deemphasis_launches = 0


def reset_launches() -> None:
    global deemphasis_launches
    deemphasis_launches = 0


def deemphasis_reference(x: torch.Tensor, mem: torch.Tensor,
                         coef: float = 0.85):
    """Plain PyTorch log-step scan over the last axis (the same affine
    pairs (a, b) as the JAX fallback). x (S, C, N), mem (S, C) carried
    y[-1]. Returns (y, y[..., -1])."""
    n = x.shape[-1]
    a = torch.full_like(x, coef)
    b = x.clone()
    b[..., 0] += coef * mem
    step = 1
    while step < n:
        # compose each position with the one `step` before it
        b_new = b.clone()
        b_new[..., step:] = b[..., step:] + a[..., step:] * b[..., :-step]
        a_new = a.clone()
        a_new[..., step:] = a[..., step:] * a[..., :-step]
        a, b = a_new, b_new
        step *= 2
    return b, b[..., -1].clone()


def _kernel():
    lib = _build.load("deemphasis")
    fn = lib.mousiki_deemphasis
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_float,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def build_kernel() -> None:
    """Compile and load the kernel now (it is otherwise built on first
    launch)."""
    _kernel()


def deemphasis(x: torch.Tensor, mem: torch.Tensor, coef: float = 0.85):
    """x (S, C, N) float32, mem (S, C) float32 -> (y (S, C, N), y[..., -1]).

    CPU tensors take `deemphasis_reference`; CUDA tensors launch the
    kernel (and raise if it cannot launch)."""
    if x.dtype != torch.float32 or mem.dtype != torch.float32:
        raise TypeError(f"deemphasis takes float32, got {x.dtype}/{mem.dtype}")
    if x.dim() != 3 or tuple(mem.shape) != tuple(x.shape[:2]):
        raise ValueError(
            f"bad shapes x {tuple(x.shape)} mem {tuple(mem.shape)}")
    if x.device != mem.device:
        raise ValueError(f"x on {x.device}, mem on {mem.device}")
    if x.device.type == "cpu":
        return deemphasis_reference(x, mem, coef)
    if x.device.type != "cuda":
        raise ValueError(f"deemphasis runs on cpu or cuda, not {x.device}")
    if not (x.is_contiguous() and mem.is_contiguous()):
        raise ValueError("deemphasis needs contiguous x and mem")
    S, C, N = x.shape
    y = torch.empty_like(x)
    new_mem = torch.empty_like(mem)
    if S * C == 0:
        return y, new_mem
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), mem.data_ptr(), y.data_ptr(),
                new_mem.data_ptr(), S * C, N, float(coef), stream)
    if rc != 0:
        raise RuntimeError(f"deemphasis kernel launch failed: cuda error {rc}")
    global deemphasis_launches
    deemphasis_launches += 1
    return y, new_mem
