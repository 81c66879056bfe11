"""CELT de-emphasis tail: y[n] = x[n] + coef*y[n-1], then the 1/32768
scale and the (S, C, N) -> (S, N, C) interleave, as one CUDA kernel and
its plain PyTorch version.

Port of mousiki_tpu/ops/pallas_kernels.py (deemphasis_pallas), of the
associative-scan fallback in synthesis_jax.deemphasis, and of the scale
and transpose that follow it in synthesis_jax.synthesis_step. A CUDA
tensor always goes to the hand-written kernel (csrc/deemphasis.cu), a
CPU tensor to `deemphasis_pcm_reference`; there is no other route.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# frame sizes the kernel is instantiated for (LM 0-3)
FRAME_SIZES = (120, 240, 480, 960)

# kernel launches made by `deemphasis_pcm` (not by the plain version)
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


def deemphasis_pcm_reference(x: torch.Tensor, mem: torch.Tensor,
                             coef: float = 0.85):
    """The plain version of the kernel: `deemphasis_reference`, the
    1/32768 scale and the interleave. Returns (pcm (S, N, C) contiguous,
    new_mem (S, C) unscaled)."""
    y, new_mem = deemphasis_reference(x, mem, coef)
    pcm = (y * (1.0 / 32768.0)).transpose(1, 2).contiguous()
    return pcm, new_mem


def _kernel():
    lib = _build.load("deemphasis")
    fn = lib.mousiki_deemphasis_pcm
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def build_kernel() -> None:
    """Compile and load the kernel now (it is otherwise built on first
    launch)."""
    _kernel()


def _check(x: torch.Tensor, mem: torch.Tensor) -> None:
    if x.dtype != torch.float32 or mem.dtype != torch.float32:
        raise TypeError(
            f"deemphasis_pcm takes float32, got {x.dtype}/{mem.dtype}")
    if x.dim() != 3 or tuple(mem.shape) != tuple(x.shape[:2]):
        raise ValueError(
            f"bad shapes x {tuple(x.shape)} mem {tuple(mem.shape)}")
    if x.shape[1] not in (1, 2):
        raise ValueError(f"deemphasis_pcm takes 1 or 2 channels, "
                         f"got {x.shape[1]}")
    if x.device != mem.device:
        raise ValueError(f"x on {x.device}, mem on {mem.device}")
    if not (x.is_contiguous() and mem.is_contiguous()):
        raise ValueError("deemphasis_pcm needs contiguous x and mem")


def deemphasis_pcm(x: torch.Tensor, mem: torch.Tensor, coef: float = 0.85):
    """x (S, C, N) float32 synthesis output, mem (S, C) carried y[-1];
    C in {1, 2}. Returns (pcm (S, N, C) contiguous, scaled by 1/32768;
    new_mem (S, C), the unscaled last sample).

    CPU tensors take `deemphasis_pcm_reference`; CUDA tensors launch the
    kernel (N in FRAME_SIZES) and raise if it cannot launch."""
    _check(x, mem)
    if x.device.type == "cpu":
        return deemphasis_pcm_reference(x, mem, coef)
    if x.device.type != "cuda":
        raise ValueError(f"deemphasis_pcm runs on cpu or cuda, not {x.device}")
    S, C, N = x.shape
    if N not in FRAME_SIZES:
        raise ValueError(f"the kernel takes N in {FRAME_SIZES}, got {N}")
    pcm = torch.empty((S, N, C), dtype=x.dtype, device=x.device)
    new_mem = torch.empty_like(mem)
    if S == 0:
        return pcm, new_mem
    if x.data_ptr() % 16 or pcm.data_ptr() % 16:
        raise ValueError("deemphasis_pcm needs 16-byte aligned x")
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), mem.data_ptr(), pcm.data_ptr(),
                new_mem.data_ptr(), S, C, N, float(coef), stream)
    if rc != 0:
        raise RuntimeError(
            f"deemphasis_pcm kernel launch failed: cuda error {rc}")
    global deemphasis_launches
    deemphasis_launches += 1
    return pcm, new_mem
