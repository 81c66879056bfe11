"""mousiki_tpu_torch — the PyTorch/CUDA port of mousiki_tpu's CELT stream
decoder, for one NVIDIA H100.

The port stands alone: it keeps its own copies of what it needs from
`mousiki_tpu` (the native C++ symbol stage in `csrc/celt_host.cpp`, the
48 kHz mode, the MDCT bases, the plan transforms) and imports nothing of
that package. The device half is PyTorch ops on tensors, with the
de-emphasis tail (IIR, scale, interleave) as a hand-written CUDA kernel
(`ops/deemphasis.py`, `csrc/deemphasis.cu`). The JAX package stays the
reference every module is tested against.

Importing this package loads nothing heavy; `torch` loads with the first
submodule that needs it, and no module here imports `jax`.
"""

__version__ = "0.1.0"

__all__ = ["CeltStreamPipeline"]


def __getattr__(name):
    if name == "CeltStreamPipeline":
        from .pipeline import CeltStreamPipeline
        return CeltStreamPipeline
    raise AttributeError(
        f"module 'mousiki_tpu_torch' has no attribute {name!r}")
