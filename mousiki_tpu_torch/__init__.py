"""mousiki_tpu_torch — the PyTorch/CUDA port of mousiki_tpu's stream
decoders, for one NVIDIA H100: `CeltStreamPipeline` (CELT, plan and
non-plan mode), `SilkStreamPipeline` (SILK, host or device synthesis) and
`OpusStreamPipeline` (mixed SILK / CELT / hybrid packets).

The port stands alone: it keeps its own copies of what it needs from
`mousiki_tpu` (the native C++ host stages in `csrc/`, the 48 kHz mode, the
MDCT bases, the plan transforms, the packet parser, the resampler tables)
and imports nothing of that package. The device half is PyTorch ops on
tensors, with the de-emphasis tail (IIR, scale, interleave) as a
hand-written CUDA kernel (`ops/deemphasis.py`, `csrc/deemphasis.cu`). The
JAX package stays the reference every module is tested against.

Importing this package loads nothing heavy; `torch` loads with the first
submodule that needs it, and no module here imports `jax`.
"""

__version__ = "0.2.0"

__all__ = ["CeltStreamPipeline", "OpusStreamPipeline", "SilkStreamPipeline"]


def __getattr__(name):
    if name in __all__:
        from . import pipeline
        return getattr(pipeline, name)
    raise AttributeError(
        f"module 'mousiki_tpu_torch' has no attribute {name!r}")
