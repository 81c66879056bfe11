"""Device and precision policy of the port.

Everything is float32. The JAX reference runs every product at
`Precision.HIGHEST` (synthesis_jax.py imdct_blocks, band_exec_jax.py
_apply_combo / band assembly / anti-collapse), so TF32 is switched off
for matrix products and for cuDNN convolutions alike: TF32 keeps about
three decimal digits and would break the 1e-5 band-reconstruction bar.
"""

from __future__ import annotations

import torch


def _set_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


_set_precision()


def require_cuda() -> torch.device:
    """The first CUDA device; raises when no GPU is present."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this path needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def as_device(device) -> torch.device:
    """Normalise a device argument (str or torch.device). There is no
    default device: None raises, so a caller that forgets the argument
    cannot end up timing the CPU."""
    if device is None:
        raise ValueError("device is required (e.g. 'cuda' or 'cpu')")
    return torch.device(device)
