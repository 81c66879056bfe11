"""Device and precision policy of the port.

Tensors are float32, as in the reference. The JAX reference runs every
product at `Precision.HIGHEST` (synthesis_jax.py imdct_blocks,
band_exec_jax.py _apply_combo / band assembly / anti-collapse), so TF32
is switched off for matrix products and for cuDNN convolutions alike:
TF32 keeps about three decimal digits and would break the 1e-5
band-reconstruction bar.

A stream's value must not depend on which streams share its batch, nor
on how many there are. The libraries pick their kernels and reduction
orders by shape (MKL and oneDNN on the CPU; cuBLAS, cuDNN and torch's
reduction kernels on the card), so a float32 product or row sum of 2
streams rounds unlike one of 256, and the concealment grows that. Every
product on a decode step, and every sum whose order the library chooses
by the shape, therefore accumulates in float64, over operators that hold
the reference's float32 values (`operator64`), and is rounded to float32
once. Elementwise operations need no such care, nor a sum over a middle
axis of fixed size (the comb filter's taps), which torch reduces in one
order whatever the number of rows.
"""

from __future__ import annotations

import numpy as np
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


def from_cli(name: str) -> torch.device:
    """The device a script's --device option names: "cpu", or "cuda" (the
    scripts' default), which raises without a GPU."""
    return torch.device("cpu") if name == "cpu" else require_cuda()


def as_device(device) -> torch.device:
    """Normalise a device argument (str or torch.device). There is no
    default device: None raises, so a caller that forgets the argument
    cannot end up timing the CPU."""
    if device is None:
        raise ValueError("device is required (e.g. 'cuda' or 'cpu')")
    return torch.device(device)


def operator64(a, device) -> torch.Tensor:
    """A float32 operator (the reference's values) held in float64 on
    `device`, for the float64 products described above."""
    return torch.as_tensor(np.asarray(a, np.float32).astype(np.float64),
                           device=as_device(device))
