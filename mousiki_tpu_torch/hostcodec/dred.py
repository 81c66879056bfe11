"""The DRED encoder the copied `opus_encoder.py` imports as `.dred`: the
port's own (mousiki_tpu_torch/dred.py), whose RDOVAE encoder runs in
PyTorch."""

from ..dred import DredEncoder  # noqa: F401
