"""The DRED API the copied `opus_encoder.py` and `opus_decoder.py` import
as `.dred`: the port's own (mousiki_tpu_torch/dred.py), whose RDOVAE
encoder and decoder run in PyTorch on the given model's device."""

from ..dred import (DredEncoder, OpusDred, opus_dred_parse,  # noqa: F401
                    opus_dred_process)
