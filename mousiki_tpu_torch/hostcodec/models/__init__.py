"""The neural models the copied `opus_encoder.py` and `opus_decoder.py`
import: re-exports of the port's own (mousiki_tpu_torch/models/)."""
