"""The neural models the copied `opus_encoder.py` imports: re-exports of
the port's own (mousiki_tpu_torch/models/)."""
