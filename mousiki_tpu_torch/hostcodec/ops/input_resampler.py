"""The input resampler the copied `opus_encoder.py` imports as
`.ops.input_resampler`: re-exported from the port's own module
(mousiki_tpu_torch/ops/input_resampler.py, whose numpy part is the
reference's)."""

from ...ops.input_resampler import ArbitraryResampler  # noqa: F401
