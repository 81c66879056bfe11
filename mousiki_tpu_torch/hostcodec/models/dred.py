"""The DRED constants the copied `opus_encoder.py` imports as
`.models.dred`: re-exported from the port's own module
(mousiki_tpu_torch/models/dred.py)."""

from ...models.dred import DRED_EXTENSION_ID  # noqa: F401
