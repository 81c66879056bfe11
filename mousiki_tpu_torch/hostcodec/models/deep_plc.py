"""The deep PLC the copied `opus_decoder.py` imports as
`.models.deep_plc`: the port's own DeepPlcState
(mousiki_tpu_torch/models/deep_plc.py), built where the decoder's
`set_deep_plc` hands it no device: on the FARGAN model's device, else the
PitchDNN model's, else the GPU (which raises where there is none). It
never falls back to the CPU on its own."""

from ..._device import require_cuda
from ...models.deep_plc import DeepPlcState as _DeepPlcState


def DeepPlcState(fargan_model=None, pitch_model=None) -> _DeepPlcState:
    model = fargan_model if fargan_model is not None else pitch_model
    device = require_cuda() if model is None else model.device
    return _DeepPlcState(fargan_model=fargan_model, pitch_model=pitch_model,
                         device=device)
