"""Carry per-stream state between the JAX reference and the port.

The codec has no weights: its parameters are constant operators (built
from the same numpy code on both sides) and the per-stream state. A JAX
pipeline's mid-stream `state` / `plc_state`, read out with `np.asarray`,
continues in the port through these functions, and back.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _device
from .ops.plc import PlcState
from .ops.synthesis import StreamState


def _tensor(a, device):
    a = np.array(a)  # a private, writable copy
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(device)


def stream_state_from_numpy(state, device) -> StreamState:
    """A StreamState of numpy arrays (or anything np.asarray reads)."""
    dev = _device.as_device(device)
    return StreamState(*(_tensor(v, dev) for v in state))


def plc_state_from_numpy(plc, device) -> PlcState:
    dev = _device.as_device(device)
    return PlcState(*(_tensor(v, dev) for v in plc))


def stream_state_to_numpy(state: StreamState) -> StreamState:
    return StreamState(*(v.detach().cpu().numpy() for v in state))


def plc_state_to_numpy(plc: PlcState) -> PlcState:
    return PlcState(*(v.detach().cpu().numpy() for v in plc))
