"""Carry per-stream state between the JAX reference and the port.

The codec has no weights: its parameters are constant operators (built
from the same numpy code on both sides) and the per-stream state. A JAX
pipeline's mid-stream `state` / `plc_state`, read out with `np.asarray`,
continues in the port through these functions, and back. The mixed
pipeline adds the resamplers' state per SILK rate, the one-sample SILK
delay, the previous rates and (device-SILK lane) the synthesis state:
`MixedState`. The native decoders' state lives in C++ on both sides and
is reached by feeding both the same packets. The encode side carries the
CELT front's state (a dict in the reference, `FrontState` here) and the
noise-shaping quantizers' states (`NsqDevState`, `NsqDelDecState`: the
same eight fields on both sides).

The neural recovery path has weights. The reference's models are
NamedTuples of arrays (`Linear`, `FarganModel`, `PitchDnn`, `RdovaeEnc`,
`RdovaeDec`); the `*_from_numpy` functions below build the port's modules
from them on a device, so that both sides run the same weights, and
`FarganState` crosses in both directions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _device
from .models import fargan
from .models.deep_plc import PitchDnn
from .models.dred import RdovaeDec, RdovaeEnc
from .models.nnet import Linear
from .ops.encode_front import FrontState
from .ops.plc import PlcState
from .ops.silk_nsq import NsqDelDecState, NsqDevState
from .ops.silk_resampler import Up48State
from .ops.silk_synthesis import SilkStreamState
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


def front_state_from_numpy(state: dict, device) -> FrontState:
    """The reference's front-state dict (numpy arrays, or anything
    np.asarray reads) as a FrontState on `device`."""
    dev = _device.as_device(device)
    return FrontState(*(_tensor(state[k], dev) for k in FrontState._fields))


def front_state_to_numpy(state: FrontState) -> dict:
    """A FrontState as the reference's dict of numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def nsq_state_from_numpy(state, device, del_dec: bool = False):
    """The eight fields of a noise-shaping quantizer state (the
    reference's NsqDevState or NsqDelDecState, as numpy arrays or
    anything np.asarray reads) as the port's state on `device`."""
    dev = _device.as_device(device)
    cls = NsqDelDecState if del_dec else NsqDevState
    return cls(*(_tensor(v, dev) for v in state))


def nsq_state_to_numpy(state):
    """An NsqDevState / NsqDelDecState of numpy arrays."""
    return type(state)(*(v.detach().cpu().numpy() for v in state))


class MixedState(NamedTuple):
    """The device state OpusStreamPipeline keeps beside `state` and
    `plc_state`, as numpy arrays (or anything np.asarray reads)."""
    rs_states: dict          # SILK rate in kHz -> Up48State
    silk_prev: np.ndarray    # (S * channels,) last SILK sample of each row
    prev_fs: np.ndarray      # (S,) int32 SILK rate of the previous frame
    silk_dev_state: tuple | None   # SilkStreamState of the device lane


def load_mixed_state(pipe, mixed: MixedState) -> None:
    """Set an OpusStreamPipeline's resampler / SILK device state from
    numpy arrays, on the pipeline's device."""
    dev = pipe.device
    pipe.rs_states = {int(r): Up48State(*(_tensor(v, dev) for v in st))
                      for r, st in mixed.rs_states.items()}
    pipe.silk_prev = _tensor(mixed.silk_prev, dev)
    pipe.prev_fs = _tensor(np.asarray(mixed.prev_fs, np.int32), dev)
    if mixed.silk_dev_state is not None:
        pipe.silk_dev_state = SilkStreamState(
            *(_tensor(v, dev) for v in mixed.silk_dev_state))


def mixed_state_to_numpy(pipe) -> MixedState:
    def arrays(state):
        return type(state)(*(v.detach().cpu().numpy() for v in state))

    return MixedState(
        rs_states={r: arrays(st) for r, st in pipe.rs_states.items()},
        silk_prev=pipe.silk_prev.detach().cpu().numpy(),
        prev_fs=pipe.prev_fs.detach().cpu().numpy(),
        silk_dev_state=(None if pipe.silk_dev_state is None
                        else arrays(pipe.silk_dev_state)))


def linear_from_numpy(lin, device) -> Linear:
    """The reference's Linear (w (out, in), b or None, diag or None)."""
    def arr(a):
        return None if a is None else np.asarray(a)

    return Linear(np.asarray(lin.w), arr(lin.b), arr(lin.diag),
                  device=device)


def fargan_from_numpy(model, device) -> fargan.FarganModel:
    return fargan.FarganModel(
        np.asarray(model.cond_pembed),
        {name: linear_from_numpy(getattr(model, name), device)
         for name in fargan.LAYERS}, device=device)


def pitchdnn_from_numpy(model, device) -> PitchDnn:
    return PitchDnn(*(linear_from_numpy(lin, device) for lin in model))


def _pairs(grus, device):
    return [(linear_from_numpy(gi, device), linear_from_numpy(gr, device))
            for gi, gr in grus]


def rdovae_enc_from_numpy(model, device) -> RdovaeEnc:
    return RdovaeEnc(
        dense1=linear_from_numpy(model.dense1, device),
        grus=_pairs(model.grus, device),
        convs=[linear_from_numpy(c, device) for c in model.convs],
        zdense=linear_from_numpy(model.zdense, device),
        gdense1=linear_from_numpy(model.gdense1, device),
        gdense2=linear_from_numpy(model.gdense2, device))


def rdovae_dec_from_numpy(model, device) -> RdovaeDec:
    return RdovaeDec(
        hidden_init=linear_from_numpy(model.hidden_init, device),
        gru_init=linear_from_numpy(model.gru_init, device),
        dense1=linear_from_numpy(model.dense1, device),
        grus=_pairs(model.grus, device),
        glus=[linear_from_numpy(g, device) for g in model.glus],
        convs=[linear_from_numpy(c, device) for c in model.convs],
        output=linear_from_numpy(model.output, device))


def fargan_state_from_numpy(state, device) -> fargan.FarganState:
    """The seven fields of a FarganState (numpy arrays, or anything
    np.asarray reads) on `device`."""
    dev = _device.as_device(device)
    return fargan.FarganState(*(_tensor(v, dev) for v in state))


def fargan_state_to_numpy(state: fargan.FarganState) -> fargan.FarganState:
    return fargan.FarganState(*(v.detach().cpu().numpy() for v in state))
