"""FARGAN vocoder in PyTorch, batched over streams: port of
mousiki_tpu/models/fargan.py (reference src/fargan.rs).

Auto-regressive GAN vocoder used by Deep-PLC/DRED: per 40-sample subframe,
a conditioning net (period embedding + dense/conv/dense) drives a signal
net of a framewise conv+GLU, three gated GRUs with pitch-prediction
injections, and a skip/output dense. All math follows the reference graph.

The reference runs the output de-emphasis (y[n] = x[n] + 0.85 y[n-1]) as a
40-step scan in every subframe. Here it is one strict-fp32 product with the
40x40 lower-triangular matrix of 0.85^(n-k), built in float64, plus the
carry times 0.85^(n+1): no per-sample loop.

`conceal_frames` runs the concealment of a call's frames (each frame's
PitchDNN period, then synthesize_frame), the reference's compiled scan
(mousiki_tpu/parallel/deep_recovery.py _conceal_batch): on the card one
launch of a hand-written kernel (csrc/fargan.cu), which runs the
de-emphasis as the reference's recurrence; on the CPU its plain version
`conceal_frames_reference`, a Python loop of the functions above.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from .. import _device
from ..ops import _build
from .nnet import (ACTIVATION_TANH, conv1d_step, dense, glu, gru, linear,
                   load_linear_auto, pack_layers, random_linear,
                   stream_rows)

FARGAN_CONT_SAMPLES = 320
FARGAN_NB_SUBFRAMES = 4
FARGAN_SUBFRAME_SIZE = 40
FARGAN_FRAME_SIZE = FARGAN_NB_SUBFRAMES * FARGAN_SUBFRAME_SIZE
FARGAN_DEEMPHASIS = 0.85
PITCH_MAX_PERIOD = 256
NB_FEATURES = 20

# the reference's layer order (FarganModel fields after cond_pembed)
LAYERS = ("cond_fdense1", "cond_fconv1", "cond_fdense2", "cond_gain_dense",
          "fwc0_conv", "fwc0_glu", "gru1_in", "gru1_rec", "gru1_glu",
          "gru2_in", "gru2_rec", "gru2_glu", "gru3_in", "gru3_rec",
          "gru3_glu", "skip_dense", "skip_glu", "sig_dense_out",
          "gain_dense_out")


def _deemph_operators():
    """(T (40, 40), p (40,)) float64: y = x @ T.T + carry * p."""
    n = np.arange(FARGAN_SUBFRAME_SIZE)
    d = n[:, None] - n[None, :]
    T = np.where(d >= 0, FARGAN_DEEMPHASIS ** np.maximum(d, 0), 0.0)
    return T, FARGAN_DEEMPHASIS ** (n + 1.0)


class FarganModel(nn.Module):
    """cond_pembed (n_periods, embed_dim) and the Linear layers of LAYERS,
    all on one device; the de-emphasis operators ride along as buffers."""

    def __init__(self, cond_pembed, layers: dict, *, device):
        super().__init__()
        dev = _device.as_device(device)
        self.cond_pembed = nn.Parameter(
            torch.tensor(np.asarray(cond_pembed, np.float32), device=dev),
            requires_grad=False)
        for name in LAYERS:
            setattr(self, name, layers[name])
        T, p = _deemph_operators()
        # y = x @ deemph_t + carry * deemph_p
        self.register_buffer("deemph_t", torch.as_tensor(
            T.T.astype(np.float32)).to(dev), persistent=False)
        self.register_buffer("deemph_p", torch.as_tensor(
            p.astype(np.float32)).to(dev), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.cond_pembed.device


class FarganState(NamedTuple):
    pitch_buf: torch.Tensor    # (S, PITCH_MAX_PERIOD)
    cond_conv1_mem: torch.Tensor
    fwc0_mem: torch.Tensor
    gru1: torch.Tensor
    gru2: torch.Tensor
    gru3: torch.Tensor
    deemph: torch.Tensor       # (S,)


def init_state(model: FarganModel, n_streams: int) -> FarganState:
    S = n_streams
    conv1_hist = (model.cond_fconv1.weight.shape[1]
                  - model.cond_fdense1.weight.shape[0])
    fwc0_hist = 0  # fwc0 kernel covers exactly one frame of inputs

    def zeros(*shape):
        return torch.zeros(shape, device=model.device)

    return FarganState(
        pitch_buf=zeros(S, PITCH_MAX_PERIOD),
        cond_conv1_mem=zeros(S, max(conv1_hist, 0)),
        fwc0_mem=zeros(S, fwc0_hist),
        gru1=zeros(S, model.gru1_rec.weight.shape[1]),
        gru2=zeros(S, model.gru2_rec.weight.shape[1]),
        gru3=zeros(S, model.gru3_rec.weight.shape[1]),
        deemph=zeros(S),
    )


def compute_cond(model: FarganModel, state: FarganState, features, period):
    """features: (S, 20); period: (S,) int -> (cond (S, C), new_state)."""
    idx = torch.clamp(period.long() - 32, 0, model.cond_pembed.shape[0] - 1)
    emb = model.cond_pembed[idx]
    x = torch.cat([features, emb], dim=-1)
    x = dense(model.cond_fdense1, x, ACTIVATION_TANH)
    y, new_mem = conv1d_step(model.cond_fconv1, state.cond_conv1_mem, x,
                             ACTIVATION_TANH)
    cond = dense(model.cond_fdense2, y, ACTIVATION_TANH)
    return cond, state._replace(cond_conv1_mem=new_mem)


def _gather_pred(pitch_buf, period, n):
    """pred[i] = pitch_buf[wrap(PITCH_MAX - period - 2 + i)] (period-looped)."""
    i = torch.arange(n, device=pitch_buf.device)[None, :]
    per = period.long()[:, None]
    pos = PITCH_MAX_PERIOD - per - 2 + i
    # wrap positions >= PITCH_MAX back by one period (ar loop)
    pos = torch.where(pos >= PITCH_MAX_PERIOD, pos - per, pos)
    pos = torch.clamp(pos, 0, PITCH_MAX_PERIOD - 1)
    return torch.gather(pitch_buf, 1, pos)


def run_subframe(model: FarganModel, state: FarganState, cond, period):
    """One 40-sample subframe for all streams; returns (pcm, new_state)."""
    sub = FARGAN_SUBFRAME_SIZE
    gain = torch.exp(linear(model.cond_gain_dense, cond)[..., 0])
    gain_inv = 1.0 / (1e-5 + gain)

    pred = torch.clamp(gain_inv[:, None]
                       * _gather_pred(state.pitch_buf, period, sub + 4),
                       -1.0, 1.0)
    prev = torch.clamp(gain_inv[:, None] * state.pitch_buf[:, -sub:],
                       -1.0, 1.0)

    fwc0_in = torch.cat([cond, pred, prev], dim=-1)
    x, fwc0_mem = conv1d_step(model.fwc0_conv, state.fwc0_mem, fwc0_in,
                              ACTIVATION_TANH)
    x = glu(model.fwc0_glu, x)
    pitch_gate = torch.sigmoid(linear(model.gain_dense_out, x))  # (S, 4)

    pshift = pred[:, 2: 2 + sub]
    g1_in = torch.cat([x, pitch_gate[:, 0:1] * pshift, prev], dim=-1)
    gru1 = gru(model.gru1_in, model.gru1_rec, state.gru1, g1_in)
    g2_base = glu(model.gru1_glu, gru1)
    g2_in = torch.cat([g2_base, pitch_gate[:, 1:2] * pshift, prev], dim=-1)
    gru2 = gru(model.gru2_in, model.gru2_rec, state.gru2, g2_in)
    g3_base = glu(model.gru2_glu, gru2)
    g3_in = torch.cat([g3_base, pitch_gate[:, 2:3] * pshift, prev], dim=-1)
    gru3 = gru(model.gru3_in, model.gru3_rec, state.gru3, g3_in)
    g3_out = glu(model.gru3_glu, gru3)

    skip_cat = torch.cat(
        [g2_base, g3_base, g3_out, x, pitch_gate[:, 3:4] * pshift, prev],
        dim=-1)
    skip = dense(model.skip_dense, skip_cat, ACTIVATION_TANH)
    skip = glu(model.skip_glu, skip)
    pcm = dense(model.sig_dense_out, skip, ACTIVATION_TANH) * gain[:, None]

    pitch_buf = torch.cat([state.pitch_buf[:, sub:], pcm], dim=-1)

    # de-emphasis across the subframe: the reference's scan as one product
    pcm_out = torch.addcmul(pcm @ model.deemph_t, state.deemph[:, None],
                            model.deemph_p)

    new_state = state._replace(pitch_buf=pitch_buf, fwc0_mem=fwc0_mem,
                               gru1=gru1, gru2=gru2, gru3=gru3,
                               deemph=pcm_out[:, -1])
    return pcm_out, new_state


def synthesize_frame(model: FarganModel, state: FarganState, features, period):
    """One 160-sample frame (4 subframes) for all streams."""
    with record_function("fargan.cond"):
        cond, state = compute_cond(model, state, features, period)
    outs = []
    for _ in range(FARGAN_NB_SUBFRAMES):
        with record_function("fargan.subframe"):
            pcm, state = run_subframe(model, state, cond, period)
        outs.append(pcm)
    return torch.cat(outs, dim=-1), state


# --- the concealment's frames: one hand kernel on the card ---------------

# kernel launches made by `conceal_frames` (not by the plain version)
conceal_frames_launches = 0

PITCH_LAYERS = ("dense_in", "gru_i", "gru_r", "dense_out")
# PitchDNN's layers' (inputs, outputs): deep_plc.random_pitchdnn's
PITCH_DIMS = ((NB_FEATURES, 64), (64, 192), (64, 192), (64, 1))


def reset_launches() -> None:
    global conceal_frames_launches
    conceal_frames_launches = 0


def build_kernel() -> None:
    """Compile and load the kernel now (it is otherwise built on first
    launch)."""
    _build.load("fargan")


def conceal_frames_reference(model: FarganModel, pitch_model, state:
                             FarganState, pitch_state, feats, active=None,
                             frames=None):
    """The plain version of `conceal_frames`: Python loops of eager ops,
    one compute_pitchdnn and one synthesize_frame a frame."""
    # deep_plc imports this module; its PitchDNN is looked up at the call
    from .deep_plc import compute_pitchdnn

    if frames is not None:
        f = feats
        period, pitch_state = compute_pitchdnn(pitch_model, pitch_state, f)
    pcm, periods = [], []
    for k in range(feats.shape[1] if frames is None else frames):
        if frames is None:
            f = feats[:, k]
            period, pitch_state = compute_pitchdnn(pitch_model, pitch_state,
                                                   f)
        out, state = synthesize_frame(model, state, f,
                                      period.to(torch.int32))
        pcm.append(out)
        periods.append(period)
    S = feats.shape[0]
    pcm = (torch.cat(pcm, dim=1) if pcm
           else feats.new_zeros((S, 0)))
    periods = (torch.stack(periods, dim=1) if periods
               else feats.new_zeros((S, 0)))
    if active is not None:
        pcm = pcm * active[:, None]
    return pcm, periods, state, pitch_state


# the kernel's state inputs, in FarganArg's order (csrc/fargan.h), by field
_STATE_ARGS = ("pitch_buf", "cond_conv1_mem", "gru1", "gru2", "gru3",
               "deemph")
_P, _INT = ctypes.c_void_p, ctypes.c_int
# each entry point's arguments: the two packed buffers and their tables,
# the pointer array, the stride array, S, F, hold (and the CUDA stream)
_ARGTYPES = {
    "mousiki_fargan_conceal": [_P, _P, _P, _P, _P, _P, _INT, _INT, _INT,
                               _P],
    "fargan_conceal_host": [_P, _P, _P, _P, _P, _P, _INT, _INT, _INT],
}


def _check_models(model: FarganModel, pitch_model) -> None:
    """The layer widths the kernel takes (random_model's and from_blob's
    defaults, deep_plc.random_pitchdnn's); raises on others."""
    dims = layer_dims()
    got = {name: tuple(getattr(model, name).weight.shape[::-1])
           for name in LAYERS}
    pitch = tuple(tuple(getattr(pitch_model, name).weight.shape[::-1])
                  for name in PITCH_LAYERS)
    if (got != dims or model.cond_pembed.shape[1] != 12
            or pitch != PITCH_DIMS):
        raise ValueError(
            "the concealment kernel takes FARGAN at cond 256, GRU 128, "
            "embedding 12, no fwc0 history, and PitchDNN 20-64-1; got "
            f"{got}, embedding {tuple(model.cond_pembed.shape)}, PitchDNN "
            f"{pitch}")


def _kernel_inputs(model, pitch_model, state, pitch_state, feats, active,
                   frames):
    """Check a call against what the kernel takes; returns its inputs in
    FarganArg's order (each stream's row contiguous), S and F."""
    _check_models(model, pitch_model)
    dev = model.device
    if pitch_model.device != dev:
        raise ValueError(f"FARGAN is on {dev}, PitchDNN on "
                         f"{pitch_model.device}")
    S = feats.shape[0]
    F = feats.shape[1] if frames is None else frames
    want = {"feats": (S, F, NB_FEATURES) if frames is None
            else (S, NB_FEATURES),
            "active": (S,), "pitch_buf": (S, PITCH_MAX_PERIOD),
            "cond_conv1_mem": (S, 256), "fwc0_mem": (S, 0),
            "gru1": (S, 128), "gru2": (S, 128), "gru3": (S, 128),
            "deemph": (S,), "pitch_state": (S, 64)}
    given = {"feats": feats, "active": active, **state._asdict(),
             "pitch_state": pitch_state}
    for name, shape in want.items():
        t = given[name]
        if t is None and name == "active":
            continue
        if tuple(t.shape) != shape:
            raise TypeError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the models on {dev}")
    if F < 0:
        raise ValueError(f"frames must be >= 0, got {F}")
    names = ("feats", "active", *_STATE_ARGS, "pitch_state")
    return [None if given[n] is None else stream_rows(given[n])
            for n in names], S, F


def _run(model, pitch_model, state, pitch_state, feats, active, frames,
         host: bool):
    """One call through the kernel, on CUDA tensors, or through the host
    build of its arithmetic, on CPU tensors (`host`)."""
    inputs, S, F = _kernel_inputs(model, pitch_model, state, pitch_state,
                                  feats, active, frames)
    dev = feats.device
    if host != (dev.type == "cpu"):
        raise ValueError(f"the {'host build' if host else 'kernel'} does "
                         f"not take tensors on {dev}")
    outs = [torch.empty(shape, dtype=torch.float32, device=dev)
            for shape in ((S, F * FARGAN_FRAME_SIZE), (S, F),
                          (S, PITCH_MAX_PERIOD), (S, 256), (S, 128),
                          (S, 128), (S, 128), (S,), (S, 64))]
    new_state = FarganState(outs[2], outs[3], state.fwc0_mem, *outs[4:8])
    if S == 0:
        return outs[0], outs[1], new_state, outs[8]
    fp = pack_layers(model, [*(getattr(model, n) for n in LAYERS),
                             model.cond_pembed])
    pp = pack_layers(pitch_model, [getattr(pitch_model, n)
                                   for n in PITCH_LAYERS])
    ptrs = (ctypes.c_void_p * (len(inputs) + len(outs)))(
        *(0 if t is None else t.data_ptr() for t in inputs),
        *(t.data_ptr() for t in outs))
    strides = (ctypes.c_int64 * len(inputs))(
        *(0 if t is None else t.stride(0) for t in inputs))
    args = (fp.weights.data_ptr(), fp.table.ctypes.data,
            pp.weights.data_ptr(), pp.table.ctypes.data, ptrs, strides, S,
            F, int(frames is not None))
    if host:
        symbol = "fargan_conceal_host"
        rc = _entry(_build.load_header_host("fargan"), symbol)(*args)
    else:
        symbol = "mousiki_fargan_conceal"
        fn = _entry(_build.load("fargan"), symbol)
        with torch.cuda.device(dev):
            rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} failed: "
                           f"{'' if host else 'cuda error '}{rc}")
    return outs[0], outs[1], new_state, outs[8]


def _entry(lib, symbol: str):
    fn = getattr(lib, symbol)
    fn.argtypes = _ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return fn


def conceal_frames(model: FarganModel, pitch_model, state: FarganState,
                   pitch_state, feats, active=None, frames=None):
    """F frames of neural concealment for S streams: each frame's PitchDNN
    period (deep_plc.compute_pitchdnn) drives one synthesize_frame.

    feats (S, F, 20), a frame's features each; or, with `frames` = F,
    feats (S, 20): PitchDNN runs once on them, and its period and these
    features drive all F frames (DeepPlcState.conceal). active (S,)
    float32 or None scales the PCM. Returns (pcm (S, F * 160), float
    periods (S, F), new FarganState, new PitchDNN state (S, 64)).

    CPU tensors take `conceal_frames_reference`; CUDA tensors launch
    fargan_conceal_kernel (csrc/fargan.cu) once, and raise on a shape,
    dtype, device or layer width the kernel does not take."""
    dev = feats.device
    if dev.type == "cpu":
        return conceal_frames_reference(model, pitch_model, state,
                                        pitch_state, feats, active, frames)
    if dev.type != "cuda":
        raise ValueError(f"the concealment runs on cpu or cuda, not {dev}")
    out = _run(model, pitch_model, state, pitch_state, feats, active,
               frames, host=False)
    if feats.shape[0]:
        global conceal_frames_launches
        conceal_frames_launches += 1
    return out


def conceal_frames_host(model: FarganModel, pitch_model, state: FarganState,
                        pitch_state, feats, active=None, frames=None):
    """`conceal_frames` on CPU tensors through the host build of the
    kernel's arithmetic (csrc/fargan.h), the streams one after another."""
    return _run(model, pitch_model, state, pitch_state, feats, active,
                frames, host=True)


def random_model(gen: torch.Generator, cond_dim=256, gru_dim=128,
                 embed_dim=12, n_periods=224, *, device) -> FarganModel:
    """Synthetic weights for graph/shape testing, drawn from `gen` (seeded
    by the caller) with the reference's shapes and scales: N(0, 1) * 0.08
    weights, zero biases, N(0, 1) * 0.1 period embedding. The values are
    torch's, not jax.random's: to compare with the JAX package, carry its
    weights across (convert.fargan_from_numpy)."""
    pembed = (torch.randn((n_periods, embed_dim), generator=gen) * 0.1).numpy()
    dims = layer_dims(cond_dim, gru_dim, embed_dim)
    layers = {name: random_linear(gen, *dims[name], 0.08, device=device)
              for name in LAYERS}
    return FarganModel(pembed, layers, device=device)


def layer_dims(cond_dim=256, gru_dim=128, embed_dim=12) -> dict:
    """Each layer's (inputs, outputs) at these widths."""
    sub = FARGAN_SUBFRAME_SIZE
    fwc0_in = cond_dim + (sub + 4) + sub
    g1_in_dim = cond_dim + sub + sub
    g2_in_dim = gru_dim + sub + sub
    skip_in = gru_dim * 3 + cond_dim + sub + sub
    return dict(
        cond_fdense1=(NB_FEATURES + embed_dim, cond_dim),
        cond_fconv1=(cond_dim * 2, cond_dim),
        cond_fdense2=(cond_dim, cond_dim),
        cond_gain_dense=(cond_dim, 1),
        fwc0_conv=(fwc0_in, cond_dim),
        fwc0_glu=(cond_dim, cond_dim),
        gru1_in=(g1_in_dim, 3 * gru_dim),
        gru1_rec=(gru_dim, 3 * gru_dim),
        gru1_glu=(gru_dim, gru_dim),
        gru2_in=(g2_in_dim, 3 * gru_dim),
        gru2_rec=(gru_dim, 3 * gru_dim),
        gru2_glu=(gru_dim, gru_dim),
        gru3_in=(g2_in_dim, 3 * gru_dim),
        gru3_rec=(gru_dim, 3 * gru_dim),
        gru3_glu=(gru_dim, gru_dim),
        skip_dense=(skip_in, gru_dim),
        skip_glu=(gru_dim, gru_dim),
        sig_dense_out=(gru_dim, sub),
        gain_dense_out=(cond_dim, 4))


def from_blob(arrays: dict, cond_dim: int = 256, gru_dim: int = 128,
              embed_dim: int = 12, *, device) -> FarganModel:
    """Build FARGAN on `device` from a parsed libopus weight blob using the
    reference names (fargan.rs init_fargan_from_weights). Layer input dims
    are the known architecture constants, passed explicitly against the
    inference-from-padded-storage overestimate in load_linear_auto (blob
    rows are padded to 8, cols to 4)."""
    sub = FARGAN_SUBFRAME_SIZE
    fwc0_in = cond_dim + (sub + 4) + sub
    g1_in = cond_dim + 2 * sub
    g2_in = gru_dim + 2 * sub
    skip_in = gru_dim * 3 + cond_dim + 2 * sub

    def la(prefix, *dims):
        return load_linear_auto(arrays, prefix, *dims, device=device)

    pembed = la("cond_net_pembed", None, embed_dim)
    layers = dict(
        cond_fdense1=la("cond_net_fdense1", NB_FEATURES + embed_dim,
                        cond_dim),
        cond_fconv1=la("cond_net_fconv1", cond_dim * 2, cond_dim),
        cond_fdense2=la("cond_net_fdense2", cond_dim, cond_dim),
        cond_gain_dense=la("sig_net_cond_gain_dense", cond_dim, 1),
        fwc0_conv=la("sig_net_fwc0_conv", fwc0_in, cond_dim),
        fwc0_glu=la("sig_net_fwc0_glu_gate", cond_dim, cond_dim),
        gru1_in=la("sig_net_gru1_input", g1_in, 3 * gru_dim),
        gru1_rec=la("sig_net_gru1_recurrent", gru_dim, 3 * gru_dim),
        gru1_glu=la("sig_net_gru1_glu_gate", gru_dim, gru_dim),
        gru2_in=la("sig_net_gru2_input", g2_in, 3 * gru_dim),
        gru2_rec=la("sig_net_gru2_recurrent", gru_dim, 3 * gru_dim),
        gru2_glu=la("sig_net_gru2_glu_gate", gru_dim, gru_dim),
        gru3_in=la("sig_net_gru3_input", g2_in, 3 * gru_dim),
        gru3_rec=la("sig_net_gru3_recurrent", gru_dim, 3 * gru_dim),
        gru3_glu=la("sig_net_gru3_glu_gate", gru_dim, gru_dim),
        skip_dense=la("sig_net_skip_dense", skip_in, gru_dim),
        skip_glu=la("sig_net_skip_glu_gate", gru_dim, gru_dim),
        sig_dense_out=la("sig_net_sig_dense_out", gru_dim, sub),
        gain_dense_out=la("sig_net_gain_dense_out", cond_dim, 4))
    # (n_periods, embed_dim) lookup table
    return FarganModel(pembed.weight.T.cpu().numpy(), layers, device=device)
