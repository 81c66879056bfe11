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
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from .. import _device
from .nnet import (ACTIVATION_TANH, conv1d_step, dense, glu, gru, linear,
                   load_linear_auto, random_linear)

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


def random_model(gen: torch.Generator, cond_dim=256, gru_dim=128,
                 embed_dim=12, n_periods=224, *, device) -> FarganModel:
    """Synthetic weights for graph/shape testing, drawn from `gen` (seeded
    by the caller) with the reference's shapes and scales: N(0, 1) * 0.08
    weights, zero biases, N(0, 1) * 0.1 period embedding. The values are
    torch's, not jax.random's: to compare with the JAX package, carry its
    weights across (convert.fargan_from_numpy)."""
    sub = FARGAN_SUBFRAME_SIZE
    fwc0_in = cond_dim + (sub + 4) + sub
    g1_in_dim = cond_dim + sub + sub
    g2_in_dim = gru_dim + sub + sub
    skip_in = gru_dim * 3 + cond_dim + sub + sub
    pembed = (torch.randn((n_periods, embed_dim), generator=gen) * 0.1).numpy()
    dims = dict(
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
    layers = {name: random_linear(gen, *dims[name], 0.08, device=device)
              for name in LAYERS}
    return FarganModel(pembed, layers, device=device)


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
