"""DRED: deep redundancy coding (RDOVAE), architecture + latent transport:
port of mousiki_tpu/models/dred.py.

Parity targets (reference src/dred_encoder.rs:303,359,439; dred_rdovae_enc.rs
:147 dred_rdovae_encode_dframe; dred_rdovae_dec.rs:989,1034 rdovae_dec_init_
states/rdovae_decode_qframe; dred.rs:463 opus_dred_parse):

- RDOVAE encoder: densely-concatenated stack (dense -> [GRU, conv1d]x5) over
  2x20-dim feature frames per 20 ms dframe, emitting 21 latents + a 19-dim
  initial decoder state (padded to 24 each).
- RDOVAE decoder: state-init denses + (dense -> [GRU+GLU, conv1d]x5) stack
  reconstructing 4x20 features per quantized dframe.
- Latent transport: deadzone-tanh quantization and two-sided geometric
  (Laplace p0/decay) entropy coding with per-level stats tables; packet
  header (q0, dQ, frame offset) framed as Opus extension id 126.

Both networks run S streams at once: every tensor has a leading stream
axis, and a single stream is S = 1, so there is one code path. The
transport below the networks is the reference's numpy code, unchanged, on
the port's copy of the range coder (hostcodec/bitstream/entcode.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..hostcodec.bitstream.entcode import RangeDecoder, RangeEncoder
from .nnet import (ACTIVATION_LINEAR, ACTIVATION_TANH, Linear, dense, glu,
                   gru, load_linear, random_linear)

DRED_NUM_FEATURES = 20
DRED_LATENT_DIM = 21
DRED_STATE_DIM = 19
DRED_PADDED_LATENT_DIM = 24
DRED_PADDED_STATE_DIM = 24
DRED_NUM_QUANTIZATION_LEVELS = 16
DRED_FRAME_SIZE = 160          # 10 ms at 16 kHz
DRED_DFRAME_SIZE = 320
DRED_MAX_LATENTS = 26
DRED_EXTENSION_ID = 126
DRED_MIN_BYTES = 8

_ENC_GRUS = 5
_ENC_DENSE1 = 64
_ENC_GRU_OUT = 64
_ENC_CONV_OUT = 96
_DEC_DENSE1 = 96
_DEC_GRU_OUT = 96
_DEC_CONV_OUT = 32
_DEC_OUTPUT = 80
_GDENSE1 = 128
_CONV_DILATION = [1, 2, 2, 2, 2]


class DilatedConvState(NamedTuple):
    """kernel-2 conv with dilation d: y = W @ [x[t-d], x[t]]."""
    past: tuple  # d buffered past inputs (oldest first), each (S, n)


def _dconv(layer: Linear, state: DilatedConvState, x, act=ACTIVATION_TANH):
    oldest = state.past[0]
    y = dense(layer, torch.cat([oldest, x], dim=-1), act)
    new_past = state.past[1:] + (x,)
    return y, DilatedConvState(new_past)


class RdovaeEnc(nn.Module):
    def __init__(self, dense1: Linear, grus, convs, zdense: Linear,
                 gdense1: Linear, gdense2: Linear):
        super().__init__()
        self.dense1 = dense1
        self.grus = nn.ModuleList(nn.ModuleList(pair) for pair in grus)
        self.convs = nn.ModuleList(convs)
        self.zdense = zdense
        self.gdense1 = gdense1
        self.gdense2 = gdense2

    @property
    def device(self) -> torch.device:
        return self.dense1.weight.device


class RdovaeDec(nn.Module):
    def __init__(self, hidden_init: Linear, gru_init: Linear, dense1: Linear,
                 grus, glus, convs, output: Linear):
        super().__init__()
        self.hidden_init = hidden_init
        self.gru_init = gru_init
        self.dense1 = dense1
        self.grus = nn.ModuleList(nn.ModuleList(pair) for pair in grus)
        self.glus = nn.ModuleList(glus)
        self.convs = nn.ModuleList(convs)
        self.output = output

    @property
    def device(self) -> torch.device:
        return self.dense1.weight.device


class RdovaeEncState(NamedTuple):
    gru_states: tuple
    conv_states: tuple


class RdovaeDecState(NamedTuple):
    gru_states: tuple
    conv_states: tuple


def _enc_in_sizes():
    sizes = []
    total = _ENC_DENSE1
    for k in range(_ENC_GRUS):
        sizes.append(("gru", total, _ENC_GRU_OUT))
        total += _ENC_GRU_OUT
        sizes.append(("conv", total, _ENC_CONV_OUT))
        total += _ENC_CONV_OUT
    return sizes, total


def _dec_in_sizes():
    sizes = []
    total = _DEC_DENSE1
    for k in range(_ENC_GRUS):
        sizes.append(("gru", total, _DEC_GRU_OUT))
        total += _DEC_GRU_OUT
        sizes.append(("conv", total, _DEC_CONV_OUT))
        total += _DEC_CONV_OUT
    return sizes, total


def _random_lin(gen, nin, nout, device):
    return random_linear(gen, nin, nout, 0.3 / np.sqrt(nin), device=device)


def random_enc(gen: torch.Generator, *, device) -> RdovaeEnc:
    """Synthetic RDOVAE encoder drawn from `gen` with the reference's shapes
    and scales (N(0, 1) * 0.3 / sqrt(in), zero biases). The values are
    torch's, not jax.random's (convert.rdovae_enc_from_numpy carries JAX
    weights)."""
    sizes, total = _enc_in_sizes()
    grus, convs = [], []
    for kind, nin, nout in sizes:
        if kind == "gru":
            grus.append((_random_lin(gen, nin, 3 * nout, device),
                         _random_lin(gen, nout, 3 * nout, device)))
        else:
            convs.append(_random_lin(gen, 2 * nin, nout, device))
    return RdovaeEnc(
        dense1=_random_lin(gen, 2 * DRED_NUM_FEATURES, _ENC_DENSE1, device),
        grus=grus, convs=convs,
        zdense=_random_lin(gen, total, DRED_PADDED_LATENT_DIM, device),
        gdense1=_random_lin(gen, total, _GDENSE1, device),
        gdense2=_random_lin(gen, _GDENSE1, DRED_PADDED_STATE_DIM, device))


def random_dec(gen: torch.Generator, *, device) -> RdovaeDec:
    """Synthetic RDOVAE decoder drawn from `gen` (as random_enc; the JAX
    weights come across through convert.rdovae_dec_from_numpy)."""
    sizes, total = _dec_in_sizes()
    grus, glus, convs = [], [], []
    for kind, nin, nout in sizes:
        if kind == "gru":
            grus.append((_random_lin(gen, nin, 3 * nout, device),
                         _random_lin(gen, nout, 3 * nout, device)))
            glus.append(_random_lin(gen, nout, nout, device))
        else:
            convs.append(_random_lin(gen, 2 * nin, nout, device))
    return RdovaeDec(
        hidden_init=_random_lin(gen, DRED_PADDED_STATE_DIM, _GDENSE1, device),
        gru_init=_random_lin(gen, _GDENSE1, 5 * _DEC_GRU_OUT, device),
        dense1=_random_lin(gen, DRED_PADDED_LATENT_DIM, _DEC_DENSE1, device),
        grus=grus, glus=glus, convs=convs,
        output=_random_lin(gen, total, _DEC_OUTPUT, device))


def enc_from_blob(arrays: dict, *, device) -> RdovaeEnc:
    """Build the RDOVAE encoder on `device` from a parsed libopus weight
    blob using the reference names (dred_rdovae_enc.rs
    init_rdovaeenc_from_weights)."""
    def ll(prefix, nin, nout):
        return load_linear(arrays, prefix, nin, nout, device=device)

    grus, convs = [], []
    acc = _ENC_DENSE1
    for k in range(_ENC_GRUS):
        gi = ll(f"enc_gru{k + 1}_input", acc, 3 * _ENC_GRU_OUT)
        gr = ll(f"enc_gru{k + 1}_recurrent", _ENC_GRU_OUT, 3 * _ENC_GRU_OUT)
        grus.append((gi, gr))
        acc += _ENC_GRU_OUT
        convs.append(ll(f"enc_conv{k + 1}", 2 * acc, _ENC_CONV_OUT))
        acc += _ENC_CONV_OUT
    return RdovaeEnc(
        dense1=ll("enc_dense1", 2 * DRED_NUM_FEATURES, _ENC_DENSE1),
        grus=grus, convs=convs,
        zdense=ll("enc_zdense", acc, DRED_PADDED_LATENT_DIM),
        gdense1=ll("gdense1", acc, _GDENSE1),
        gdense2=ll("gdense2", _GDENSE1, DRED_PADDED_STATE_DIM))


def dec_from_blob(arrays: dict, *, device) -> RdovaeDec:
    """Build the RDOVAE decoder on `device` from a parsed libopus weight
    blob (dred_rdovae_dec.rs init_rdovaedec_from_weights; sizes per its
    DEC_*_SIZE constants)."""
    def ll(prefix, nin, nout):
        return load_linear(arrays, prefix, nin, nout, device=device)

    grus, glus, convs = [], [], []
    acc = _DEC_DENSE1
    for k in range(5):
        gi = ll(f"dec_gru{k + 1}_input", acc, 3 * _DEC_GRU_OUT)
        gr = ll(f"dec_gru{k + 1}_recurrent", _DEC_GRU_OUT, 3 * _DEC_GRU_OUT)
        grus.append((gi, gr))
        glus.append(ll(f"dec_glu{k + 1}", _DEC_GRU_OUT, _DEC_GRU_OUT))
        acc += _DEC_GRU_OUT
        convs.append(ll(f"dec_conv{k + 1}", 2 * acc, _DEC_CONV_OUT))
        acc += _DEC_CONV_OUT
    return RdovaeDec(
        hidden_init=ll("dec_hidden_init", DRED_PADDED_STATE_DIM, 128),
        gru_init=ll("dec_gru_init", 128, 5 * _DEC_GRU_OUT),
        dense1=ll("dec_dense1", DRED_PADDED_LATENT_DIM, _DEC_DENSE1),
        grus=grus, glus=glus, convs=convs,
        output=ll("dec_output", acc, _DEC_OUTPUT))


def _conv_states(sizes, S, device):
    conv_in = [s[1] for s in sizes if s[0] == "conv"]
    return tuple(
        DilatedConvState(tuple(torch.zeros((S, n), device=device)
                               for _ in range(d)))
        for n, d in zip(conv_in, _CONV_DILATION))


def enc_init_state(model: RdovaeEnc, n_streams: int = 1) -> RdovaeEncState:
    sizes, _ = _enc_in_sizes()
    dev = model.device
    gru_states = tuple(torch.zeros((n_streams, _ENC_GRU_OUT), device=dev)
                       for _ in range(_ENC_GRUS))
    return RdovaeEncState(gru_states, _conv_states(sizes, n_streams, dev))


def dec_init_state(model: RdovaeDec, initial_state) -> RdovaeDecState:
    """initial_state (S, 24) -> the decoder state of S streams."""
    h = dense(model.hidden_init, initial_state, ACTIVATION_TANH)
    g = dense(model.gru_init, h, ACTIVATION_TANH)
    gru_states = tuple(g[:, k * _DEC_GRU_OUT:(k + 1) * _DEC_GRU_OUT]
                       for k in range(5))
    sizes, _ = _dec_in_sizes()
    return RdovaeDecState(gru_states, _conv_states(
        sizes, initial_state.shape[0], model.device))


def encode_dframe(model: RdovaeEnc, state: RdovaeEncState, features40):
    """One 20 ms step: (S, 40) features -> (latents (S, 24),
    initial_state (S, 24), new state)."""
    buf = dense(model.dense1, features40, ACTIVATION_TANH)
    gru_states = list(state.gru_states)
    conv_states = list(state.conv_states)
    for k in range(_ENC_GRUS):
        gi, gr = model.grus[k]
        gru_states[k] = gru(gi, gr, gru_states[k], buf)
        buf = torch.cat([buf, gru_states[k]], dim=-1)
        y, conv_states[k] = _dconv(model.convs[k], conv_states[k], buf)
        buf = torch.cat([buf, y], dim=-1)
    latents = dense(model.zdense, buf, ACTIVATION_LINEAR)
    h = dense(model.gdense1, buf, ACTIVATION_TANH)
    init_state = dense(model.gdense2, h, ACTIVATION_LINEAR)
    return latents, init_state, RdovaeEncState(tuple(gru_states),
                                               tuple(conv_states))


def decode_qframe(model: RdovaeDec, state: RdovaeDecState, latents24):
    """One quantized dframe: (S, 24) latents -> (S, 80) outputs (4 x 20
    features), new state."""
    buf = dense(model.dense1, latents24, ACTIVATION_TANH)
    gru_states = list(state.gru_states)
    conv_states = list(state.conv_states)
    for k in range(5):
        gi, gr = model.grus[k]
        gru_states[k] = gru(gi, gr, gru_states[k], buf)
        buf = torch.cat([buf, glu(model.glus[k], gru_states[k])], dim=-1)
        y, conv_states[k] = _dconv(model.convs[k], conv_states[k], buf)
        buf = torch.cat([buf, y], dim=-1)
    out = dense(model.output, buf, ACTIVATION_LINEAR)
    return out, RdovaeDecState(tuple(gru_states), tuple(conv_states))


# ------------------------------------- transport (the reference's numpy code)
class DredStats(NamedTuple):
    """Per-(level, dim) quantization stats, Q8 (dred_stats_data layout)."""
    latent_scale: np.ndarray   # (16, 21) quant scales
    latent_dzone: np.ndarray
    latent_r: np.ndarray       # decay
    latent_p0: np.ndarray      # P(zero)
    state_scale: np.ndarray    # (16, 19)
    state_dzone: np.ndarray
    state_r: np.ndarray
    state_p0: np.ndarray


def synthetic_stats(seed: int = 0) -> DredStats:
    rng = np.random.default_rng(seed)

    def tab(dim):
        scale = rng.integers(96, 200, (16, dim)).astype(np.uint8)
        dz = rng.integers(0, 40, (16, dim)).astype(np.uint8)
        r = rng.integers(60, 200, (16, dim)).astype(np.uint8)
        p0 = rng.integers(40, 200, (16, dim)).astype(np.uint8)
        return scale, dz, r, p0

    ls, ld, lr, lp = tab(DRED_LATENT_DIM)
    ss, sd, sr, sp = tab(DRED_STATE_DIM)
    return DredStats(ls, ld, lr, lp, ss, sd, sr, sp)


def _quantize(x, scale, dzone):
    """Deadzone-tanh quantization (dred_encoder.rs:359 exact math)."""
    eps = 0.1
    delta = dzone.astype(np.float64) / 256.0
    xq = np.asarray(x, np.float64) * scale.astype(np.float64) / 256.0
    xq = xq - delta * np.tanh(xq / (delta + eps))
    return np.floor(0.5 + xq).astype(np.int64)


def laplace_encode_p0(enc: RangeEncoder, value: int, p0: int, decay: int):
    """Two-sided geometric with explicit zero probability (16-bit icdf)."""
    sign_icdf = [32768 - p0, (32768 - p0) // 2, 0]
    sym = 0 if value == 0 else (1 if value > 0 else 2)
    enc.enc_icdf16(sym, sign_icdf, 15)
    remaining = abs(value)
    if remaining:
        icdf = [max(decay, 7)] + [0] * 7
        for i in range(1, 7):
            icdf[i] = max(max(7 - i, 0), (icdf[i - 1] * decay) >> 15)
        icdf[7] = 0
        remaining -= 1
        while True:
            sym = min(remaining, 7)
            enc.enc_icdf16(sym, icdf, 15)
            remaining -= 7
            if remaining < 0:
                break


def laplace_decode_p0(dec: RangeDecoder, p0: int, decay: int) -> int:
    sign_icdf = [32768 - p0, (32768 - p0) // 2, 0]
    sym = dec.dec_icdf16(sign_icdf, 15)
    if sym == 0:
        return 0
    sign = 1 if sym == 1 else -1
    icdf = [max(decay, 7)] + [0] * 7
    for i in range(1, 7):
        icdf[i] = max(max(7 - i, 0), (icdf[i - 1] * decay) >> 15)
    icdf[7] = 0
    value = 1
    while True:
        sym = dec.dec_icdf16(icdf, 15)
        value += sym
        if sym < 7:
            break
    return sign * value


def encode_latents(enc: RangeEncoder, x, stats_row, kind: str = "latent"):
    """Quantize + entropy-code one latent/state vector at one q level."""
    scale, dzone, r, p0 = stats_row
    q = _quantize(x, scale, dzone)
    for i in range(len(q)):
        if r[i] == 0 or p0[i] == 255:
            q[i] = 0
        else:
            laplace_encode_p0(enc, int(q[i]), int(p0[i]) << 7, int(r[i]) << 7)
    return q


def decode_latents(dec: RangeDecoder, stats_row, dim: int) -> np.ndarray:
    scale, dzone, r, p0 = stats_row
    q = np.zeros(dim, np.int64)
    for i in range(dim):
        if r[i] == 0 or p0[i] == 255:
            q[i] = 0
        else:
            q[i] = laplace_decode_p0(dec, int(p0[i]) << 7, int(r[i]) << 7)
    return q


def dequantize(q, scale) -> np.ndarray:
    return q.astype(np.float64) * 256.0 / np.maximum(scale.astype(np.float64), 1)


def q_level(i: int, q0: int, dq: int) -> int:
    """Quantizer level schedule across redundancy frames."""
    return min(DRED_NUM_QUANTIZATION_LEVELS - 1, q0 + ((i * dq) >> 3))


class DredPacket(NamedTuple):
    q0: int
    dq: int
    offset: int
    state_q: np.ndarray       # (19,) quantized initial state
    latents_q: list           # list of (21,) per dframe (newest first)


def dred_encode(latent_list, initial_state, stats: DredStats, q0: int = 6,
                dq: int = 4, offset: int = 0, max_bytes: int = 160) -> bytes:
    """Assemble the DRED payload (dred_encode_silk_frame framing)."""
    enc = RangeEncoder(max_bytes)
    enc.enc_uint(q0, 16)
    enc.enc_uint(dq, 8)
    if offset >= 32:
        enc.enc_uint(1, 2)
        enc.enc_uint(offset >> 5, 256)
        enc.enc_uint(offset & 31, 32)
    else:
        enc.enc_uint(0, 2)
        enc.enc_uint(offset, 32)
    srow = (stats.state_scale[q0], stats.state_dzone[q0],
            stats.state_r[q0], stats.state_p0[q0])
    encode_latents(enc, initial_state[:DRED_STATE_DIM], srow, "state")
    for i, lat in enumerate(latent_list):
        lvl = q_level(i, q0, dq)
        row = (stats.latent_scale[lvl], stats.latent_dzone[lvl],
               stats.latent_r[lvl], stats.latent_p0[lvl])
        encode_latents(enc, lat[:DRED_LATENT_DIM], row)
        if enc.tell() > 8 * max_bytes - 32:
            break
    enc.done()
    used = max((enc.tell() + 7) >> 3, DRED_MIN_BYTES)
    return enc.data()[:used]


def dred_parse(payload: bytes, stats: DredStats,
               max_dframes: int = DRED_MAX_LATENTS) -> DredPacket:
    """Parse a DRED payload back into quantized state + latents."""
    dec = RangeDecoder(payload)
    q0 = dec.dec_uint(16)
    dq = dec.dec_uint(8)
    if dec.dec_uint(2):
        offset = (dec.dec_uint(256) << 5) | dec.dec_uint(32)
    else:
        offset = dec.dec_uint(32)
    srow = (stats.state_scale[q0], stats.state_dzone[q0],
            stats.state_r[q0], stats.state_p0[q0])
    state_q = decode_latents(dec, srow, DRED_STATE_DIM)
    latents = []
    for i in range(max_dframes):
        if dec.tell() + 16 > 8 * len(payload):
            break
        lvl = q_level(i, q0, dq)
        row = (stats.latent_scale[lvl], stats.latent_dzone[lvl],
               stats.latent_r[lvl], stats.latent_p0[lvl])
        latents.append(decode_latents(dec, row, DRED_LATENT_DIM))
    return DredPacket(q0, dq, offset, state_q, latents)


def dred_extension_payload(payload: bytes):
    """Wrap a DRED payload as the extension entry (id 126, frame 0)."""
    from ..hostcodec.bitstream.extensions import ExtensionData
    return [ExtensionData(id=DRED_EXTENSION_ID, frame=0, data=payload)]
