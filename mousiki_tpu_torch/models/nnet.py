"""Neural inference primitives in PyTorch: port of mousiki_tpu/models/nnet.py.

Parity: reference `src/nnet.rs` (LinearLayer:25, compute_generic_dense/gru/
conv1d/glu, compute_activation:111). Every primitive works on (S, ·)
tensors, a leading stream axis; a single stream is S = 1. The products run
in strict fp32 (TF32 is off, `_device.py`), as the reference's
`Precision.HIGHEST`. Sparse int8 weights from the libopus blob are
densified at load: the blob helpers below are the reference's numpy code,
unchanged, and `load_linear` turns their output into a `Linear` on a given
device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import _device

ACTIVATION_LINEAR = 0
ACTIVATION_SIGMOID = 1
ACTIVATION_TANH = 2
ACTIVATION_RELU = 3
ACTIVATION_SOFTMAX = 4
ACTIVATION_SWISH = 5


def _frozen(a, device) -> nn.Parameter:
    t = torch.tensor(np.asarray(a, np.float32), device=device)
    return nn.Parameter(t, requires_grad=False)


class Linear(nn.Module):
    """Dense layer: y = x @ W.T + b (+ diag shortcut for GRU-style layers).

    weight (out, in); bias (out,) or None; diag (3 * in,) tri-diagonal
    shortcut or None. Built from arrays (numpy or anything np.asarray
    reads) on `device`."""

    def __init__(self, w, b=None, diag=None, *, device):
        super().__init__()
        dev = _device.as_device(device)
        self.weight = _frozen(w, dev)
        self.bias = None if b is None else _frozen(b, dev)
        self.diag = None if diag is None else _frozen(diag, dev)


def activation(x, kind: int):
    if kind == ACTIVATION_LINEAR:
        return x
    if kind == ACTIVATION_SIGMOID:
        return torch.sigmoid(x)
    if kind == ACTIVATION_TANH:
        return torch.tanh(x)
    if kind == ACTIVATION_RELU:
        return torch.clamp_min(x, 0.0)
    if kind == ACTIVATION_SOFTMAX:
        return torch.softmax(x, dim=-1)
    if kind == ACTIVATION_SWISH:
        return x * torch.sigmoid(x)
    raise ValueError(kind)


def linear(layer: Linear, x, use_diag: bool = True):
    """x: (..., in) -> (..., out)."""
    y = F.linear(x, layer.weight, layer.bias)
    if use_diag and layer.diag is not None:
        m = x.shape[-1]
        d = layer.diag.view(3, m)
        y = y + (d * x.unsqueeze(-2)).flatten(-2)
    return y


def dense(layer: Linear, x, act: int = ACTIVATION_LINEAR):
    return activation(linear(layer, x), act)


def gru(input_w: Linear, recurrent_w: Linear, state, x):
    """One GRU step (libopus gate layout: z | r | h); returns new state."""
    n = state.shape[-1]
    zrh = linear(input_w, x)
    recur = linear(recurrent_w, state)
    zr = torch.sigmoid(zrh[..., :2 * n] + recur[..., :2 * n])
    z, r = zr[..., :n], zr[..., n:]
    h = torch.tanh(zrh[..., 2 * n:] + r * recur[..., 2 * n:])
    return z * state + (1.0 - z) * h


def glu(layer: Linear, x):
    return x * torch.sigmoid(linear(layer, x))


def conv1d_step(layer: Linear, mem, x, act: int = ACTIVATION_LINEAR):
    """Streaming 1-D conv: mem holds (ksize-1)*in_size history.

    Returns (y, new_mem)."""
    total = layer.weight.shape[1]
    in_size = x.shape[-1]
    if total == in_size:
        buf = x
        new_mem = mem
    else:
        buf = torch.cat([mem, x], dim=-1)
        new_mem = buf[..., in_size:]
    y = activation(linear(layer, buf, use_diag=False), act)
    return y, new_mem


# --- libopus weight-blob loading (the reference's numpy code) -------------

WEIGHT_BLOCK_SIZE = 64
WEIGHT_NAME_LEN = 44


def parse_weight_blob(data: bytes) -> dict:
    """Parse the libopus weight-blob format (parity src/dnn_weights.rs:27):
    repeated [64-byte header | payload]: i32 size@12, i32 block_size@16,
    NUL-terminated name@20 (44 bytes)."""
    out = {}
    pos = 0
    while pos < len(data):
        if len(data) - pos < WEIGHT_BLOCK_SIZE:
            raise ValueError("truncated blob header")
        header = data[pos: pos + WEIGHT_BLOCK_SIZE]
        size = int.from_bytes(header[12:16], "little", signed=True)
        block_size = int.from_bytes(header[16:20], "little", signed=True)
        if size < 0 or block_size < size:
            raise ValueError("bad blob sizes")
        name_bytes = header[20: 20 + WEIGHT_NAME_LEN]
        if name_bytes[-1] != 0:
            raise ValueError("unterminated name")
        name = name_bytes.split(b"\x00")[0].decode()
        payload = data[pos + WEIGHT_BLOCK_SIZE: pos + WEIGHT_BLOCK_SIZE + size]
        if len(payload) != size:
            raise ValueError("truncated payload")
        out[name] = payload
        pos += WEIGHT_BLOCK_SIZE + block_size
    return out


def write_weight_blob(arrays: dict) -> bytes:
    """Inverse of parse_weight_blob (for tests / repacking)."""
    out = bytearray()
    for name, payload in arrays.items():
        block_size = (len(payload) + 63) & ~63
        header = bytearray(WEIGHT_BLOCK_SIZE)
        header[0:4] = b"DNNw"
        header[12:16] = len(payload).to_bytes(4, "little")
        header[16:20] = block_size.to_bytes(4, "little")
        nb = name.encode()[: WEIGHT_NAME_LEN - 1]
        header[20: 20 + len(nb)] = nb
        out += header + payload + b"\x00" * (block_size - len(payload))
    return bytes(out)


def _f32(buf: bytes) -> np.ndarray:
    return np.frombuffer(buf, "<f4").copy()


def _i8(buf: bytes) -> np.ndarray:
    return np.frombuffer(buf, np.int8).copy()


def _densify_sparse8x4(weights, idx, rows, scale=None):
    """Expand libopus 8x4-block sparse weights to a dense float matrix.

    idx stream per 8-row band: [nb_blocks, col0, col1, ...]; each block is
    8 rows x 4 cols stored ROW-major (reference nnet.rs sparse_sgemv8x4 /
    sparse_cgemv8x4: y[r] uses w[4r..4r+4]). For int8 weights pass the
    per-row scale; the result folds in the x127 input-quantization factor
    so float math reproduces the quantized computation.
    """
    pos = 0
    blocks = []
    band = 0
    max_col = 0
    while pos < len(idx):
        nb = int(idx[pos])
        pos += 1
        cols = [int(c) for c in idx[pos: pos + nb]]
        pos += nb
        blocks.append((band, cols))
        max_col = max([max_col] + [c + 4 for c in cols])
        band += 8
    w = np.zeros((rows, max_col), np.float32)
    wpos = 0
    for band, cols in blocks:
        for c in cols:
            blk = weights[wpos: wpos + 32].reshape(8, 4)  # row-major block
            w[band: band + 8, c: c + 4] = blk
            wpos += 32
    if scale is not None:
        w = w * (127.0 * scale[:, None])
    return w


def _densify_dense8x4(weights_i8, rows, cols, scale):
    """Expand libopus dense blocked int8 weights (cgemv8x4 layout: 8x4
    row-major blocks, row-band major then column blocks) to float."""
    cols4 = (cols + 3) & ~3
    w = np.zeros((rows, cols4), np.float32)
    wpos = 0
    for band in range(0, rows, 8):
        for c in range(0, cols4, 4):
            blk = weights_i8[wpos: wpos + 32].reshape(8, 4)
            w[band: band + 8, c: c + 4] = blk
            wpos += 32
    return w[:, :cols] * (127.0 * scale[:, None])


def load_linear(arrays: dict, prefix: str, nb_inputs: int, nb_outputs: int,
                *, device) -> Linear:
    """Build a Linear on `device` from blob arrays using libopus naming
    conventions (reference nnet.rs linear_layer_from_weights /
    compute_linear): <prefix>_weights_float (dense col-major, or sparse
    8x4 with _weights_idx) or <prefix>_weights_int8 / _weights (+_scale,
    sparse with _weights_idx or dense cgemv8x4 blocks), plus _bias and
    _diag. int8 variants fold the x127 input-quantization factor so the
    float graph reproduces the reference's quantized computation."""
    b = arrays.get(prefix + "_bias")
    bias = _f32(b) if b else None
    d = arrays.get(prefix + "_diag")
    diag = _f32(d) if d else None
    idx_b = arrays.get(prefix + "_weights_idx")
    idx = np.frombuffer(idx_b, "<i4") if idx_b else None
    wf = arrays.get(prefix + "_weights_float")
    wi = arrays.get(prefix + "_weights_int8") or arrays.get(
        prefix + "_weights")
    if wf is not None:  # float weights win when both present (nnet.rs:502)
        if idx is not None:
            w = _densify_sparse8x4(_f32(wf), idx, nb_outputs)
            if w.shape[1] < nb_inputs:
                w = np.pad(w, ((0, 0), (0, nb_inputs - w.shape[1])))
            w = w[:, :nb_inputs]
        else:
            w = _f32(wf).reshape(nb_inputs, nb_outputs).T  # col-major
        return Linear(w, bias, diag, device=device)
    if wi is not None:
        scale = _f32(arrays[prefix + "_scale"])
        if idx is not None:
            w = _densify_sparse8x4(_i8(wi), idx, nb_outputs, scale)
        else:
            w = _densify_dense8x4(_i8(wi), nb_outputs, nb_inputs, scale)
        if w.shape[1] < nb_inputs:
            w = np.pad(w, ((0, 0), (0, nb_inputs - w.shape[1])))
        return Linear(w[:, :nb_inputs], bias, diag, device=device)
    raise KeyError(f"no weights for {prefix}")


def load_linear_auto(arrays: dict, prefix: str, nb_inputs: int | None = None,
                     nb_outputs: int | None = None, *, device) -> Linear:
    """load_linear with sizes inferred from the blob itself (the way the
    reference's linear_layer_from_blob works): nb_outputs from the bias
    length, nb_inputs from the float weight count or the sparse index."""
    if nb_outputs is None:
        b = arrays.get(prefix + "_bias")
        if not b:
            raise KeyError(f"cannot infer nb_outputs for {prefix}")
        nb_outputs = len(b) // 4
    if nb_inputs is None:
        wf = arrays.get(prefix + "_weights_float")
        idx_b = arrays.get(prefix + "_weights_idx")
        if wf is not None and idx_b is None:
            nb_inputs = (len(wf) // 4) // nb_outputs
        elif idx_b is not None:
            idx = np.frombuffer(idx_b, "<i4")
            pos, mx = 0, 0
            while pos < len(idx):
                nb = int(idx[pos])
                pos += 1
                for c in idx[pos: pos + nb]:
                    mx = max(mx, int(c) + 4)
                pos += nb
            nb_inputs = mx
        else:
            wi = arrays.get(prefix + "_weights_int8") or arrays.get(
                prefix + "_weights")
            if wi is None:
                raise KeyError(f"cannot infer nb_inputs for {prefix}")
            nb_inputs = len(wi) // (((nb_outputs + 7) & ~7))
    return load_linear(arrays, prefix, nb_inputs, nb_outputs, device=device)


def random_linear(gen: torch.Generator, nin: int, nout: int, scale: float,
                  *, device) -> Linear:
    """Synthetic layer: weight N(0, 1) * scale drawn from `gen` on the CPU
    (so that every device gets the same values), zero bias."""
    w = torch.randn((nout, nin), generator=gen) * scale
    return Linear(w.numpy(), np.zeros(nout, np.float32), None, device=device)
