"""Deep PLC: neural concealment gluing features + FARGAN (+ DRED FEC):
port of mousiki_tpu/models/deep_plc.py.

Reference celt/deep_plc.rs (LpcNetPlcState:349,483): keep a feature
history from the decoded output; on loss, synthesize audio with FARGAN
from the last (or DRED-injected) features. PitchDNN (pitchdnn.rs:91)
estimates the period driving FARGAN; `compute_pitchdnn` runs S streams at
once, (S, 20) features in, (S,) periods out. A concealment runs PitchDNN
once and FARGAN's frames through fargan.conceal_frames (one kernel
launch and one read-back a call on the card).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from .. import _device
from .fargan import FARGAN_FRAME_SIZE, conceal_frames
from .fargan import init_state as fargan_init
from .lpcnet_features import FRAME_SIZE, FeatureExtractor
from .nnet import ACTIVATION_TANH, Linear, dense, gru, random_linear

PITCH_GRU = 64          # PitchDNN's GRU state width


class PitchDnn(nn.Module):
    def __init__(self, dense_in: Linear, gru_i: Linear, gru_r: Linear,
                 dense_out: Linear):
        super().__init__()
        self.dense_in = dense_in
        self.gru_i = gru_i
        self.gru_r = gru_r
        self.dense_out = dense_out

    @property
    def device(self) -> torch.device:
        return self.dense_in.weight.device


def random_pitchdnn(gen: torch.Generator, *, device) -> PitchDnn:
    """Synthetic PitchDNN drawn from `gen` with the reference's shapes and
    scales (N(0, 1) * 0.2 / sqrt(in), zero biases). The values are torch's,
    not jax.random's (convert.pitchdnn_from_numpy carries JAX weights)."""
    def lin(nin, nout):
        return random_linear(gen, nin, nout, 0.2 / np.sqrt(nin),
                             device=device)

    return PitchDnn(lin(20, 64), lin(64, 192), lin(64, 192), lin(64, 1))


def compute_pitchdnn(model: PitchDnn, state, features):
    """features (S, 20), state (S, 64) -> (period estimate (S,) in samples
    at 16 kHz, float; new gru state)."""
    with record_function("pitchdnn"):
        h = dense(model.dense_in, features, ACTIVATION_TANH)
        state = gru(model.gru_i, model.gru_r, state, h)
        raw = dense(model.dense_out, state)
        period = 32.0 + 224.0 * torch.clamp(0.5 * (raw[:, 0] + 1.0), 0.0, 1.0)
    return period, state


class DeepPlcState:
    """Feature tracking + neural concealment for one stream, on `device`
    (where its models live). Without a FARGAN model, conceal returns
    zeros, as in the reference."""

    def __init__(self, fargan_model=None, pitch_model=None, *, device):
        self.device = _device.as_device(device)
        self.extractor = FeatureExtractor()
        self.fargan_model = fargan_model
        self.pitch_model = pitch_model or random_pitchdnn(
            torch.Generator().manual_seed(3), device=self.device)
        self.pitch_state = torch.zeros((1, PITCH_GRU), device=self.device)
        self.fargan_state = None
        self.last_features = np.zeros(20)
        self.fec_queue = []       # DRED-injected feature vectors
        self.loss_count = 0
        self.last_period = None   # (1,) float period of the last conceal

    def update(self, pcm16k: np.ndarray) -> None:
        """Track features over the decoded (good) audio, 10 ms at a time."""
        for off in range(0, len(pcm16k) - FRAME_SIZE + 1, FRAME_SIZE):
            self.last_features = self.extractor.compute(
                pcm16k[off: off + FRAME_SIZE])
        self.loss_count = 0

    def inject_fec_features(self, features_list) -> None:
        """Queue DRED-recovered feature vectors for upcoming losses."""
        self.fec_queue = [np.asarray(f) for f in features_list]

    def conceal(self, n_samples: int) -> np.ndarray:
        """Generate concealment audio at 16 kHz with FARGAN."""
        if self.fargan_model is None:
            self.loss_count += 1
            return np.zeros(n_samples)
        if self.fargan_state is None:
            self.fargan_state = fargan_init(self.fargan_model, 1)
        feats = (self.fec_queue.pop(0) if self.fec_queue
                 else self.last_features)
        f = torch.as_tensor(np.asarray(feats, np.float32)[None, :],
                            device=self.device)
        # PitchDNN once, its period and these features for every frame
        pcm, periods, self.fargan_state, self.pitch_state = conceal_frames(
            self.fargan_model, self.pitch_model, self.fargan_state,
            self.pitch_state, f, frames=-(-n_samples // FARGAN_FRAME_SIZE))
        self.last_period = periods[:, 0]
        self.loss_count += 1
        return pcm[0].cpu().numpy()[:n_samples]
