"""Batched device DRED loss recovery: port of
mousiki_tpu/parallel/deep_recovery.py.

The neural stack (RDOVAE decoder + PitchDNN + FARGAN) runs S streams as
batched device work, each of the reference's two compiled scans one
launch of a hand kernel on the card (its plain version, the eager loop,
on the CPU):

  * RDOVAE latent decode: `models/dred.decode_qframes` over the (padded)
    qframes, at most 26, with a per-qframe active mask freezing the
    streams that have run out of latents (csrc/rdovae.cu). The latents,
    initial states and masks go to the device in one copy and the
    features come back in one read.
  * Concealment synthesis: `models/fargan.conceal_frames`, per 10 ms
    frame the PitchDNN period and the FARGAN frame synthesis
    (csrc/fargan.cu); the PCM stays on the device.

Host work is only the per-stream entropy parse (dred.opus_dred_parse) and
the dequantization, the same serial / byte-granular split as the codec
pipelines.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from .. import _device
from ..models import dred as M
from ..models.deep_plc import PITCH_GRU, random_pitchdnn
from ..models.dred import DRED_NUM_FEATURES, synthetic_stats
from ..models.fargan import conceal_frames
from ..models.fargan import init_state as fargan_init
from ..models.fargan import random_model as fargan_random

_PAD = 24                  # padded latent / state width


class BatchedDeepRecovery:
    """S-stream DRED recovery on `device`: batched RDOVAE feature
    reconstruction + batched FARGAN concealment synthesis. The models
    given must live on `device`; the defaults are the synthetic ones
    (seeds 1, 2 and 3, as the reference's PRNG keys)."""

    def __init__(self, n_streams: int, fargan_model=None, dec_model=None,
                 pitch_model=None, stats=None, *, device):
        self.device = dev = _device.as_device(device)
        self.S = n_streams
        self.dec_model = dec_model or M.random_dec(
            torch.Generator().manual_seed(1), device=dev)
        self.fargan_model = fargan_model or fargan_random(
            torch.Generator().manual_seed(2), device=dev)
        self.pitch_model = pitch_model or random_pitchdnn(
            torch.Generator().manual_seed(3), device=dev)
        self.stats = stats or synthetic_stats()
        self.fargan_state = fargan_init(self.fargan_model, n_streams)
        self.pitch_state = torch.zeros((n_streams, PITCH_GRU), device=dev)
        self.last_periods = None    # (S, n_frames) of the last conceal

    def process(self, dreds: list):
        """dreds: S OpusDred-or-None. Returns (features (S, maxn10, 20)
        chronological and right-aligned, n10 (S,) valid counts), numpy."""
        S = self.S
        assert len(dreds) == S
        packed, n10 = M.pack_latents(dreds, self.stats)
        qmax = (packed.shape[1] - _PAD) // (_PAD + 1)
        if qmax == 0:
            return np.zeros((S, 0, DRED_NUM_FEATURES), np.float32), n10
        # features (S, qmax, 4, 20) a qframe (newest-first rows, each 4
        # reversed 10 ms frames like dred.rs rdovae_decode_all)
        with record_function("rdovae.decode_qframes"):
            out = M.decode_qframes(self.dec_model,
                                   torch.from_numpy(packed).to(self.device))
        out = out.cpu().numpy()
        # qframe i (newest first) covers chronological frames
        # [n10-4(i+1), n10-4i); rows within a qframe are newest-first.
        feats = np.zeros((S, 4 * qmax, DRED_NUM_FEATURES), np.float32)
        maxn10 = 4 * qmax
        for s in range(S):
            for i in range(int(n10[s]) // 4):
                pos = maxn10 - 4 * i
                feats[s, pos - 4: pos] = out[s, i, ::-1]
        return feats, n10

    def conceal(self, feats, active=None):
        """feats (S, n_frames, 20) per-lost-frame features (numpy or a
        tensor) -> 16 kHz PCM (S, n_frames*160), a tensor on the device.
        Advances the batched FARGAN/PitchDNN states; the float periods
        that drove each frame are kept in `last_periods`."""
        feats = torch.as_tensor(feats, dtype=torch.float32,
                                device=self.device)
        if active is not None:
            active = torch.as_tensor(active, dtype=torch.float32,
                                     device=self.device)
        with record_function("fargan.conceal_frames"):
            (pcm, self.last_periods, self.fargan_state,
             self.pitch_state) = conceal_frames(
                self.fargan_model, self.pitch_model, self.fargan_state,
                self.pitch_state, feats, active)
        return pcm
