"""Batched device DRED loss recovery: port of
mousiki_tpu/parallel/deep_recovery.py.

The neural stack (RDOVAE decoder + PitchDNN + FARGAN) runs S streams as
batched device work:

  * RDOVAE latent decode: one Python loop over the (padded) qframes, at
    most 26, each step the batched `decode_qframe`, with a per-step
    active mask (torch.where on every state tensor) freezing the streams
    that have run out of latents. The latents, initial states and masks
    go to the device in one copy and the features come back in one read.
  * Concealment synthesis: per 10 ms frame, batched PitchDNN period
    estimation + the batched FARGAN frame synthesis; the PCM stays on the
    device.

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
from ..models.deep_plc import PITCH_GRU, compute_pitchdnn, random_pitchdnn
from ..models.dred import (DRED_LATENT_DIM, DRED_NUM_FEATURES,
                           DRED_STATE_DIM, dequantize, q_level,
                           synthetic_stats)
from ..models.fargan import init_state as fargan_init
from ..models.fargan import random_model as fargan_random
from ..models.fargan import synthesize_frame

_PAD = 24                  # padded latent / state width


def _where(mask, new, old):
    """The state tree `new` where mask (S,) holds, else `old` (every state
    tensor is (S, n))."""
    if isinstance(new, torch.Tensor):
        return torch.where(mask[:, None], new, old)
    items = [_where(mask, n, o) for n, o in zip(new, old)]
    return type(new)(*items) if hasattr(new, "_fields") else tuple(items)


def _rdovae_decode_batch(model, lat, st24, active):
    """lat (S, Q, 24) padded latents (newest first), st24 (S, 24), active
    (S, Q) bool -> features (S, Q, 4, 20) per qframe (newest-first rows,
    each 4 reversed 10 ms frames like dred.rs rdovae_decode_all)."""
    state = M.dec_init_state(model, st24)
    outs = []
    for q in range(lat.shape[1]):
        with record_function("rdovae.qframe"):
            out, new_state = M.decode_qframe(model, state, lat[:, q])
            state = _where(active[:, q], new_state, state)
        outs.append(out)
    return torch.stack(outs, dim=1).view(lat.shape[0], lat.shape[1], 4,
                                         DRED_NUM_FEATURES)


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
        qmax = max((d.nb_latents for d in dreds if d is not None),
                   default=0)
        if qmax == 0:
            return np.zeros((S, 0, DRED_NUM_FEATURES), np.float32), \
                np.zeros(S, np.int32)
        # one host buffer, one copy: latents | initial state | active mask
        packed = np.zeros((S, qmax * _PAD + _PAD + qmax), np.float32)
        lat = packed[:, :qmax * _PAD].reshape(S, qmax, _PAD)
        st24 = packed[:, qmax * _PAD: (qmax + 1) * _PAD]
        act = packed[:, (qmax + 1) * _PAD:]
        n10 = np.zeros(S, np.int32)
        for s, d in enumerate(dreds):
            if d is None:
                continue
            st24[s, :DRED_STATE_DIM] = dequantize(
                d.state_q, self.stats.state_scale[d.q0])[:DRED_STATE_DIM]
            for i, lq in enumerate(d.latents_q):
                lvl = q_level(i, d.q0, d.dq)
                lat[s, i, :DRED_LATENT_DIM] = dequantize(
                    lq, self.stats.latent_scale[lvl])[:DRED_LATENT_DIM]
                act[s, i] = 1.0
            n10[s] = 4 * d.nb_latents
        dev_packed = torch.from_numpy(packed).to(self.device)
        out = _rdovae_decode_batch(
            self.dec_model,
            dev_packed[:, :qmax * _PAD].view(S, qmax, _PAD),
            dev_packed[:, qmax * _PAD: (qmax + 1) * _PAD],
            dev_packed[:, (qmax + 1) * _PAD:] > 0.5)
        out = out.cpu().numpy()                     # (S, qmax, 4, 20)
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
        S, n_frames = feats.shape[:2]
        fst, pst = self.fargan_state, self.pitch_state
        pcm, periods = [], []
        for k in range(n_frames):
            f = feats[:, k]
            period, pst = compute_pitchdnn(self.pitch_model, pst, f)
            out, fst = synthesize_frame(self.fargan_model, fst, f,
                                        period.to(torch.int32))
            pcm.append(out)
            periods.append(period)
        self.fargan_state, self.pitch_state = fst, pst
        self.last_periods = torch.stack(periods, dim=1)
        pcm = torch.cat(pcm, dim=1)
        if active is not None:
            pcm = pcm * torch.as_tensor(active, dtype=torch.float32,
                                        device=self.device)[:, None]
        return pcm
