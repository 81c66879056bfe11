"""Public DRED API, deep redundancy end to end: port of mousiki_tpu/dred.py.

Mirrors the reference surface (src/dred.rs:463 opus_dred_parse, :509
opus_dred_process and the encoder side src/dred_encoder.rs:303
dred_compute_latents / :439 dred_encode_silk_frame, embedded via
packet-padding extension id 126 per src/opus_encoder.rs:1666):

  encoder: API-rate input -> 16 kHz -> LPCNet features (10 ms) -> RDOVAE
  encoder dframes (20 ms) -> circular latent buffer (newest first) ->
  entropy-coded payload (every other latent, per-level stats) -> packet
  padding extension.

  decoder: padding extension -> latents -> RDOVAE decoder run newest to
  oldest (each qframe emits 4x10 ms feature frames, reversed into
  chronological order) -> FARGAN concealment queue.

The networks run in PyTorch on the device of the model they are given.
Without a model, the synthetic-weight model is built on the GPU
(`_device.require_cuda`, which raises when there is none): these entry
points never fall back to the CPU on their own. The host parts (feature
extraction, the range coder, the packet and extension parsers) are the
reference's numpy code, from the port's copies under hostcodec/.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _device
from .hostcodec.bitstream.extensions import extensions_parse
from .hostcodec.bitstream.packet import parse_packet
from .models import dred as M
from .models.dred import (DRED_EXTENSION_ID, DRED_NUM_FEATURES, DredStats,
                          decode_qframes, dred_encode, dred_parse,
                          enc_init_state, encode_dframe, pack_latents,
                          synthetic_stats)
from .models.lpcnet_features import FeatureExtractor
from .ops.input_resampler import ArbitraryResampler

DRED_FRAME_10MS = 160  # 10 ms at 16 kHz


def _model_device(model) -> torch.device:
    """The device of an entry point that host code builds without one:
    the given model's, else the GPU."""
    return _device.require_cuda() if model is None else model.device


class DredEncoder:
    """Streaming DRED latent computation feeding payload emission. The
    RDOVAE encoder runs on the given model's device; without a model it is
    the synthetic one (seed 0), on the GPU."""

    def __init__(self, fs: int = 48000, channels: int = 2, model=None,
                 stats: DredStats | None = None, max_dframes: int = 26):
        self.device = _model_device(model)
        self.fs = fs
        self.channels = channels
        self.model = model if model is not None else M.random_enc(
            torch.Generator().manual_seed(0), device=self.device)
        self.stats = stats if stats is not None else synthetic_stats()
        self.state = enc_init_state(self.model, 1)
        self.max_dframes = max_dframes
        self.latents = []       # newest first: (latents24, state24) pairs
        self._fe = None
        self._resamp = None
        self._fifo16 = np.zeros(0, np.float64)
        self._feat_pending = []

    def _to_16k(self, pcm: np.ndarray) -> np.ndarray:
        mono = np.asarray(pcm, np.float64)
        if mono.ndim == 2:
            mono = mono.mean(axis=1)
        if self.fs == 16000:
            return mono
        if self._resamp is None:
            self._resamp = ArbitraryResampler(self.fs, 16000, channels=1,
                                              quality=5)
        return self._resamp.process(mono[:, None])[:, 0]

    def frame(self, pcm: np.ndarray) -> None:
        """Feed one frame of API-rate PCM (N, C); computes latents for
        every completed 20 ms dframe (dred_compute_latents)."""
        if self._fe is None:
            self._fe = FeatureExtractor()
        self._fifo16 = np.concatenate([self._fifo16, self._to_16k(pcm)])
        while len(self._fifo16) >= DRED_FRAME_10MS:
            f = self._fifo16[:DRED_FRAME_10MS]
            self._fifo16 = self._fifo16[DRED_FRAME_10MS:]
            self._feat_pending.append(self._fe.compute(f))
            if len(self._feat_pending) == 2:
                feats40 = np.concatenate(self._feat_pending)
                self._feat_pending = []
                x = torch.as_tensor(feats40.astype(np.float32)[None],
                                    device=self.device)
                lat, st, self.state = encode_dframe(self.model, self.state, x)
                self.latents.insert(0, (lat[0].cpu().numpy(),
                                        st[0].cpu().numpy()))
                del self.latents[self.max_dframes:]

    def payload(self, q0: int = 6, dq: int = 4, offset: int = 16,
                max_bytes: int = 160) -> bytes | None:
        """Entropy-code the newest state + every other latent
        (dred_encode_silk_frame framing)."""
        if len(self.latents) < 2:
            return None
        lat_list = [l for l, _ in self.latents[0::2]]
        init_state = self.latents[0][1]
        return dred_encode(lat_list, init_state, self.stats, q0=q0, dq=dq,
                           offset=offset, max_bytes=max_bytes)


class OpusDred:
    """Parsed DRED data (opus_dred_parse result)."""

    def __init__(self, packet, payload: bytes):
        self.q0 = packet.q0
        self.dq = packet.dq
        self.dred_offset = packet.offset
        self.state_q = packet.state_q
        self.latents_q = packet.latents_q
        self.payload = payload
        self.features = None    # filled by opus_dred_process

    @property
    def nb_latents(self) -> int:
        return len(self.latents_q)


def opus_dred_parse(data: bytes, stats: DredStats | None = None):
    """Extract and parse the DRED extension from an Opus packet; returns
    OpusDred or None when the packet carries no DRED (dred.rs:463)."""
    if stats is None:
        stats = synthetic_stats()
    parsed = parse_packet(data)
    if not parsed.padding:
        return None
    try:
        exts = extensions_parse(parsed.padding, len(parsed.frames))
    except Exception:
        return None
    for e in exts:
        if e.id == DRED_EXTENSION_ID:
            try:
                pkt = dred_parse(e.data, stats)
            except Exception:
                return None
            return OpusDred(pkt, e.data)
    return None


def opus_dred_process(dred: OpusDred, model=None,
                      stats: DredStats | None = None):
    """Run the RDOVAE decoder over the parsed latents; fills
    dred.features with chronological 10 ms feature vectors (dred.rs:509:
    newest-to-oldest qframes, each emitting 4 reversed feature frames),
    all of them in one models/dred.decode_qframes call (one launch and
    one read-back on the card). Runs on the model's device; without a
    model it is the synthetic decoder (seed 1), on the GPU."""
    dev = _model_device(model)
    if model is None:
        model = M.random_dec(torch.Generator().manual_seed(1), device=dev)
    if stats is None:
        stats = synthetic_stats()

    packed, _ = pack_latents([dred], stats)
    Q = dred.nb_latents
    out = np.zeros((Q, 4, DRED_NUM_FEATURES), np.float32)
    if Q:
        out = decode_qframes(model, torch.from_numpy(packed).to(dev))[0]
        out = out.cpu().numpy()
    # each transmitted latent covers 2 dframes = 4 x 10 ms feature frames;
    # a qframe's output is newest-first: reversed into chronological order
    feats = out[::-1, ::-1].reshape(4 * Q, DRED_NUM_FEATURES)
    dred.features = [feats[i] for i in range(4 * Q)]
    return dred.features
