"""The committed golden CELT streams (tests/fixtures/golden.npz), as the
reference that needs neither libopus nor JAX. Shared by the port's tests
and chip_smoke.py; it reads the fixture from a source checkout and is not
part of any installed package.

Three stereo, 20 ms, full-band CELT streams (TOC config 31) with 12
packets each and the PCM the validated decoder produced for them.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

GOLDEN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "fixtures", "golden.npz")

STEREO_CELT = ("celt_fb_stereo_128k", "celt_low_48k", "audio_music_96k")


class GoldenStream(NamedTuple):
    name: str
    payloads: list      # 12 CELT frame payloads (TOC stripped)
    pcm: np.ndarray     # (12 * 960, 2) float32


def _single_frame(name: str, packet: bytes) -> bytes:
    """The frame of a one-frame Opus packet (TOC frame-count code 0)."""
    if len(packet) < 1 or packet[0] & 3 != 0:
        raise ValueError(f"{name}: expected one frame a packet (code 0)")
    return packet[1:]


def load_stereo_celt(path: str = GOLDEN_PATH) -> list[GoldenStream]:
    with np.load(path) as g:
        out = []
        for name in STEREO_CELT:
            blob = g[f"{name}__packets"].tobytes()
            payloads, pos = [], 0
            for n in g[f"{name}__lens"]:
                payloads.append(_single_frame(name, blob[pos:pos + int(n)]))
                pos += int(n)
            out.append(GoldenStream(name, payloads,
                                    np.asarray(g[f"{name}__pcm"], np.float32)))
    return out


def frame_batch(streams: list[GoldenStream], n_streams: int, f: int,
                lost=None) -> list:
    """Frame f for n_streams streams; stream s plays golden stream s % 3.
    lost: optional (n_streams,) bool, True = packet lost (None payload)."""
    return [None if lost is not None and lost[s]
            else streams[s % len(streams)].payloads[f]
            for s in range(n_streams)]


def golden_pcm(streams: list[GoldenStream], n_streams: int, f: int,
               frame: int = 960) -> np.ndarray:
    """(n_streams, frame, 2) golden PCM of frame f."""
    return np.stack([streams[s % len(streams)].pcm[f * frame:(f + 1) * frame]
                     for s in range(n_streams)])
