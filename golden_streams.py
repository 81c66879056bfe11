"""The committed golden Opus streams (tests/fixtures/golden.npz), as the
reference that needs neither libopus nor JAX. Shared by the port's tests
and chip_smoke.py; it reads the fixture from a source checkout and is not
part of any installed package.

Three stereo, 20 ms, full-band CELT streams (TOC config 31) and five mono
streams of mixed modes (CELT, wide-band and narrow-band SILK, two hybrid),
with 12 packets each, and the PCM and final ranges the validated decoder
produced for them.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

GOLDEN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "fixtures", "golden.npz")

STEREO_CELT = ("celt_fb_stereo_128k", "celt_low_48k", "audio_music_96k")
MONO_MIX = ("celt_fb_mono_64k", "silk_wb_16k", "silk_nb_8k",
            "hybrid_swb_40k", "hybrid_fb_48k")
# hybrid_fb_48k's first two frames are outside the mixed pipeline's scope
# (the reference pipeline differs from the golden PCM there too)
MIX_GOLDEN_FROM = {"hybrid_fb_48k": 2}


class GoldenStream(NamedTuple):
    name: str
    payloads: list      # 12 frame payloads (TOC stripped)
    pcm: np.ndarray     # (12 * 960, channels) float32
    packets: list       # the 12 whole packets, TOC byte first
    ranges: list        # the decoder's final range after each packet


def _single_frame(name: str, packet: bytes) -> bytes:
    """The frame of a one-frame Opus packet (TOC frame-count code 0)."""
    if len(packet) < 1 or packet[0] & 3 != 0:
        raise ValueError(f"{name}: expected one frame a packet (code 0)")
    return packet[1:]


def _load(names, path: str) -> list[GoldenStream]:
    with np.load(path) as g:
        out = []
        for name in names:
            blob = g[f"{name}__packets"].tobytes()
            packets, pos = [], 0
            for n in g[f"{name}__lens"]:
                packets.append(blob[pos:pos + int(n)])
                pos += int(n)
            out.append(GoldenStream(
                name, [_single_frame(name, p) for p in packets],
                np.asarray(g[f"{name}__pcm"], np.float32), packets,
                [int(r) for r in g[f"{name}__ranges"]]))
    return out


def load_all(path: str = GOLDEN_PATH) -> list[GoldenStream]:
    """All eight streams, in the fixture's own order (its manifest)."""
    with np.load(path) as g:
        names = [str(n) for n in g["__manifest_names"]]
    return _load(names, path)


def load_stereo_celt(path: str = GOLDEN_PATH) -> list[GoldenStream]:
    return _load(STEREO_CELT, path)


def load_mono_mix(path: str = GOLDEN_PATH) -> list[GoldenStream]:
    """The five mono streams of MONO_MIX: one CELT, two SILK (16 and
    8 kHz internal rate) and two hybrid."""
    return _load(MONO_MIX, path)


def frame_batch(streams: list[GoldenStream], n_streams: int, f: int,
                lost=None, packets: bool = False) -> list:
    """Frame f for n_streams streams; stream s plays golden stream
    s % len(streams). lost: optional (n_streams,) bool, True = packet
    lost (None payload). packets=True gives whole packets (TOC first),
    as the mixed pipeline takes them, instead of bare frame payloads."""
    return [None if lost is not None and lost[s]
            else (streams[s % len(streams)].packets[f] if packets
                  else streams[s % len(streams)].payloads[f])
            for s in range(n_streams)]


def golden_pcm(streams: list[GoldenStream], n_streams: int, f: int,
               frame: int = 960) -> np.ndarray:
    """(n_streams, frame, channels) golden PCM of frame f."""
    return np.stack([streams[s % len(streams)].pcm[f * frame:(f + 1) * frame]
                     for s in range(n_streams)])
