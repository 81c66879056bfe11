"""Opus packet layer: TOC byte, code 0-3 framing, self-delimited packets.

Normative per RFC 6716 §3; behavioral parity with reference `src/packet.rs`
(opus_packet_parse_impl and the getter helpers).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

MAX_FRAME_BYTES = 1275
MAX_FRAMES_PER_PACKET = 48
MAX_PACKET_DURATION_48K = 5760  # 120 ms


class OpusError(Exception):
    pass


class InvalidPacket(OpusError):
    pass


class BadArg(OpusError):
    pass


class Mode(enum.IntEnum):
    SILK = 1000
    HYBRID = 1001
    CELT = 1002


class Bandwidth(enum.IntEnum):
    NARROWBAND = 1101      # 4 kHz
    MEDIUMBAND = 1102      # 6 kHz
    WIDEBAND = 1103        # 8 kHz
    SUPERWIDEBAND = 1104   # 12 kHz
    FULLBAND = 1105        # 20 kHz

    @property
    def audio_hz(self) -> int:
        return {1101: 4000, 1102: 6000, 1103: 8000,
                1104: 12000, 1105: 20000}[int(self)]


_SILK_BW = [Bandwidth.NARROWBAND, Bandwidth.MEDIUMBAND, Bandwidth.WIDEBAND]
_HYBRID_BW = [Bandwidth.SUPERWIDEBAND, Bandwidth.FULLBAND]
_CELT_BW = [Bandwidth.NARROWBAND, Bandwidth.WIDEBAND,
            Bandwidth.SUPERWIDEBAND, Bandwidth.FULLBAND]


def toc_mode(toc: int) -> Mode:
    config = toc >> 3
    if config < 12:
        return Mode.SILK
    if config < 16:
        return Mode.HYBRID
    return Mode.CELT


def toc_bandwidth(toc: int) -> Bandwidth:
    config = toc >> 3
    if config < 12:
        return _SILK_BW[config // 4]
    if config < 16:
        return _HYBRID_BW[(config - 12) // 2]
    return _CELT_BW[(config - 16) // 4]


def toc_channels(toc: int) -> int:
    return 2 if (toc & 0x4) else 1


def samples_per_frame(data: bytes, fs: int = 48000) -> int:
    """Frame duration in samples at `fs`, from the TOC byte."""
    toc = data[0]
    if toc & 0x80:  # CELT
        sz = (toc >> 3) & 0x3
        return (fs << sz) // 400
    if (toc & 0x60) == 0x60:  # Hybrid
        return fs // 50 if (toc & 0x08) else fs // 100
    sz = (toc >> 3) & 0x3
    if sz == 3:
        return fs * 60 // 1000
    return (fs << sz) // 100


@dataclass
class ParsedPacket:
    toc: int
    frames: list[bytes]
    payload_offset: int
    packet_offset: int
    padding: bytes = b""

    @property
    def mode(self) -> Mode:
        return toc_mode(self.toc)

    @property
    def bandwidth(self) -> Bandwidth:
        return toc_bandwidth(self.toc)

    @property
    def channels(self) -> int:
        return toc_channels(self.toc)

    @property
    def frame_size_48k(self) -> int:
        return samples_per_frame(bytes([self.toc]), 48000)


def _parse_size(data: bytes, pos: int, end: int) -> tuple[int, int]:
    """Read a 1-2 byte frame length; returns (size, bytes_consumed)."""
    if end - pos < 1:
        return -1, -1
    b0 = data[pos]
    if b0 < 252:
        return b0, 1
    if end - pos < 2:
        return -1, -1
    return 4 * data[pos + 1] + b0, 2


def parse_packet(data: bytes, self_delimited: bool = False) -> ParsedPacket:
    """Split an Opus packet into its compressed frames (RFC 6716 §3.2)."""
    if len(data) == 0:
        raise InvalidPacket("empty packet")
    framesize = samples_per_frame(data, 48000)
    toc = data[0]
    pos = 1
    length = len(data) - 1
    last_size = length
    cbr = False
    sizes: list[int] = []
    pad_total = 0

    code = toc & 0x3
    if code == 0:
        count = 1
    elif code == 1:
        count = 2
        cbr = True
        if not self_delimited:
            if length & 1:
                raise InvalidPacket("code-1 packet with odd payload")
            last_size = length // 2
            sizes = [last_size]
    elif code == 2:
        count = 2
        sz, nb = _parse_size(data, pos, pos + length)
        length -= nb
        if sz < 0 or sz > length:
            raise InvalidPacket("bad code-2 frame size")
        sizes = [sz]
        pos += nb
        last_size = length - sz
    else:
        if length < 1:
            raise InvalidPacket("code-3 packet too short")
        ch = data[pos]
        pos += 1
        count = ch & 0x3F
        if count <= 0 or framesize * count > MAX_PACKET_DURATION_48K:
            raise InvalidPacket("bad code-3 frame count")
        length -= 1
        if ch & 0x40:  # padding
            while True:
                if length <= 0:
                    raise InvalidPacket("truncated padding length")
                p = data[pos]
                pos += 1
                length -= 1
                tmp = 254 if p == 255 else p
                length -= tmp
                pad_total += tmp
                if p != 255:
                    break
        if length < 0:
            raise InvalidPacket("padding exceeds packet")
        cbr = not (ch & 0x80)
        if not cbr:
            last_size = length
            for _ in range(count - 1):
                sz, nb = _parse_size(data, pos, pos + length)
                length -= nb
                if sz < 0 or sz > length:
                    raise InvalidPacket("bad code-3 VBR frame size")
                sizes.append(sz)
                pos += nb
                last_size -= nb + sz
            if last_size < 0:
                raise InvalidPacket("code-3 VBR sizes exceed packet")
        elif not self_delimited:
            last_size = length // count
            if last_size * count != length:
                raise InvalidPacket("code-3 CBR payload not divisible")
            sizes = [last_size] * (count - 1)

    if self_delimited:
        sz, nb = _parse_size(data, pos, pos + length)
        length -= nb
        if sz < 0 or sz > length:
            raise InvalidPacket("bad self-delimited size")
        pos += nb
        if cbr:
            if sz * count > length:
                raise InvalidPacket("self-delimited CBR overflow")
            sizes = [sz] * count
        else:
            if nb + sz > last_size:
                raise InvalidPacket("self-delimited last frame too big")
            sizes = sizes + [sz]
    else:
        if last_size > MAX_FRAME_BYTES:
            raise InvalidPacket("frame exceeds 1275 bytes")
        sizes = sizes + [last_size]

    if any(s > MAX_FRAME_BYTES for s in sizes):
        raise InvalidPacket("frame exceeds 1275 bytes")

    payload_offset = pos
    frames = []
    for s in sizes[:count]:
        frames.append(bytes(data[pos: pos + s]))
        pos += s
    packet_offset = pos + pad_total
    padding = bytes(data[pos: packet_offset]) if pad_total else b""
    return ParsedPacket(
        toc=toc, frames=frames, payload_offset=payload_offset,
        packet_offset=packet_offset, padding=padding,
    )


def packet_get_nb_frames(data: bytes) -> int:
    if len(data) < 1:
        raise BadArg("short packet")
    code = data[0] & 0x3
    if code == 0:
        return 1
    if code != 3:
        return 2
    if len(data) < 2:
        raise InvalidPacket("code-3 without count byte")
    return data[1] & 0x3F


def packet_get_nb_samples(data: bytes, fs: int = 48000) -> int:
    count = packet_get_nb_frames(data)
    samples = count * samples_per_frame(data, fs)
    if samples * 25 > fs * 3:
        raise InvalidPacket("packet exceeds 120 ms")
    return samples
