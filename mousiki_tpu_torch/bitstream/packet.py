"""Opus packet framing: TOC byte and code 0-3 frame splitting.

A copy of `parse_packet` and what it needs from
mousiki_tpu/bitstream/packet.py (normative per RFC 6716 section 3); the
pipeline feeder splits multi-frame packets with it.
"""

from __future__ import annotations

from dataclasses import dataclass

MAX_FRAME_BYTES = 1275
MAX_FRAMES_PER_PACKET = 48
MAX_PACKET_DURATION_48K = 5760  # 120 ms


class OpusError(Exception):
    pass


class InvalidPacket(OpusError):
    pass


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
