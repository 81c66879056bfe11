"""Ogg bitstream layer: page framing, CRC, stream mux/demux.

Parity: reference `mousiki-ogg/` (page/packet/stream/sync/crc) — a full
Ogg implementation per RFC 3533: 27-byte headers, 255-lacing segmentation,
CRC-32 (poly 0x04c11db7, init/xor 0), continued packets, BOS/EOS flags.
"""

from __future__ import annotations

from dataclasses import dataclass, field

_CRC_TABLE = []


def _build_crc():
    for i in range(256):
        r = i << 24
        for _ in range(8):
            r = ((r << 1) ^ 0x04C11DB7) & 0xFFFFFFFF if r & 0x80000000 \
                else (r << 1) & 0xFFFFFFFF
        _CRC_TABLE.append(r)


_build_crc()


def ogg_crc(data: bytes, crc: int = 0) -> int:
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ _CRC_TABLE[((crc >> 24) & 0xFF) ^ b]
    return crc


@dataclass
class OggPage:
    version: int = 0
    header_type: int = 0        # 1=continued, 2=BOS, 4=EOS
    granule_pos: int = 0
    serial: int = 0
    page_seq: int = 0
    segments: list = field(default_factory=list)  # raw segment byte chunks

    @property
    def continued(self) -> bool:
        return bool(self.header_type & 1)

    @property
    def bos(self) -> bool:
        return bool(self.header_type & 2)

    @property
    def eos(self) -> bool:
        return bool(self.header_type & 4)

    def serialize(self) -> bytes:
        body = b"".join(self.segments)
        # segments are already lacing units (each <= 255 bytes)
        assert all(len(s) <= 255 for s in self.segments)
        lacing = bytearray(len(s) for s in self.segments)
        header = bytearray(b"OggS")
        header.append(self.version)
        header.append(self.header_type)
        header += self.granule_pos.to_bytes(8, "little", signed=True)
        header += self.serial.to_bytes(4, "little")
        header += self.page_seq.to_bytes(4, "little")
        header += b"\x00\x00\x00\x00"  # CRC placeholder
        header.append(len(lacing))
        header += lacing
        page = bytes(header) + body
        crc = ogg_crc(page)
        return page[:22] + crc.to_bytes(4, "little") + page[26:]


def parse_page(data: bytes, offset: int = 0):
    """Parse one page at offset; returns (OggPage, lacing_values, next_offset)
    or None if incomplete/invalid."""
    if len(data) - offset < 27 or data[offset: offset + 4] != b"OggS":
        return None
    o = offset
    version = data[o + 4]
    header_type = data[o + 5]
    granule = int.from_bytes(data[o + 6: o + 14], "little", signed=True)
    serial = int.from_bytes(data[o + 14: o + 18], "little")
    seq = int.from_bytes(data[o + 18: o + 22], "little")
    crc_stored = int.from_bytes(data[o + 22: o + 26], "little")
    nsegs = data[o + 26]
    if len(data) - o < 27 + nsegs:
        return None
    lacing = list(data[o + 27: o + 27 + nsegs])
    body_len = sum(lacing)
    body_start = o + 27 + nsegs
    if len(data) - body_start < body_len:
        return None
    raw = bytearray(data[o: body_start + body_len])
    raw[22:26] = b"\x00\x00\x00\x00"
    if ogg_crc(bytes(raw)) != crc_stored:
        return None
    page = OggPage(version=version, header_type=header_type,
                   granule_pos=granule, serial=serial, page_seq=seq)
    body = data[body_start: body_start + body_len]
    pos = 0
    segs = []
    for lv in lacing:
        segs.append(body[pos: pos + lv])
        pos += lv
    page.segments = segs
    return page, lacing, body_start + body_len


class OggStreamWriter:
    """Packetizes packets into pages for one logical stream."""

    def __init__(self, serial: int):
        self.serial = serial
        self.page_seq = 0
        self._pending: list[tuple[bytes, int]] = []  # (packet, granule)

    def _emit(self, packets, granule, header_type) -> bytes:
        page = OggPage(header_type=header_type, granule_pos=granule,
                       serial=self.serial, page_seq=self.page_seq)
        segs = []
        for pkt in packets:
            # split into 255-byte segments with a final short segment
            i = 0
            while True:
                seg = pkt[i: i + 255]
                segs.append(seg)
                i += 255
                if len(seg) < 255:
                    break
        page.segments = segs
        self.page_seq += 1
        return page.serialize()

    def page_out(self, packets: list[bytes], granule: int,
                 bos: bool = False, eos: bool = False) -> bytes:
        ht = (2 if bos else 0) | (4 if eos else 0)
        return self._emit(packets, granule, ht)


class OggStreamReader:
    """Reassembles packets from a byte stream (handles continued packets)."""

    def __init__(self, data: bytes):
        self.data = data
        self.offset = 0
        self._partial = b""
        self._queue: list[tuple[bytes, int]] = []  # (packet, granule)
        self.serial = None

    def reset(self) -> None:
        """Rewind to the start of the stream (for seeking)."""
        self.offset = 0
        self._partial = b""
        self._queue = []
        self.serial = None

    def next_packet(self):
        """Returns (packet_bytes, granule_of_page) or None at end."""
        while not self._queue:
            # find next page
            idx = self.data.find(b"OggS", self.offset)
            if idx < 0:
                return None
            parsed = parse_page(self.data, idx)
            if parsed is None:
                self.offset = idx + 4
                continue
            page, lacing, nxt = parsed
            self.offset = nxt
            if self.serial is None:
                self.serial = page.serial
            if page.serial != self.serial:
                continue
            if not page.continued:
                self._partial = b""
            body_pos = 0
            acc = self._partial
            for lv, seg in zip(lacing, page.segments):
                acc += seg
                if lv < 255:
                    self._queue.append((acc, page.granule_pos))
                    acc = b""
            self._partial = acc
        return self._queue.pop(0)


# --- Ogg Opus (RFC 7845) headers ----------------------------------------

def opus_head(channels: int, preskip: int = 312, input_rate: int = 48000,
              gain_q8: int = 0) -> bytes:
    out = bytearray(b"OpusHead")
    out.append(1)
    out.append(channels)
    out += preskip.to_bytes(2, "little")
    out += input_rate.to_bytes(4, "little")
    out += gain_q8.to_bytes(2, "little", signed=True)
    out.append(0)  # mapping family 0
    return bytes(out)


def opus_tags(vendor: str = "mousiki_tpu", comments: list[str] | None = None) -> bytes:
    out = bytearray(b"OpusTags")
    v = vendor.encode()
    out += len(v).to_bytes(4, "little") + v
    comments = comments or []
    out += len(comments).to_bytes(4, "little")
    for c in comments:
        cb = c.encode()
        out += len(cb).to_bytes(4, "little") + cb
    return bytes(out)


def parse_opus_tags(data: bytes) -> dict:
    """Parse an OpusTags packet -> {vendor, comments} (RFC 7845 §5.2)."""
    if data[:8] != b"OpusTags":
        raise ValueError("not an OpusTags packet")
    pos = 8
    (vlen,) = _unpack("<I", data, pos)
    pos += 4
    vendor = data[pos: pos + vlen].decode("utf-8", "replace")
    pos += vlen
    (n,) = _unpack("<I", data, pos)
    pos += 4
    comments = []
    for _ in range(n):
        (clen,) = _unpack("<I", data, pos)
        pos += 4
        comments.append(data[pos: pos + clen].decode("utf-8", "replace"))
        pos += clen
    return {"vendor": vendor, "comments": comments}


def _unpack(fmt, data, pos):
    import struct
    return struct.unpack_from(fmt, data, pos)


def parse_opus_head(data: bytes) -> dict:
    if data[:8] != b"OpusHead":
        raise ValueError("not an OpusHead")
    return {
        "version": data[8],
        "channels": data[9],
        "preskip": int.from_bytes(data[10:12], "little"),
        "input_rate": int.from_bytes(data[12:16], "little"),
        "gain_q8": int.from_bytes(data[16:18], "little", signed=True),
        "mapping_family": data[18],
    }
