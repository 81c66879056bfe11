"""Repacketizer: merge/split Opus frames across packets, pad/unpad.

Parity: reference src/repacketizer.rs (OpusRepacketizer:60, cat:165,
out_range:438, opus_packet_pad/unpad:470,550); byte-level behavior matched
against libopus (code selection, padding length chains).
"""

from __future__ import annotations

from .packet import (InvalidPacket, packet_get_nb_frames, parse_packet,
                     samples_per_frame)


def _enc_size(n: int) -> bytes:
    if n < 252:
        return bytes([n])
    b0 = 252 + (n & 0x3)
    return bytes([b0, (n - b0) >> 2])


class Repacketizer:
    def __init__(self):
        self.reset()

    def reset(self):
        self.toc = 0
        self.nb_frames = 0
        self.frames: list[bytes] = []
        self.framesize = 0

    def cat(self, data: bytes, self_delimited: bool = False) -> None:
        """Append the frames of `data`; all packets must share config."""
        if len(data) < 1:
            raise InvalidPacket("empty packet")
        if self.nb_frames == 0:
            self.toc = data[0]
            self.framesize = samples_per_frame(data, 8000)
        elif (self.toc & 0xFC) != (data[0] & 0xFC):
            raise InvalidPacket("incompatible TOC")
        curr_nb = packet_get_nb_frames(data)
        if (curr_nb + self.nb_frames) * self.framesize > 960:  # 120 ms
            raise InvalidPacket("too much audio")
        parsed = parse_packet(data, self_delimited=self_delimited)
        self.frames.extend(parsed.frames)
        self.nb_frames += len(parsed.frames)

    def get_nb_frames(self) -> int:
        return self.nb_frames

    def out_range(self, begin: int, end: int, maxlen: int = 65535,
                  self_delimited: bool = False, pad: bool = False,
                  pad_content: bytes | None = None) -> bytes:
        """pad_content: bytes to place in the code-3 padding region
        (extension data per the Opus extension format) instead of zeros;
        implies pad=True and sizes the padding to fit exactly."""
        if pad_content is not None:
            pad = True
        if not (0 <= begin < end <= self.nb_frames):
            raise InvalidPacket("bad range")
        frames = self.frames[begin:end]
        count = len(frames)
        out = bytearray()
        all_equal = all(len(f) == len(frames[0]) for f in frames)

        if count == 1 and not pad:
            out.append((self.toc & 0xFC) | 0)
            if self_delimited:
                out += _enc_size(len(frames[0]))
            out += frames[0]
        elif count == 2 and all_equal and not pad:
            out.append((self.toc & 0xFC) | 1)
            if self_delimited:
                out += _enc_size(len(frames[1]))
            out += frames[0] + frames[1]
        elif count == 2 and not all_equal and not pad:
            out.append((self.toc & 0xFC) | 2)
            out += _enc_size(len(frames[0]))
            if self_delimited:
                out += _enc_size(len(frames[1]))
            out += frames[0] + frames[1]
        else:
            # code 3 (always used when padding is requested)
            out.append((self.toc & 0xFC) | 3)
            ch = count | (0 if all_equal else 0x80)
            out.append(ch)
            body = bytearray()
            if not all_equal:
                for f in frames[:-1]:
                    body += _enc_size(len(f))
            if self_delimited:
                body += _enc_size(len(frames[-1]))
            for f in frames:
                body += f
            if pad:
                if pad_content is not None:
                    # choose pad_amount so the content area is exactly
                    # len(pad_content): amount = chain bytes + content
                    cl = len(pad_content)
                    pad_amount = cl + 1
                    while ((pad_amount - 1) // 255 + 1 + cl) != pad_amount:
                        pad_amount += 1
                else:
                    pad_amount = maxlen - (2 + len(body))
                if pad_amount < 0:
                    raise InvalidPacket("too large")
                if pad_amount > 0:
                    out[1] |= 0x40
                    nb_255s = (pad_amount - 1) // 255
                    pad_hdr = bytes([255] * nb_255s
                                    + [pad_amount - 255 * nb_255s - 1])
                    content = (pad_content if pad_content is not None
                               else b"\x00" * (pad_amount - nb_255s - 1))
                    body = bytearray(pad_hdr) + body + content
            out += body
        if len(out) > maxlen:
            raise InvalidPacket("too large")
        return bytes(out)

    def out(self, maxlen: int = 65535) -> bytes:
        return self.out_range(0, self.nb_frames, maxlen)


def opus_packet_pad(data: bytes, new_len: int) -> bytes:
    """Pad a packet to exactly new_len bytes (libopus scheme: convert to
    code 3, add the padding chain only when more than one byte is needed)."""
    if new_len < len(data):
        raise InvalidPacket("new_len too small")
    if new_len == len(data):
        return data
    rp = Repacketizer()
    rp.cat(data)
    return rp.out_range(0, rp.nb_frames, new_len, pad=True)


def opus_packet_unpad(data: bytes) -> bytes:
    """Remove padding, re-emitting the most compact framing."""
    if len(data) < 1:
        raise InvalidPacket("short")
    rp = Repacketizer()
    rp.cat(data)
    return rp.out_range(0, rp.nb_frames, len(data))


def opus_packet_pad_ext(data: bytes, ext_blob: bytes,
                        maxlen: int = 65535) -> bytes:
    """Re-emit `data` as a code-3 packet whose padding region carries
    `ext_blob` (Opus extension format data, e.g. a DRED payload wrapped
    by extensions_generate). Reference: repacketizer.rs out_range_impl's
    extension path used by the DRED encoder (opus_encoder.rs:1666)."""
    rp = Repacketizer()
    rp.cat(data)
    return rp.out_range(0, rp.nb_frames, maxlen, pad_content=ext_blob)


def opus_multistream_packet_pad(data: bytes, new_len: int,
                                nb_streams: int) -> bytes:
    """Pad a multistream packet to exactly new_len bytes.

    Parity: reference src/repacketizer.rs opus_multistream_packet_pad:572
    — the first nb_streams-1 self-delimited packets pass through
    unchanged; all padding goes into the final (regular) packet.
    """
    if len(data) < 1 or new_len < len(data):
        raise InvalidPacket("bad length")
    if new_len == len(data):
        return data
    offset = 0
    for _ in range(max(0, nb_streams - 1)):
        if offset >= len(data):
            raise InvalidPacket("truncated multistream packet")
        parsed = parse_packet(data[offset:], self_delimited=True)
        offset += parsed.packet_offset
    last_new = (len(data) - offset) + (new_len - len(data))
    return data[:offset] + opus_packet_pad(data[offset:], last_new)


def opus_multistream_packet_unpad(data: bytes, nb_streams: int) -> bytes:
    """Strip padding from every stream's packet inside a multistream
    packet, re-emitting the most compact framing.

    Parity: reference src/repacketizer.rs opus_multistream_packet_unpad:605.
    """
    if len(data) < 1:
        raise InvalidPacket("short")
    out = bytearray()
    offset = 0
    for stream in range(nb_streams):
        self_delimited = stream + 1 != nb_streams
        if offset >= len(data):
            raise InvalidPacket("truncated multistream packet")
        parsed = parse_packet(data[offset:], self_delimited=self_delimited)
        chunk = data[offset:offset + parsed.packet_offset]
        rp = Repacketizer()
        rp.cat(chunk, self_delimited=self_delimited)
        out += rp.out_range(0, rp.nb_frames,
                            maxlen=len(data) - len(out),
                            self_delimited=self_delimited)
        offset += parsed.packet_offset
    return bytes(out)
