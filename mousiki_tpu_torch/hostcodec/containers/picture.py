"""METADATA_BLOCK_PICTURE parsing (opus_picture_tag_parse equivalent).

Parity: reference `src/opusfile/picture.rs` — base64-encoded FLAC picture
blocks carried in OpusTags comments, with JPEG/PNG/GIF signature sniffing
and header-derived dimensions overriding the declared ones. The reference
rejects picture_type 1 (file icon) unless it is a 32x32 PNG.
"""

from __future__ import annotations

import base64
import binascii
import struct
from dataclasses import dataclass, field

FORMAT_UNKNOWN = "unknown"
FORMAT_URL = "url"
FORMAT_JPEG = "jpeg"
FORMAT_PNG = "png"
FORMAT_GIF = "gif"


@dataclass
class OpusPictureTag:
    picture_type: int = 0
    mime_type: bytes = b""
    description: bytes = b""
    width: int = 0
    height: int = 0
    depth: int = 0
    colors: int = 0
    data: bytes = b""
    format: str = FORMAT_UNKNOWN

    @classmethod
    def parse(cls, tag) -> "OpusPictureTag":
        if isinstance(tag, str):
            tag = tag.encode()
        if tag[:23].upper() == b"METADATA_BLOCK_PICTURE=":
            tag = tag[23:]
        if len(tag) % 4 != 0 or len(tag) < 44:  # 32 decoded bytes minimum
            raise ValueError("not a picture tag")
        try:
            block = base64.b64decode(tag, validate=True)
        except (binascii.Error, ValueError) as e:
            raise ValueError("bad base64 in picture tag") from e
        if len(block) < 32:
            raise ValueError("picture block too short")
        return _parse_block(block)


def _u32(b, pos):
    return struct.unpack_from(">I", b, pos)[0]


def _parse_block(block: bytes) -> OpusPictureTag:
    pos = 0
    ptype = _u32(block, pos); pos += 4
    mlen = _u32(block, pos); pos += 4
    if mlen > len(block) - 32:
        raise ValueError("mime length out of range")
    mime = block[pos: pos + mlen]; pos += mlen
    dlen = _u32(block, pos); pos += 4
    if dlen > len(block) - mlen - 32:
        raise ValueError("description length out of range")
    desc = block[pos: pos + dlen]; pos += dlen
    width, height, depth, colors = (_u32(block, pos), _u32(block, pos + 4),
                                    _u32(block, pos + 8), _u32(block, pos + 12))
    pos += 16
    if (width == 0 or height == 0 or depth == 0) and (
            width or height or depth or colors):
        raise ValueError("inconsistent declared dimensions")
    nbytes = _u32(block, pos); pos += 4
    if nbytes > len(block) - pos:
        raise ValueError("picture data out of range")
    data = block[pos: pos + nbytes]

    if mime == b"-->":
        # URL "picture": no format sniffing; icons may only be 32x32
        if ptype == 1 and (width or height) and (width, height) != (32, 32):
            raise ValueError("file icon must be 32x32")
        fmt, extracted = FORMAT_URL, None
    else:
        fmt = _sniff_format(mime, data)
        extracted = {FORMAT_JPEG: _jpeg_params, FORMAT_PNG: _png_params,
                     FORMAT_GIF: _gif_params}.get(fmt, lambda d: None)(data)
        if ptype == 1:
            w, h = (extracted or (width, height, 0, 0))[:2]
            if fmt != FORMAT_PNG or w != 32 or h != 32:
                raise ValueError("file icon must be a 32x32 PNG")
    if extracted:
        width, height, depth, colors = extracted
    return OpusPictureTag(ptype, mime, desc, width, height, depth, colors,
                          data, fmt)


def _sniff_format(mime: bytes, data: bytes) -> str:
    m = mime.lower()
    if m == b"image/jpeg":
        return FORMAT_JPEG if _is_jpeg(data) else FORMAT_UNKNOWN
    if m == b"image/png":
        return FORMAT_PNG if _is_png(data) else FORMAT_UNKNOWN
    if m == b"image/gif":
        return FORMAT_GIF if _is_gif(data) else FORMAT_UNKNOWN
    if m in (b"", b"image/"):
        for fmt, test in ((FORMAT_JPEG, _is_jpeg), (FORMAT_PNG, _is_png),
                          (FORMAT_GIF, _is_gif)):
            if test(data):
                return fmt
    return FORMAT_UNKNOWN


def _is_jpeg(d):
    return len(d) >= 3 and d[:3] == b"\xff\xd8\xff"


def _is_png(d):
    return d[:8] == b"\x89PNG\r\n\x1a\n"


def _is_gif(d):
    return d[:6] in (b"GIF87a", b"GIF89a")


def _jpeg_params(d):
    """Walk JPEG markers to the first SOFn frame header -> (w, h, depth, 0)."""
    if not _is_jpeg(d):
        return None
    pos = 2
    while True:
        while pos < len(d) and d[pos] != 0xFF:
            pos += 1
        while pos < len(d) and d[pos] == 0xFF:
            pos += 1
        if pos >= len(d):
            return None
        marker = d[pos]
        pos += 1
        if pos >= len(d) or 0xD8 <= marker <= 0xDA:
            return None
        if 0xD0 <= marker <= 0xD7:  # restart markers have no payload
            continue
        if len(d) - pos < 2:
            return None
        seg = struct.unpack_from(">H", d, pos)[0]
        if seg < 2 or len(d) - pos < seg:
            return None
        if marker == 0xC0 or (0xC0 < marker < 0xD0 and marker & 3):
            if seg < 8:
                return None
            h, w = struct.unpack_from(">HH", d, pos + 3)
            return (w, h, d[pos + 2] * d[pos + 7], 0)
        pos += seg


def _png_params(d):
    """IHDR dimensions/bit depth; palette images report the PLTE size."""
    if not _is_png(d):
        return None
    width = height = depth = colors = 0
    palette = False
    pos = 8
    while len(d) - pos >= 12:
        clen = _u32(d, pos)
        if clen > len(d) - pos - 12:
            break
        ctype = d[pos + 4: pos + 8]
        if clen == 13 and ctype == b"IHDR":
            width, height = _u32(d, pos + 8), _u32(d, pos + 12)
            bit_depth, color_type = d[pos + 16], d[pos + 17]
            if color_type == 3:
                depth, palette = 24, True
            else:
                depth = bit_depth * {0: 1, 2: 3, 4: 2, 6: 4}.get(color_type, 0)
                break
        elif palette and ctype == b"PLTE":
            colors = clen // 3
            break
        pos += 12 + clen
    if width and height and depth:
        return (width, height, depth, colors)
    return None


def _gif_params(d):
    if not _is_gif(d) or len(d) < 14:
        return None
    w, h = struct.unpack_from("<HH", d, 6)
    return (w, h, 24, 1 << ((d[10] & 7) + 1))


def picture_from_tags(comments) -> list:
    """Extract every parseable METADATA_BLOCK_PICTURE from a comment list."""
    out = []
    for c in comments:
        cb = c.encode() if isinstance(c, str) else c
        if cb[:23].upper() == b"METADATA_BLOCK_PICTURE=":
            try:
                out.append(OpusPictureTag.parse(cb))
            except ValueError:
                pass
    return out
