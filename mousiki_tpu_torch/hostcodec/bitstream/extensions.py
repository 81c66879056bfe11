"""Opus packet extensions (ids 0-127, carried in padding; DRED's transport).

Parity: reference src/extensions.rs (OpusExtensionIterator:119, parse:410,
generate:544). The parser implements the full format including frame
separators (id 1), repeat indicators (id 2), short (id 3-31) and long
(id 32-127) extensions. The generator emits the straightforward
separator-based encoding (no repeat compression yet — output is always
valid and parses back identically; compactness optimization is follow-up).
"""

from __future__ import annotations

from dataclasses import dataclass

MAX_FRAMES_PER_PACKET = 48


class ExtensionError(Exception):
    pass


@dataclass
class ExtensionData:
    id: int
    frame: int
    data: bytes


def _skip_payload(data, pos, length, trailing_short_len, id_byte):
    """Advance past one extension's payload; returns (pos, len, header_size)."""
    header_size = 0
    ext_id = id_byte >> 1
    l_flag = id_byte & 1
    if (ext_id == 0 and l_flag == 1) or ext_id == 2:
        return pos, length, header_size
    if 0 < ext_id < 32:
        need = l_flag
        if length < need:
            raise ExtensionError("invalid")
        return pos + need, length - need, header_size
    if l_flag == 0:
        if length < trailing_short_len:
            raise ExtensionError("invalid")
        advance = length - trailing_short_len
        return pos + advance, trailing_short_len, header_size
    total = 0
    while True:
        if length < 1 or pos >= len(data):
            raise ExtensionError("invalid")
        lacing = data[pos]
        pos += 1
        header_size += 1
        length -= 1
        total += lacing
        length -= lacing
        if length < 0:
            raise ExtensionError("invalid")
        if lacing != 255:
            break
    if total > len(data) - pos:
        raise ExtensionError("invalid")
    return pos + total, length, header_size


def _skip_extension(data, pos, length):
    if length == 0:
        return pos, 0, 0
    if length < 1 or pos >= len(data):
        raise ExtensionError("invalid")
    id_byte = data[pos]
    pos, length, hs = _skip_payload(data, pos + 1, length - 1, 0, id_byte)
    return pos, length, hs + 1


class ExtensionIterator:
    """Iterate the extensions in a padding blob (reference iterator parity)."""

    def __init__(self, data: bytes, nb_frames: int):
        self.data = data
        self.nb_frames = nb_frames
        self.reset()

    def reset(self):
        self.curr_pos = 0
        self.repeat_start = 0
        self.last_long = None
        self.src_pos = 0
        self.curr_len = len(self.data)
        self.repeat_len = 0
        self.src_len = 0
        self.trailing_short_len = 0
        self.frame_max = self.nb_frames
        self.curr_frame = 0
        self.repeat_frame = 0
        self.repeat_l = 0

    def _next_repeat(self):
        assert self.repeat_frame > 0
        while self.repeat_frame < self.nb_frames:
            while self.src_len > 0:
                repeat_id_byte = self.data[self.src_pos]
                self.src_pos, self.src_len, _ = _skip_extension(
                    self.data, self.src_pos, self.src_len)
                if repeat_id_byte <= 3:
                    continue
                adj = repeat_id_byte
                if (self.repeat_l == 0
                        and self.repeat_frame + 1 >= self.nb_frames
                        and self.src_pos == self.last_long):
                    adj &= ~1
                curr_start = self.curr_pos
                self.curr_pos, self.curr_len, hs = _skip_payload(
                    self.data, self.curr_pos, self.curr_len,
                    self.trailing_short_len, adj)
                if self.curr_len < 0:
                    raise ExtensionError("invalid")
                if self.repeat_frame >= self.frame_max:
                    continue
                payload_start = curr_start + hs
                if payload_start > self.curr_pos:
                    raise ExtensionError("invalid")
                return ExtensionData(adj >> 1, self.repeat_frame,
                                     self.data[payload_start: self.curr_pos])
            self.src_pos = self.repeat_start
            self.src_len = self.repeat_len
            self.repeat_frame += 1
        self.repeat_start = self.curr_pos
        self.last_long = None
        if self.repeat_l == 0:
            self.curr_frame += 1
            if self.curr_frame >= self.nb_frames:
                self.curr_len = 0
        self.repeat_frame = 0
        return None

    def next_extension(self):
        if self.curr_len < 0:
            raise ExtensionError("invalid")
        if self.repeat_frame > 0:
            ext = self._next_repeat()
            if ext is not None:
                return ext
        if self.curr_frame >= self.frame_max:
            return None
        while self.curr_len > 0:
            start = self.curr_pos
            id_byte = self.data[start]
            ext_id = id_byte >> 1
            l_flag = id_byte & 1
            self.curr_pos, self.curr_len, hs = _skip_extension(
                self.data, self.curr_pos, self.curr_len)
            if self.curr_len < 0:
                raise ExtensionError("invalid")
            if ext_id == 1:
                if l_flag == 0:
                    self.curr_frame += 1
                else:
                    incr = self.data[start + 1]
                    if incr == 0:
                        continue
                    self.curr_frame += incr
                if self.curr_frame >= self.nb_frames:
                    self.curr_len = -1
                    raise ExtensionError("invalid")
                if self.curr_frame >= self.frame_max:
                    self.curr_len = 0
                self.repeat_start = self.curr_pos
                self.last_long = None
                self.trailing_short_len = 0
            elif ext_id == 2:
                self.repeat_l = l_flag
                self.repeat_frame = self.curr_frame + 1
                self.repeat_len = start - self.repeat_start
                self.src_pos = self.repeat_start
                self.src_len = self.repeat_len
                ext = self._next_repeat()
                if ext is not None:
                    return ext
            elif ext_id > 2:
                if ext_id >= 32:
                    self.last_long = self.curr_pos
                    self.trailing_short_len = 0
                else:
                    self.trailing_short_len += l_flag
                if self.curr_frame >= self.frame_max:
                    continue
                data_start = start + hs
                if data_start > self.curr_pos:
                    raise ExtensionError("invalid")
                return ExtensionData(ext_id, self.curr_frame,
                                     self.data[data_start: self.curr_pos])
        return None

    def find(self, ext_id: int):
        while True:
            ext = self.next_extension()
            if ext is None:
                return None
            if ext.id == ext_id:
                return ext


def extensions_parse(data: bytes, nb_frames: int) -> list[ExtensionData]:
    it = ExtensionIterator(data, nb_frames)
    out = []
    while True:
        ext = it.next_extension()
        if ext is None:
            return out
        out.append(ext)


def extensions_count(data: bytes, nb_frames: int) -> int:
    return len(extensions_parse(data, nb_frames))


def extensions_generate(extensions: list[ExtensionData], nb_frames: int,
                        pad_to: int | None = None) -> bytes:
    """Serialize extensions (sorted into frame order) into a padding blob."""
    if nb_frames > MAX_FRAMES_PER_PACKET:
        raise ExtensionError("bad nb_frames")
    for ext in extensions:
        if not (3 <= ext.id <= 127):
            raise ExtensionError("bad id")
        if not (0 <= ext.frame < nb_frames):
            raise ExtensionError("bad frame")
        if ext.id < 32 and len(ext.data) > 1:
            raise ExtensionError("short extension payload > 1 byte")
    out = bytearray()
    curr_frame = 0
    ordered = sorted(range(len(extensions)), key=lambda i: extensions[i].frame)
    for rank, i in enumerate(ordered):
        ext = extensions[i]
        while curr_frame < ext.frame:
            delta = ext.frame - curr_frame
            if delta == 1:
                out.append(1 << 1)  # separator, L=0
                curr_frame += 1
            else:
                out.append((1 << 1) | 1)
                out.append(min(delta, 255))
                curr_frame += min(delta, 255)
        # With trailing padding, the last long extension cannot use the
        # implicit to-the-end form — it would swallow the pad bytes.
        is_last = rank == len(ordered) - 1 and pad_to is None
        if ext.id < 32:
            out.append((ext.id << 1) | (1 if len(ext.data) else 0))
            out += ext.data[:1]
        else:
            l_flag = 0 if is_last else 1
            out.append((ext.id << 1) | l_flag)
            if not is_last:
                n = len(ext.data)
                out += b"\xff" * (n // 255)
                out.append(n % 255)
            out += ext.data
    if pad_to is not None:
        if len(out) > pad_to:
            raise ExtensionError("does not fit")
        # id-0 long-form padding consumes the rest
        if len(out) < pad_to:
            out += b"\x01" * (pad_to - len(out))  # id 0, L=1: ignored bytes
    return bytes(out)
