"""Ogg Opus file read/write (opusfile + libopusenc equivalents).

Parity targets: reference `src/opusfile/` (whole-file decode, seek, tags)
and `src/libopusenc/` (Ogg muxing, headers); RFC 7845 framing.
"""

from __future__ import annotations

import numpy as np

from .ogg import (OggStreamReader, OggStreamWriter, opus_head, opus_tags,
                  parse_opus_head, parse_opus_tags, parse_page)


class OggOpusWriter:
    """Minimal libopusenc equivalent: packets -> .opus byte stream."""

    def __init__(self, channels: int, preskip: int = 312, serial: int = 0x6d6b74,
                 vendor: str = "mousiki_tpu", comments=None,
                 input_rate: int = 48000):
        self.channels = channels
        self.preskip = preskip
        self.writer = OggStreamWriter(serial)
        self.pages = [
            self.writer.page_out([opus_head(channels, preskip, input_rate)],
                                 0, bos=True),
            self.writer.page_out([opus_tags(vendor, comments)], 0),
        ]
        self.granule = preskip
        self._pending: list[bytes] = []
        self._pending_samples = 0

    def write_packet(self, packet: bytes, samples_48k: int,
                     flush: bool = False) -> None:
        self._pending.append(packet)
        self._pending_samples += samples_48k
        # one page per ~1s of audio or 50 packets
        if flush or self._pending_samples >= 48000 or len(self._pending) >= 50:
            self._flush_page(False)

    def _flush_page(self, eos: bool) -> None:
        if not self._pending and not eos:
            return
        self.granule += self._pending_samples
        self.pages.append(self.writer.page_out(self._pending, self.granule,
                                               eos=eos))
        self._pending = []
        self._pending_samples = 0

    def finish(self) -> bytes:
        self._flush_page(True)
        return b"".join(self.pages)


class OggOpusReader:
    """Minimal opusfile equivalent: .opus bytes -> packets / decoded PCM."""

    def __init__(self, data: bytes):
        self.stream = OggStreamReader(data)
        head_pkt = self.stream.next_packet()
        if head_pkt is None:
            raise ValueError("no OpusHead")
        self.head = parse_opus_head(head_pkt[0])
        tags_pkt = self.stream.next_packet()
        self.tags_raw = tags_pkt[0] if tags_pkt else b""
        self.channels = self.head["channels"]
        self.preskip = self.head["preskip"]

    def packets(self):
        while True:
            p = self.stream.next_packet()
            if p is None:
                return
            yield p

    def decode_all(self, decoder=None) -> np.ndarray:
        """Decode the whole stream to float PCM at 48 kHz."""
        from ..bitstream.packet import packet_get_nb_samples
        from ..opus_decoder import OpusDecoder

        dec = decoder or OpusDecoder(48000, self.channels)
        out = []
        for pkt, _gran in self.packets():
            n = packet_get_nb_samples(pkt, 48000)
            out.append(dec.decode(pkt, n))
        if not out:
            return np.zeros((0, self.channels))
        pcm = np.concatenate(out)
        gain = self.head["gain_q8"]
        if gain:
            pcm = pcm * (10.0 ** (gain / (20.0 * 256.0)))
        return pcm[self.preskip:]

    # -- seeking (opusfile pcm_seek parity, reader.rs:275-293) ------------
    def pcm_total(self) -> int:
        """Total 48 kHz samples after preskip (scans granule positions)."""
        last = 0
        for _pkt, gran in self.packets():
            if gran is not None and gran > 0:
                last = gran
        self.stream.reset()
        self.stream.next_packet()  # head
        self.stream.next_packet()  # tags
        return max(0, last - self.preskip)

    def pcm_seek(self, target: int, decoder=None):
        """Seek to an absolute 48 kHz sample offset (post-preskip domain).

        Rewinds, skips packets whose page granule ends before the target,
        re-primes the decoder with up to 200 ms of preroll (the reference
        decodes ahead after a raw seek to rebuild state), and returns a
        decoder positioned so the next decoded sample is `target`; also
        returns the number of samples to trim from the first decode."""
        from ..bitstream.packet import packet_get_nb_samples
        from ..opus_decoder import OpusDecoder

        dec = decoder or OpusDecoder(48000, self.channels)
        target_abs = target + self.preskip
        self.stream.reset()
        self.stream.next_packet()  # head
        self.stream.next_packet()  # tags

        # collect packets with running sample offsets
        entries = []
        pos = 0
        for pkt, _gran in self.packets():
            n = packet_get_nb_samples(pkt, 48000)
            entries.append((pos, n, pkt))
            pos += n
        # find the packet containing the target; preroll (state re-prime)
        idx = 0
        for i, (p0, n, _pkt) in enumerate(entries):
            if p0 + n > target_abs:
                idx = i
                break
        else:
            idx = max(0, len(entries) - 1)
        start = max(0, idx - 10)
        for p0, n, pkt in entries[start:idx]:
            dec.decode(pkt, n)
        trim = target_abs - entries[idx][0] if entries else 0
        self._seek_entries = entries[idx:]
        return dec, trim

    def read_from(self, target: int, n_samples: int, decoder=None) -> np.ndarray:
        """Seek + decode n_samples at `target` (post-preskip 48 kHz)."""
        dec, trim = self.pcm_seek(target, decoder)
        out = []
        got = -trim
        for _p0, n, pkt in self._seek_entries:
            out.append(dec.decode(pkt, n))
            got += n
            if got >= n_samples:
                break
        if not out:
            return np.zeros((0, self.channels))
        pcm = np.concatenate(out)[trim: trim + n_samples]
        gain = self.head["gain_q8"]
        if gain:
            pcm = pcm * (10.0 ** (gain / (20.0 * 256.0)))
        return pcm


class _Link:
    """One logical stream of a (possibly chained) Ogg Opus file."""

    def __init__(self, serial: int, head: dict):
        self.serial = serial
        self.head = head
        self.tags_raw = b""
        self.packets: list[tuple[bytes, int | None]] = []
        self.last_granule = 0
        self._partial = b""
        self._n_header_pkts = 0

    def pcm_total(self) -> int:
        return max(0, self.last_granule - self.head["preskip"])


class OpusFile:
    """Chained/multiplexed-aware opusfile equivalent (reader.rs OpusFile).

    A chained file is several complete Ogg Opus streams concatenated
    (reader.rs link scan); a multiplexed file interleaves pages of other
    serial numbers, which are skipped. Exposes the per-link query surface
    (link_count/serialno/channel_count/pcm_total/head/tags) and decoding
    that advances across link boundaries with a fresh decoder + preskip
    per link (reader.rs:908-925 chained_files_advance_across_links)."""

    def __init__(self, data: bytes):
        self.links: list[_Link] = []
        self._scan(data)
        if not self.links:
            raise ValueError("no Ogg Opus stream found")

    def _scan(self, data: bytes):
        by_serial: dict[int, _Link] = {}
        ended: set[int] = set()
        offset = 0
        in_bos_cluster = False
        while True:
            idx = data.find(b"OggS", offset)
            if idx < 0:
                return
            parsed = parse_page(data, idx)
            if parsed is None:
                offset = idx + 4
                continue
            page, lacing, offset = parsed
            link = by_serial.get(page.serial)
            if page.bos:
                # a new logical stream; in a multiplexed segment all BOS
                # pages come first and only the first Opus stream is the
                # link (opusfile picks the first it encounters)
                body = b"".join(page.segments)
                if body[:8] == b"OpusHead" and not in_bos_cluster:
                    link = _Link(page.serial, parse_opus_head(body))
                    link._n_header_pkts = 1
                    self.links.append(link)
                    # a new chain segment obsoletes previous serials
                    by_serial = {page.serial: link}
                    ended.discard(page.serial)
                in_bos_cluster = True
                continue
            in_bos_cluster = False
            if link is None or page.serial in ended:
                continue  # multiplexed foreign stream (or stale serial)
            if not page.continued:
                link._partial = b""
            acc = link._partial
            for lv, seg in zip(lacing, page.segments):
                acc += seg
                if lv < 255:
                    if link._n_header_pkts == 1:
                        link.tags_raw = acc
                        link._n_header_pkts = 2
                    else:
                        link.packets.append((acc, page.granule_pos))
                    acc = b""
            link._partial = acc
            if page.granule_pos not in (None, -1, 0xFFFFFFFFFFFFFFFF):
                link.last_granule = max(link.last_granule, page.granule_pos)
            if page.eos:
                ended.add(page.serial)

    # -- query surface (reader.rs:222-260) -------------------------------
    @property
    def link_count(self) -> int:
        return len(self.links)

    def serialno(self, link: int = 0) -> int:
        return self.links[link].serial

    def channel_count(self, link: int = 0) -> int:
        return self.links[link].head["channels"]

    def head(self, link: int = 0) -> dict:
        return self.links[link].head

    def tags(self, link: int = 0) -> dict:
        raw = self.links[link].tags_raw
        return parse_opus_tags(raw) if raw[:8] == b"OpusTags" else {
            "vendor": "", "comments": []}

    def pictures(self, link: int = 0) -> list:
        from .picture import picture_from_tags
        return picture_from_tags(self.tags(link)["comments"])

    def pcm_total(self, link: int | None = None) -> int:
        if link is not None:
            return self.links[link].pcm_total()
        return sum(li.pcm_total() for li in self.links)

    # -- decoding ---------------------------------------------------------
    def decode_all(self) -> np.ndarray:
        """Decode every link to (N, 2) stereo float PCM at 48 kHz
        (read_float_stereo semantics: mono links are mirrored to stereo)."""
        from ..bitstream.packet import packet_get_nb_samples
        from ..opus_decoder import OpusDecoder

        from ..bitstream.packet import OpusError

        chunks = []
        for li in self.links:
            ch = li.head["channels"]
            dec = OpusDecoder(48000, ch)
            out = []
            for pkt, _g in li.packets:
                try:
                    n = packet_get_nb_samples(pkt, 48000)
                    out.append(dec.decode(pkt, n))
                except (OpusError, ValueError):
                    continue  # skip undecodable packets (OP_EBADPACKET)
            if not out:
                continue
            pcm = np.concatenate(out)
            gain = li.head["gain_q8"]
            if gain:
                pcm = pcm * (10.0 ** (gain / (20.0 * 256.0)))
            pcm = pcm[li.head["preskip"]:]
            if li.last_granule:
                pcm = pcm[: li.pcm_total()]
            if ch == 1:
                pcm = np.repeat(pcm, 2, axis=1)
            chunks.append(pcm[:, :2])
        if not chunks:
            return np.zeros((0, 2))
        return np.concatenate(chunks)

    def read_float_stereo(self) -> np.ndarray:
        """reader.rs:405 read_float_stereo: whole file as (N, 2) float."""
        return self.decode_all()

    def read_stereo(self) -> np.ndarray:
        """reader.rs read_stereo: whole file as (N, 2) int16 with the
        float build's soft-clip semantics on overload."""
        from ..softclip import opus_pcm_soft_clip

        pcm = self.decode_all()
        pcm = opus_pcm_soft_clip(pcm, np.zeros(pcm.shape[1] or 2))
        return np.clip(np.rint(pcm * 32768.0), -32768,
                       32767).astype(np.int16)


class OpusEnc:
    """libopusenc equivalent: arbitrary-rate PCM in -> .opus bytes out.

    Parity: reference src/libopusenc/encoder.rs (ope_encoder_create +
    write + drain): input at any rate is brought to 48 kHz by the
    polyphase Kaiser resampler (ops/input_resampler.py, the speex
    front-end equivalent), chunked into 20 ms frames, Opus-encoded, and
    Ogg-muxed with the resampler+codec delay recorded as preskip."""

    def __init__(self, rate: int, channels: int, bitrate: int = 96000,
                 comments=None, quality: int = 5, serial: int = 0x6d6b74):
        from ..opus_encoder import APP_AUDIO, OpusEncoder
        from ..ops.input_resampler import ArbitraryResampler

        self.rate = rate
        self.channels = channels
        self.enc = OpusEncoder(48000, channels, APP_AUDIO)
        self.enc.set_bitrate(bitrate)
        self.rs = None if rate == 48000 else ArbitraryResampler(
            rate, 48000, channels, quality)
        preskip = 312 + (self.rs.output_latency if self.rs else 0)
        self.writer = OggOpusWriter(channels, preskip=preskip, serial=serial,
                                    comments=comments, input_rate=rate)
        self._pcm = np.zeros((0, channels))

    def write(self, pcm: np.ndarray) -> None:
        """Feed float PCM (n, channels) at the input rate."""
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        x = self.rs.process(pcm) if self.rs else pcm
        self._pcm = np.concatenate([self._pcm, x], axis=0)
        while self._pcm.shape[0] >= 960:
            frame, self._pcm = self._pcm[:960], self._pcm[960:]
            self.writer.write_packet(self.enc.encode(frame, 960), 960)

    def drain_pages(self) -> bytes:
        """Pull-style API (libopusenc OggOpusEncoder pull variant,
        encoder.rs:376): return the Ogg pages completed so far and clear
        them, so callers can stream the file out incrementally."""
        done = b"".join(self.writer.pages)
        self.writer.pages = []
        return done

    def finish(self) -> bytes:
        """Flush (zero-padding the last partial frame) and emit the file.

        After drain_pages() calls, returns only the not-yet-drained tail."""
        tail = self._pcm.shape[0]
        if tail:
            frame = np.concatenate(
                [self._pcm, np.zeros((960 - tail, self.channels))], axis=0)
            self.writer.write_packet(self.enc.encode(frame, 960), 960)
            self._pcm = self._pcm[:0]
        return self.writer.finish()
