"""Multistream (surround) Opus: N elementary streams + channel mapping.

Parity: reference src/opus_multistream.rs (decoder:953, encoder:1716) —
packets carry nb_streams elementary packets, all but the last in
self-delimited framing; `mapping[ch]` selects the decoded channel
(255 = silent). Coupled streams are stereo, the rest mono.
"""

from __future__ import annotations

import numpy as np

from .bitstream.packet import parse_packet
from .bitstream.repacketizer import _enc_size
from .opus_decoder import OpusDecoder
from .opus_encoder import OpusEncoder


DEFAULT_SURROUND = {
    1: (1, 0, [0]),
    2: (1, 1, [0, 1]),
    3: (2, 1, [0, 2, 1]),            # L C R -> stream0 L/R, stream1 C
    4: (2, 2, [0, 1, 2, 3]),
    5: (3, 2, [0, 4, 1, 2, 3]),
    6: (4, 2, [0, 4, 1, 2, 3, 5]),
    7: (4, 3, [0, 4, 1, 2, 3, 5, 6]),
    8: (5, 3, [0, 6, 1, 2, 3, 4, 5, 7]),
}


class MultistreamDecoder:
    def __init__(self, fs: int, channels: int, streams: int,
                 coupled_streams: int, mapping: list[int]):
        if not (0 < streams and 0 <= coupled_streams <= streams
                and len(mapping) == channels):
            raise ValueError("bad layout")
        self.fs = fs
        self.channels = channels
        self.streams = streams
        self.coupled = coupled_streams
        self.mapping = list(mapping)
        self.decoders = [OpusDecoder(fs, 2 if s < coupled_streams else 1)
                         for s in range(streams)]

    def decode(self, data: bytes | None, frame_size: int) -> np.ndarray:
        outs = []
        if data is None:
            for dec in self.decoders:
                outs.append(dec.decode(None, frame_size))
        else:
            pos = 0
            for s in range(self.streams):
                self_delim = s < self.streams - 1
                parsed = parse_packet(data[pos:], self_delimited=self_delim)
                # rebuild an ordinary packet for this stream's decoder
                sub = data[pos: pos + parsed.packet_offset]
                if self_delim:
                    sub = _strip_self_delim(sub, parsed)
                outs.append(self.decoders[s].decode(sub, frame_size))
                pos += parsed.packet_offset
        # channel mapping
        n = min(o.shape[0] for o in outs)
        result = np.zeros((n, self.channels))
        decoded_channels = []
        for s, o in enumerate(outs):
            decoded_channels.append(o[:n, 0])
            if s < self.coupled:
                decoded_channels.append(o[:n, 1])
        for ch, m in enumerate(self.mapping):
            if m != 255:
                result[:, ch] = decoded_channels[m]
        return result

    @property
    def final_range(self) -> int:
        r = 0
        for d in self.decoders:
            r ^= d.final_range
        return r & 0xFFFFFFFF


def _strip_self_delim(sub: bytes, parsed) -> bytes:
    """Convert a self-delimited elementary packet to regular framing."""
    # Re-emit: TOC + frames with standard framing
    frames = parsed.frames
    toc_code = sub[0] & 0x3
    out = bytearray([sub[0]])
    if toc_code == 0:
        out[0] = (sub[0] & 0xFC) | 0
        out += frames[0]
    elif len(frames) == 2 and len(frames[0]) == len(frames[1]):
        out[0] = (sub[0] & 0xFC) | 1
        out += frames[0] + frames[1]
    elif len(frames) == 2:
        out[0] = (sub[0] & 0xFC) | 2
        out += _enc_size(len(frames[0])) + frames[0] + frames[1]
    else:
        out[0] = (sub[0] & 0xFC) | 3
        out.append(0x80 | len(frames))
        for f in frames[:-1]:
            out += _enc_size(len(f))
        for f in frames:
            out += f
    return bytes(out)


def surround_rate_allocation(streams: int, coupled: int,
                             lfe_stream: int | None, bitrate_bps: int,
                             frame_size: int, fs: int) -> list[int]:
    """Per-stream bitrate split for surround layouts.

    Parity: reference opus_multistream.rs:407-470 surround_rate_allocation —
    each stream carries a fixed per-channel overhead (40 bits/frame/channel),
    the LFE gets a small capped share (ratio 32/256 of a channel plus a
    15 bits/frame offset), coupled streams weigh 2x a mono channel
    (ratio 512/256), and the remainder splits proportionally."""
    nb_lfe = 1 if lfe_stream is not None else 0
    nb_uncoupled = streams - coupled - nb_lfe
    nb_normal = 2 * coupled + nb_uncoupled
    if nb_normal <= 0:
        return [max(0, bitrate_bps // max(1, streams))] * streams
    frame_rate = max(50, fs // frame_size)
    channel_offset = 40 * frame_rate
    lfe_offset = min(bitrate_bps // 20, 3000) + 15 * frame_rate
    stream_offset = max(0, min(20000, (
        (bitrate_bps - channel_offset * nb_normal - lfe_offset * nb_lfe)
        // nb_normal) // 2))
    coupled_ratio, lfe_ratio = 512, 32
    total = (nb_uncoupled << 8) + coupled_ratio * coupled + lfe_ratio * nb_lfe
    channel_rate = 256 * (bitrate_bps - lfe_offset * nb_lfe
                          - stream_offset * (coupled + nb_uncoupled)
                          - channel_offset * nb_normal) // total
    rates = []
    for s in range(streams):
        if s < coupled:
            rates.append(2 * channel_offset
                         + max(0, stream_offset
                               + ((channel_rate * coupled_ratio) >> 8)))
        elif s == lfe_stream:
            rates.append(max(0, lfe_offset + ((channel_rate * lfe_ratio) >> 8)))
        else:
            rates.append(channel_offset + max(0, stream_offset + channel_rate))
    return rates


def surround_masks(pcm: np.ndarray, mapping: list[int], streams: int,
                   coupled: int) -> list[np.ndarray]:
    """Per-stream 21-band energy masks from the multichannel input.

    Simplified surround_analysis (libopus computes this with a 21-band
    MDCT energy max-pool across channel positions; the reference takes the
    result as an input array, opus_multistream.rs:1128): each channel's
    band log-energy is compared against the loudest channel per band, so
    channels buried under others get negative masks -> fewer bits via
    compute_surround_masking_rate_offset. FFT-binned per CELT band edges."""
    from .celt.modes import EBAND5MS

    n, channels = pcm.shape
    spec = np.abs(np.fft.rfft(pcm * np.hanning(n)[:, None], axis=0)) ** 2
    # band edges in bins: EBAND5MS units are 2.5 ms MDCT bins (n/2 total
    # spectrum bins correspond to 100 units at 20 ms)
    scale = (n // 2) / 100.0
    band_e = np.empty((channels, 21))
    for b in range(21):
        lo = int(EBAND5MS[b] * scale)
        hi = max(lo + 1, int(EBAND5MS[b + 1] * scale))
        band_e[:, b] = spec[lo:hi].sum(axis=0) + 1e-12
    log_e = 0.5 * np.log2(band_e)
    mask_log_e = log_e.max(axis=0)  # loudest channel per band is the masker
    chan_mask = np.clip(log_e - mask_log_e[None, :], -2.0, 0.5)

    inv = {m: ch for ch, m in enumerate(mapping) if m != 255}
    masks = []
    idx = 0
    for s in range(streams):
        nch = 2 if s < coupled else 1
        rows = []
        for k in range(nch):
            ch = inv.get(idx + k)
            rows.append(chan_mask[ch] if ch is not None
                        else np.full(21, -2.0))
        idx += nch
        masks.append(np.concatenate(rows))
    return masks


class MultistreamEncoder:
    def __init__(self, fs: int, channels: int, streams: int,
                 coupled_streams: int, mapping: list[int],
                 lfe_stream: int | None = None):
        self.fs = fs
        self.channels = channels
        self.streams = streams
        self.coupled = coupled_streams
        self.mapping = list(mapping)
        self.lfe_stream = lfe_stream
        self.bitrate = 64000 * (2 * coupled_streams
                                + (streams - coupled_streams))
        self.encoders = [OpusEncoder(fs, 2 if s < coupled_streams else 1)
                         for s in range(streams)]

    @classmethod
    def surround(cls, fs: int, channels: int):
        streams, coupled, mapping = DEFAULT_SURROUND[channels]
        # family-1 5.1/7.1 layouts carry the LFE as the last mono stream
        lfe = streams - 1 if channels in (6, 8) else None
        return cls(fs, channels, streams, coupled, mapping, lfe_stream=lfe)

    def set_bitrate(self, total_bps: int):
        self.bitrate = total_bps
        self._apply_rates(960)

    def _apply_rates(self, frame_size: int):
        rates = surround_rate_allocation(self.streams, self.coupled,
                                         self.lfe_stream, self.bitrate,
                                         frame_size, self.fs)
        for e, r in zip(self.encoders, rates):
            e.set_bitrate(r)

    def encode(self, pcm: np.ndarray, frame_size: int,
               stream_energy_masks: list | None = None) -> bytes:
        """Encode one multichannel frame. stream_energy_masks optionally
        carries a 21-band-per-channel masking array per stream
        (opus_multistream.rs:1128 stream_energy_masks) which offsets that
        stream's SILK rate; surround() instances compute one automatically
        when none is given (surround_masks)."""
        self._apply_rates(frame_size)
        if stream_energy_masks is None and self.lfe_stream is not None:
            stream_energy_masks = surround_masks(
                pcm, self.mapping, self.streams, self.coupled)
        for s, e in enumerate(self.encoders):
            e.energy_mask = (stream_energy_masks[s]
                             if stream_energy_masks else None)
        # inverse mapping: stream-channel index -> input channel
        inv = {}
        for ch, m in enumerate(self.mapping):
            if m != 255:
                inv[m] = ch
        out = bytearray()
        idx = 0
        packets = []
        for s in range(self.streams):
            if s < self.coupled:
                chans = [inv.get(idx, None), inv.get(idx + 1, None)]
                idx += 2
                buf = np.zeros((frame_size, 2))
                for k, ch in enumerate(chans):
                    if ch is not None:
                        buf[:, k] = pcm[:, ch]
            else:
                ch = inv.get(idx, None)
                idx += 1
                buf = np.zeros((frame_size, 1))
                if ch is not None:
                    buf[:, 0] = pcm[:, ch]
            packets.append(self.encoders[s].encode(buf, frame_size))
        for s, pkt in enumerate(packets):
            if s < self.streams - 1:
                out += _to_self_delim(pkt)
            else:
                out += pkt
        return bytes(out)

    @property
    def final_range(self) -> int:
        r = 0
        for e in self.encoders:
            r ^= e.final_range
        return r & 0xFFFFFFFF


def _to_self_delim(pkt: bytes) -> bytes:
    """Convert a regular (code 0) packet to self-delimited framing."""
    code = pkt[0] & 0x3
    if code != 0:
        raise NotImplementedError("elementary packets are code 0 here")
    return bytes([pkt[0]]) + _enc_size(len(pkt) - 1) + pkt[1:]
