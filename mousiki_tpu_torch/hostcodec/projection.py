"""Ambisonics projection encoder/decoder (mapping family 3).

Channels are mixed through fixed Q15 matrices into (streams + coupled)
elementary Opus streams and demixed on the way out; the demixing matrix is
exposed through a ctl for transport in the OpusProjection head (reference
src/projection.rs:75,119,415,614 and src/mapping_matrix.rs:156-350).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .multistream import MultistreamDecoder, MultistreamEncoder
from .projection_tables import MATRICES


@dataclass(frozen=True)
class MappingMatrix:
    rows: int
    cols: int
    gain_db_q8: int
    data: np.ndarray  # (rows, cols) int16

    @classmethod
    def named(cls, name: str) -> "MappingMatrix":
        rows, cols, gain, flat = MATRICES[name]
        # stored column-major: index = col * rows + row
        arr = np.asarray(flat, np.int16).reshape(cols, rows).T
        return cls(rows, cols, gain, arr)

    def multiply_in(self, pcm: np.ndarray, out_rows: int) -> np.ndarray:
        """(frame, in_ch) float -> (frame, out_rows): internal stream mix."""
        in_ch = pcm.shape[1]
        m = self.data[:out_rows, :in_ch].astype(np.float64) / 32768.0
        return pcm @ m.T

    def multiply_out(self, streams_pcm: np.ndarray, out_ch: int) -> np.ndarray:
        """(frame, in_streams) -> (frame, out_ch): demix decoded streams."""
        n_in = streams_pcm.shape[1]
        m = self.data[:out_ch, :n_in].astype(np.float64) / 32768.0
        return streams_pcm @ m.T


class ProjectionError(ValueError):
    pass


_ORDER_TO_NAME = {2: "FOA", 3: "SOA", 4: "TOA", 5: "FOURTHOA", 6: "FIFTHOA"}


@dataclass(frozen=True)
class ProjectionLayout:
    channels: int
    streams: int
    coupled_streams: int
    order_plus_one: int
    mixing: MappingMatrix
    demixing: MappingMatrix

    def demixing_subset_size_bytes(self) -> int:
        return self.channels * (self.streams + self.coupled_streams) * 2


def projection_layout(channels: int, mapping_family: int = 3) -> ProjectionLayout:
    """Validate an ambisonics configuration and pick its fixed matrices.

    Allowed channel counts: (order+1)^2 (+2 non-diegetic), orders 1-5."""
    if mapping_family != 3:
        raise ProjectionError("projection requires mapping family 3")
    if not 1 <= channels <= 227:
        raise ProjectionError("bad channel count")
    order_plus_one = int(np.sqrt(channels))
    nondiegetic = channels - order_plus_one * order_plus_one
    if nondiegetic not in (0, 2):
        raise ProjectionError("bad channel count")
    if not 2 <= order_plus_one <= 6:
        raise ProjectionError("unsupported ambisonic order")
    streams = (channels + 1) // 2
    coupled = channels // 2
    name = _ORDER_TO_NAME[order_plus_one]
    mixing = MappingMatrix.named(name + "_MIXING")
    demixing = MappingMatrix.named(name + "_DEMIXING")
    if (streams + coupled > mixing.rows or channels > mixing.cols
            or channels > demixing.rows or streams + coupled > demixing.cols):
        raise ProjectionError("matrices cannot cover layout")
    return ProjectionLayout(channels, streams, coupled, order_plus_one,
                            mixing, demixing)


def write_demixing_matrix_subset(layout: ProjectionLayout) -> bytes:
    """channels x (streams+coupled) int16 little-endian, column by column
    (the OPUS_PROJECTION_GET_DEMIXING_MATRIX payload)."""
    n_in = layout.streams + layout.coupled_streams
    sub = layout.demixing.data[: layout.channels, :n_in]
    return sub.T.astype("<i2").tobytes()


def demixing_matrix_gain(layout: ProjectionLayout) -> int:
    return layout.demixing.gain_db_q8


class ProjectionEncoder:
    """opus_projection_ambisonics_encoder: matrix mix + multistream encode."""

    def __init__(self, fs: int, channels: int, mapping_family: int = 3):
        self.layout = projection_layout(channels, mapping_family)
        lay = self.layout
        n_internal = lay.streams + lay.coupled_streams
        # internal multistream uses the identity channel mapping
        self.ms = MultistreamEncoder(
            fs, n_internal, lay.streams, lay.coupled_streams,
            list(range(n_internal)))
        self.channels = channels
        self.fs = fs

    def set_bitrate(self, bitrate: int):
        self.ms.set_bitrate(bitrate)

    def encode(self, pcm: np.ndarray, frame_size: int) -> bytes:
        if pcm.shape[1] != self.channels:
            raise ProjectionError("channel count mismatch")
        lay = self.layout
        mixed = lay.mixing.multiply_in(pcm, lay.streams + lay.coupled_streams)
        return self.ms.encode(mixed, frame_size)

    # ctl surface
    def demixing_matrix(self) -> bytes:
        return write_demixing_matrix_subset(self.layout)

    def demixing_matrix_gain(self) -> int:
        return demixing_matrix_gain(self.layout)

    def demixing_matrix_size(self) -> int:
        return self.layout.demixing_subset_size_bytes()


class ProjectionDecoder:
    """opus_projection_decoder: multistream decode + demixing matrix.

    The demixing matrix normally arrives out of band (container head);
    created from explicit matrix bytes or from the canonical layout."""

    def __init__(self, fs: int, channels: int, streams: int,
                 coupled_streams: int, demixing_matrix: bytes | None = None):
        n_internal = streams + coupled_streams
        self.ms = MultistreamDecoder(fs, n_internal, streams, coupled_streams,
                                     list(range(n_internal)))
        self.channels = channels
        if demixing_matrix is None:
            lay = projection_layout(channels)
            if (streams, coupled_streams) != (lay.streams, lay.coupled_streams):
                raise ProjectionError("stream layout mismatch")
            self.demixing = lay.demixing
            self._sub = None
        else:
            expected = channels * n_internal * 2
            if len(demixing_matrix) != expected:
                raise ProjectionError("bad demixing matrix size")
            sub = np.frombuffer(demixing_matrix, "<i2").reshape(
                n_internal, channels).T
            self._sub = sub
            self.demixing = None

    def decode(self, data: bytes | None, frame_size: int) -> np.ndarray:
        streams_pcm = self.ms.decode(data, frame_size)
        if self.demixing is not None:
            return self.demixing.multiply_out(streams_pcm, self.channels)
        m = self._sub.astype(np.float64) / 32768.0
        return streams_pcm @ m.T
