"""The port's copies of multistream.py, projection.py and
projection_tables.py against the JAX package's: multistream encode and
decode in mono, stereo and 5.1 surround, and the first-order ambisonics
projection (packets byte-equal, decoded PCM and final ranges equal), the
surround rate split and energy masks, and the projection layouts and
matrices."""

import numpy as np
import pytest

from mousiki_tpu import multistream as jax_ms
from mousiki_tpu import projection as jax_proj
from mousiki_tpu_torch.hostcodec import multistream as ms
from mousiki_tpu_torch.hostcodec import projection as proj
from torch_threads import one_torch_thread  # noqa: F401


def _signal(frames, channels, seed):
    """A tone a channel at its own pitch and level, with a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(960 * frames) / 48000.0
    sig = np.stack([(0.4 / (1 + c)) * np.sin(2 * np.pi * (200 + 130 * c) * t)
                    for c in range(channels)], 1)
    return sig + 0.01 * rng.standard_normal(sig.shape)


def _run_both(port_enc, ref_enc, port_dec, ref_dec, sig):
    """Encode and decode sig frame by frame on both sides (a projection
    coder's final range is its inner multistream coder's)."""
    def inner(coder):
        return getattr(coder, "ms", coder)

    for f in range(sig.shape[0] // 960):
        pcm = sig[f * 960:(f + 1) * 960]
        pkt = port_enc.encode(pcm, 960)
        assert pkt == ref_enc.encode(pcm, 960), f
        assert inner(port_enc).final_range == inner(ref_enc).final_range
        got, want = port_dec.decode(pkt, 960), ref_dec.decode(pkt, 960)
        assert got.shape == (960, sig.shape[1])
        np.testing.assert_array_equal(got, want)
        assert inner(port_dec).final_range == inner(ref_dec).final_range
    assert np.abs(got).max() > 1e-3
    lost = port_dec.decode(None, 960)
    np.testing.assert_array_equal(lost, ref_dec.decode(None, 960))


@pytest.mark.parametrize("channels,bitrate", [(1, 32000), (2, 64000),
                                              (6, 256000)])
def test_multistream_matches_jax(channels, bitrate):
    """surround(48000, channels): mono, stereo and 5.1 (two coupled
    streams, a centre and an LFE, with surround masks), three frames."""
    encs = [mod.MultistreamEncoder.surround(48000, channels)
            for mod in (ms, jax_ms)]
    for enc in encs:
        enc.set_bitrate(bitrate)
    assert [e.bitrate for e in encs[0].encoders] \
        == [e.bitrate for e in encs[1].encoders]
    e = encs[0]
    decs = [mod.MultistreamDecoder(48000, channels, e.streams, e.coupled,
                                   e.mapping) for mod in (ms, jax_ms)]
    _run_both(*encs, *decs, _signal(3, channels, seed=channels))


def test_surround_rate_allocation_and_masks_match_jax():
    for args in ((4, 2, 3, 256000, 960, 48000), (5, 3, 4, 512000, 480, 48000),
                 (2, 1, None, 96000, 960, 48000), (1, 0, None, 20000, 2880,
                                                   48000)):
        assert ms.surround_rate_allocation(*args) \
            == jax_ms.surround_rate_allocation(*args)
    pcm = _signal(1, 6, seed=9)
    pcm[:, 1] *= 0.02                            # a quiet centre
    for streams, coupled, mapping in (ms.DEFAULT_SURROUND[6],
                                      ms.DEFAULT_SURROUND[8][:2]
                                      + ([0, 6, 1, 2, 3, 255],)):
        got = ms.surround_masks(pcm, mapping, streams, coupled)
        want = jax_ms.surround_masks(pcm, mapping, streams, coupled)
        assert len(got) == len(want) == streams
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert ms.DEFAULT_SURROUND == jax_ms.DEFAULT_SURROUND


def test_projection_layouts_and_matrices_match_jax():
    for channels in (4, 6, 9, 11, 16, 18, 25):
        got = proj.projection_layout(channels)
        want = jax_proj.projection_layout(channels)
        for field in ("streams", "coupled_streams", "order_plus_one",
                      "channels"):
            assert getattr(got, field) == getattr(want, field), field
        for name in ("mixing", "demixing"):
            g, w = getattr(got, name), getattr(want, name)
            assert g.gain_db_q8 == w.gain_db_q8
            np.testing.assert_array_equal(g.data, w.data)
        assert proj.write_demixing_matrix_subset(got) \
            == jax_proj.write_demixing_matrix_subset(want)
        assert proj.demixing_matrix_gain(got) \
            == jax_proj.demixing_matrix_gain(want)
        x = np.random.default_rng(channels).standard_normal((64, channels))
        n_in = got.streams + got.coupled_streams
        np.testing.assert_array_equal(got.mixing.multiply_in(x, n_in),
                                      want.mixing.multiply_in(x, n_in))
    for bad in (3, 5, 8, 1, 228):
        with pytest.raises(proj.ProjectionError):
            proj.projection_layout(bad)


def test_projection_foa_matches_jax():
    """First-order ambisonics (4 channels, family 3), three frames."""
    encs = [mod.ProjectionEncoder(48000, 4) for mod in (proj, jax_proj)]
    for enc in encs:
        enc.set_bitrate(256000)
    assert encs[0].demixing_matrix() == encs[1].demixing_matrix()
    assert encs[0].demixing_matrix_gain() == encs[1].demixing_matrix_gain()
    lay = encs[0].layout
    decs = [mod.ProjectionDecoder(48000, 4, lay.streams, lay.coupled_streams,
                                  demixing_matrix=encs[0].demixing_matrix())
            for mod in (proj, jax_proj)]
    _run_both(*encs, *decs, _signal(3, 4, seed=4))
