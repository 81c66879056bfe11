"""The port's copies of containers/ (ogg.py, opusfile.py, picture.py) and
celt/custom.py against the JAX package's: Ogg pages, Opus head and tags,
OggOpusWriter files byte-equal; OpusFile read (one link and a chained
file), seek and OpusEnc (a 16 kHz input through the resampler) equal; the
picture tag parse equal; and a custom CELT mode round trip (44.1 kHz,
1024 samples, stereo) with packets, final ranges and PCM equal. The Opus
files are made from the committed golden packets."""

import base64
import struct

import numpy as np
import pytest

from golden_streams import load_all
from mousiki_tpu.celt import custom as jax_custom
from mousiki_tpu.containers import ogg as jax_ogg
from mousiki_tpu.containers import opusfile as jax_opusfile
from mousiki_tpu.containers import picture as jax_picture
from mousiki_tpu_torch.hostcodec.celt import custom
from mousiki_tpu_torch.hostcodec.containers import ogg, opusfile, picture
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def golden():
    streams = {s.name: s for s in load_all()}
    return streams["celt_fb_stereo_128k"], streams["silk_wb_16k"]


def _opus_file(mod, stream, serial, comments=None, preskip=312):
    """An Ogg Opus file of a golden stream's 12 packets, one page each
    fourth packet."""
    w = mod.OggOpusWriter(stream.pcm.shape[1], preskip=preskip,
                          serial=serial, comments=comments)
    for f, pkt in enumerate(stream.packets):
        w.write_packet(pkt, 960, flush=f % 4 == 3)
    return w.finish()


def test_ogg_pages_and_headers_equal():
    pkts = [b"hello", b"x" * 600, b"", b"tail", bytes(range(256)) * 40]
    for mod in (ogg, jax_ogg):
        assert mod.ogg_crc(b"OggS" + bytes(range(40))) \
            == jax_ogg.ogg_crc(b"OggS" + bytes(range(40)))
    pages = []
    for mod in (ogg, jax_ogg):
        w = mod.OggStreamWriter(1234)
        pages.append(w.page_out(pkts[:2], granule=999, bos=True)
                     + w.page_out(pkts[2:], granule=2000, eos=True))
    assert pages[0] == pages[1]
    got, want = ogg.parse_page(pages[0]), jax_ogg.parse_page(pages[0])
    assert got[1:] == want[1:]
    for field in ("version", "header_type", "granule_pos", "serial",
                  "page_seq", "segments"):
        assert getattr(got[0], field) == getattr(want[0], field), field
    read = []
    for mod in (ogg, jax_ogg):
        r = mod.OggStreamReader(pages[0])
        read.append(list(iter(r.next_packet, None)))
    assert read[0] == read[1] and [p for p, _ in read[0]] == pkts
    for args in ((2, 312, 48000), (1, 0, 16000)):
        head = ogg.opus_head(*args)
        assert head == jax_ogg.opus_head(*args)
        assert ogg.parse_opus_head(head) == jax_ogg.parse_opus_head(head)
    tags = ogg.opus_tags("vend", ["TITLE=x", "ARTIST=y"])
    assert tags == jax_ogg.opus_tags("vend", ["TITLE=x", "ARTIST=y"])
    assert ogg.parse_opus_tags(tags) == jax_ogg.parse_opus_tags(tags)


def test_writer_bytes_and_reader_equal(golden):
    stereo, _ = golden
    blob = _opus_file(opusfile, stereo, 77, ["TITLE=golden"])
    assert blob == _opus_file(jax_opusfile, stereo, 77, ["TITLE=golden"])
    readers = [mod.OggOpusReader(blob) for mod in (opusfile, jax_opusfile)]
    assert readers[0].head == readers[1].head
    assert readers[0].channels == readers[1].channels == 2
    assert list(readers[0].packets()) == list(readers[1].packets())
    pcm = opusfile.OggOpusReader(blob).decode_all()
    np.testing.assert_array_equal(
        pcm, jax_opusfile.OggOpusReader(blob).decode_all())
    assert pcm.shape == (12 * 960 - 312, 2)
    np.testing.assert_allclose(pcm, stereo.pcm[312:], atol=1e-6, rtol=0)


def test_opusfile_read_and_seek_equal(golden):
    """A chained file (the stereo CELT stream, then the mono SILK one):
    links, totals, tags, the whole decode and the stereo variant equal;
    then a seek into a one-link file equal."""
    stereo, mono = golden
    blob = (_opus_file(opusfile, stereo, 111, ["TITLE=first"])
            + _opus_file(opusfile, mono, 222, ["TITLE=second"], preskip=0))
    files = [mod.OpusFile(blob) for mod in (opusfile, jax_opusfile)]
    for f in files:
        assert f.link_count == 2
    got, want = files
    for link in (0, 1):
        assert got.serialno(link) == want.serialno(link)
        assert got.channel_count(link) == want.channel_count(link)
        assert got.pcm_total(link) == want.pcm_total(link)
        assert got.tags(link) == want.tags(link)
        assert got.head(link) == want.head(link)
    assert got.pcm_total() == want.pcm_total() == 2 * 12 * 960
    whole = got.decode_all()
    np.testing.assert_array_equal(whole, want.decode_all())
    assert whole.shape[1] == 2 and np.abs(whole).max() > 0.05
    np.testing.assert_array_equal(opusfile.OpusFile(blob).read_stereo(),
                                  jax_opusfile.OpusFile(blob).read_stereo())
    readers = [mod.OggOpusReader(_opus_file(mod, stereo, 5, preskip=0))
               for mod in (opusfile, jax_opusfile)]
    target = 960 * 7 + 123
    seek = [r.read_from(target, 2400) for r in readers]
    assert seek[0].shape == (2400, 2)
    np.testing.assert_array_equal(seek[0], seek[1])


def test_opusenc_resampled_input_equal():
    """OpusEnc at 16 kHz: the input resampler, the encoder and the muxer;
    pulled pages plus the tail equal the JAX package's one-shot file."""
    t = np.arange(16000 // 5) / 16000.0
    pcm = (0.4 * np.sin(2 * np.pi * 330 * t))[:, None]
    pull = opusfile.OpusEnc(16000, 1, bitrate=32000)
    parts = []
    for i in range(0, len(pcm), 1600):
        pull.write(pcm[i:i + 1600])
        parts.append(pull.drain_pages())
    parts.append(pull.finish())
    ref = jax_opusfile.OpusEnc(16000, 1, bitrate=32000)
    ref.write(pcm)
    assert b"".join(parts) == ref.finish()
    assert pull.writer.preskip == ref.writer.preskip > 312


def _picture_block(kind, mime, desc, image):
    return (struct.pack(">I", kind) + struct.pack(">I", len(mime)) + mime
            + struct.pack(">I", len(desc)) + desc
            + struct.pack(">IIII", 0, 0, 0, 0)
            + struct.pack(">I", len(image)) + image)


def test_picture_tag_parse_equal():
    png = (b"\x89PNG\r\n\x1a\n" + struct.pack(">I", 13) + b"IHDR"
           + struct.pack(">IIBB", 32, 32, 8, 6) + b"\x00\x00\x00"
           + b"\x00\x00\x00\x00")
    gif = b"GIF89a" + struct.pack("<HH", 32, 32) + b"\x00\x00\x00\x00"
    jpeg = b"\xff\xd8\xff\xc0\x00\x11\x08\x00\x10\x00\x20\x03" + b"\x00" * 9
    tags = ["METADATA_BLOCK_PICTURE=" + base64.b64encode(
        _picture_block(3, b"image/png", b"cover", png)).decode(),
        base64.b64encode(_picture_block(4, b"image/gif", b"", gif)).decode(),
        base64.b64encode(_picture_block(1, b"image/gif", b"", gif)).decode(),
        base64.b64encode(_picture_block(5, b"image/jpeg", b"x", jpeg))
        .decode(), "TITLE=x", "METADATA_BLOCK_PICTURE=bad"]
    fields = ("picture_type", "mime_type", "description", "width", "height",
              "depth", "colors", "data", "format")
    for tag in tags:
        out = []
        for mod in (picture, jax_picture):
            try:
                pic = mod.OpusPictureTag.parse(tag)
                out.append(tuple(getattr(pic, f) for f in fields))
            except ValueError as exc:
                out.append(("raises", str(exc)))
        assert out[0] == out[1], tag
    got = picture.picture_from_tags(tags)
    want = jax_picture.picture_from_tags(tags)
    assert [tuple(getattr(p, f) for f in fields) for p in got] \
        == [tuple(getattr(p, f) for f in fields) for p in want]
    assert len(got) >= 1


def test_custom_mode_round_trip_equal():
    """opus_custom_mode_create(44100, 1024), stereo: 4 frames through
    each package's custom encoder and decoder, then a lost frame."""
    fs, frame, ch = 44100, 1024, 2
    modes = [mod.opus_custom_mode_create(fs, frame)
             for mod in (custom, jax_custom)]
    assert modes[0].num_ebands == modes[1].num_ebands
    np.testing.assert_array_equal(modes[0].ebands, modes[1].ebands)
    coders = [(mod.OpusCustomEncoder(m, ch), mod.OpusCustomDecoder(m, ch))
              for mod, m in zip((custom, jax_custom), modes)]
    t = np.arange(frame * 4) / fs
    sig = (0.4 * np.sin(2 * np.pi * 440 * t)
           + 0.2 * np.sin(2 * np.pi * 1711 * t))
    pcm_in = np.stack([sig, 0.5 * sig], axis=1)
    for f in range(4):
        pcm = pcm_in[f * frame:(f + 1) * frame]
        (enc, dec), (ref_enc, ref_dec) = coders
        pkt = enc.encode_float(pcm, 120)
        assert pkt == ref_enc.encode_float(pcm, 120), f
        got, want = dec.decode_float(pkt), ref_dec.decode_float(pkt)
        assert got.shape == (frame, ch)
        np.testing.assert_array_equal(got, want)
        assert dec.final_range == ref_dec.final_range == enc.final_range
    np.testing.assert_array_equal(coders[0][1].decode(None),
                                  coders[1][1].decode(None))
