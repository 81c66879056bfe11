"""The numpy host codec of the JAX package, copied under the reference's
own tree so that every relative import resolves inside this subpackage:
the closure of `OpusEncoder` that the encode side drives (the encoder,
its SILK analysis chain, the range coder, the tables and the decoder
pieces they share, the repacketizer and packet extensions, the tonality
analysis), and on top of it the single-stream API (`OpusDecoder` with
`softclip`, the typed `codec`, `ctl`, `utils/debug`, `multistream`,
`projection`, the Ogg `containers/`, `lightweight`, `celt/custom`).

Every file here equals its original byte for byte
(tests/test_torch_tables.py), apart from this file, four reworded
docstring lines (`silk/nsq_del_dec.py`, `celt/modes.py`, two in
`codec.py`; the test lists them), `silk/host_native.py`, which finds
the native SILK library through the port's own build
(`ops/_build.load_host`) instead of the reference's `native/`
directory, `utils/__init__.py` (the original `utils/` is a namespace
directory), and the small modules that stand in
for the port's own where the copies import them lazily: `dred.py` (the
DRED encoder and decoder API, whose RDOVAE runs in PyTorch),
`models/dred.py` and `models/deep_plc.py` (with their
`models/__init__.py`; the deep-PLC state is built on its model's
device) and `ops/input_resampler.py`. So every branch of the encoder
runs (other API rates, 80-120 ms frames, APP_AUDIO, DRED), and the
decoder's deep PLC and DRED decode run the port's torch models.
"""
