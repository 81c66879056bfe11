"""The numpy host codec the encode side drives: copies of the modules of
mousiki_tpu that `OpusEncoder` imports (the encoder, its SILK analysis
chain, the range coder, the tables and the decoder pieces they share, the
repacketizer and packet extensions, the tonality analysis), under the
reference's own tree so that every relative import resolves inside this
subpackage.

Every file here equals its original byte for byte
(tests/test_torch_tables.py), apart from this file, two reworded
docstring lines (`silk/nsq_del_dec.py`, `celt/modes.py`; the test lists
them), `silk/host_native.py`, which finds the native SILK library
through the port's own build (`ops/_build.load_host`) instead of the
reference's `native/` directory, and four small modules that re-export
the port's own where `opus_encoder.py` imports them lazily: `dred.py`
(the DRED encoder, whose RDOVAE runs in PyTorch), `models/dred.py` (with
its `models/__init__.py`) and `ops/input_resampler.py`. So every branch
of the encoder runs: other API rates, 80-120 ms frames, APP_AUDIO and
DRED.
"""
