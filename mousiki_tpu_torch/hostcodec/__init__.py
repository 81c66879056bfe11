"""The numpy host codec the SILK encode pipeline drives: copies of the
modules of mousiki_tpu that `OpusEncoder` in forced SILK mode imports
(the encoder, its analysis chain, the range coder, the tables and the
decoder pieces they share), under the reference's own tree so that every
relative import resolves inside this subpackage.

Every file here equals its original byte for byte
(tests/test_torch_tables.py), apart from this file, two reworded
docstring lines (`silk/nsq_del_dec.py`, `celt/modes.py`; the test lists
them) and `silk/host_native.py`, which finds the native SILK library
through the port's own build (`ops/_build.load_host`) instead of the
reference's `native/` directory. `opus_encoder.py` imports `.dred` lazily when DRED
is enabled; that module is not copied, so enabling DRED raises
ImportError here.
"""
