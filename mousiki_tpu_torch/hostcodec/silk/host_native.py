"""The native SILK host library, for the copied host codec: the port's
own build of `csrc/silk_host.cpp` (`mousiki_tpu_torch/silk/host_native.py`,
`ops/_build.load_host`). The copied `nsq_del_dec.py` looks up its native
twin, `silk_nsq_del_dec_f64`, on the library `_load()` returns."""

from ...silk.host_native import NativeSilkHost, _load  # noqa: F401
