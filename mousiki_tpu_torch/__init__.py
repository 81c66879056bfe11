"""mousiki_tpu_torch — the PyTorch/CUDA port of mousiki_tpu's stream
pipelines, for one NVIDIA H100. Decoders: `CeltStreamPipeline` (CELT, plan
and non-plan mode), `SilkStreamPipeline` (SILK, host or device synthesis)
and `OpusStreamPipeline` (mixed SILK / CELT / hybrid packets); the first
and the last also split their streams over several devices
(`parallel/streaming.py`, `mesh=`). Encoders:
`CeltEncodePipeline` (the device front of `ops/encode_front.py` feeding
the native symbol encoder) and `SilkEncodePipeline` (per-stream host
encoders whose noise-shaping quantizer calls `parallel/nsq_batch.py`
batches onto `ops/silk_nsq.py`). Neural loss recovery:
`BatchedDeepRecovery` (parallel/deep_recovery.py: the DRED latents of S
streams decoded to features by the RDOVAE decoder, and concealment audio
synthesized by PitchDNN + FARGAN, models/), beside the single-stream DRED
API (dred.py), which the copied `OpusEncoder` uses to embed DRED.

The single-stream API is the reference's own numpy code, copied under
`hostcodec/`: `OpusDecoder` (its deep PLC and DRED decode run the port's
torch models), `OpusEncoder`, the typed `Encoder` / `Decoder` of
`codec.py`, multistream, the Ogg containers and the repacketizer. Their
names are re-exported here as the reference's `__all__` has them.

The port stands alone: it keeps its own copies of what it needs from
`mousiki_tpu` (the native C++ host stages in `csrc/`, the 48 kHz mode, the
MDCT bases, the plan transforms, the packet parser, the resampler tables,
and under `hostcodec/` the numpy host codec the encoders drive) and
imports nothing of that package. The device half is PyTorch ops on
tensors, with the de-emphasis tail (IIR, scale, interleave) as a
hand-written CUDA kernel (`ops/deemphasis.py`, `csrc/deemphasis.cu`). The
JAX package stays the reference every module is tested against.

Importing this package loads nothing heavy; `torch` loads with the first
submodule that needs it, and no module here imports `jax`.
"""

__version__ = "0.5.0"

_PIPELINES = ("CeltEncodePipeline", "CeltStreamPipeline", "OpusStreamPipeline",
              "SilkEncodePipeline", "SilkStreamPipeline")
# the reference's top-level names (mousiki_tpu/__init__.py), each with the
# module of hostcodec/ that defines it
_SINGLE_STREAM = {
    **dict.fromkeys(("Application", "Bandwidth", "Channels", "Decoder",
                     "Encoder", "FrameDuration", "Signal"), "codec"),
    "OpusEncoder": "opus_encoder",
    "OpusDecoder": "opus_decoder",
    "MultistreamEncoder": "multistream",
    "MultistreamDecoder": "multistream",
    **dict.fromkeys(("OggOpusReader", "OggOpusWriter", "OpusFile",
                     "OpusEnc"), "containers.opusfile"),
    "Repacketizer": "bitstream.repacketizer",
}

__all__ = sorted(("BatchedDeepRecovery",) + _PIPELINES
                 + tuple(_SINGLE_STREAM))


def __getattr__(name):
    # lazy, so that `import mousiki_tpu_torch` stays light
    import importlib
    if name == "BatchedDeepRecovery":
        from .parallel.deep_recovery import BatchedDeepRecovery
        return BatchedDeepRecovery
    if name in _PIPELINES:
        from . import pipeline
        return getattr(pipeline, name)
    if name in _SINGLE_STREAM:
        module = importlib.import_module(
            f".hostcodec.{_SINGLE_STREAM[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(
        f"module 'mousiki_tpu_torch' has no attribute {name!r}")
