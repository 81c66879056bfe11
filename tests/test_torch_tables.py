"""mousiki_tpu_torch constants and package hygiene: the tables, mode,
MDCT bases, plan transforms, arena layouts, packet parser, native
sources, the numpy host codec (`hostcodec/`) and the numpy parts of the
neural models copied out of the JAX package equal their originals, the
port's device constants
equal the JAX ones, the package imports neither jax nor anything of
mousiki_tpu, and the de-emphasis wrapper takes its plain path on CPU
tensors. The lockstep decoder's mode tables (ops/celt_lockstep._tables,
built from the copies in hostcodec/celt/) are held to the JAX package's
here at LM 3, and with the walk's and emission's tables at every LM in
tests/test_torch_celt_lockstep.py."""

import contextlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch


from mousiki_tpu.celt import bands as jax_bands
from mousiki_tpu.celt import decoder as jax_decoder
from mousiki_tpu.celt import host_native as jax_host_native
from mousiki_tpu.celt import plan as jax_plan
from mousiki_tpu.celt import plan_pack as jax_plan_pack
from mousiki_tpu.celt.modes import opus_custom_mode
from mousiki_tpu.celt.quant_bands import E_MEANS
from mousiki_tpu.ops import band_exec_jax, encode_front_jax, plc_jax
from mousiki_tpu.ops import mdct as jax_mdct
from mousiki_tpu.ops import synthesis_jax
from mousiki_tpu_torch.celt import host_native, modes, plan
from mousiki_tpu_torch.ops import _tables, band_exec, deemphasis, mdct, plc
from mousiki_tpu_torch.ops import synthesis
from mousiki_tpu_torch.pipeline import SERVING_PROFILE
from torch_threads import one_torch_thread  # noqa: F401

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_copied_tables_equal_originals():
    np.testing.assert_array_equal(_tables.u_table(), band_exec_jax._u_table())
    for got, want in zip(_tables.lcg_jump(), band_exec_jax._lcg_jump()):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_tables.SPREAD_FACTOR,
                                  band_exec_jax._SPREAD_FACTOR)
    for frame in (120, 960):
        for got, want in zip(_tables.plan_combo_mats_np(frame),
                             band_exec_jax._plan_combo_mats_np(frame)):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_tables.COMB_GAINS,
                                  synthesis_jax._COMB_GAINS)
    mode = opus_custom_mode()
    for M in (1, 2, 4, 8):
        np.testing.assert_array_equal(_tables.bin_band_map(modes.MODE, M),
                                      synthesis_jax._bin_band_map(mode, M))
    w = np.asarray(mode.window, np.float32)
    for n2 in (120, 240, 480, 960):
        for got, want in zip(_tables.fold_operator(n2, w),
                             encode_front_jax._fold_operator(n2, w)):
            np.testing.assert_array_equal(got, np.asarray(want))
    # the lockstep decoder's tables, built from the copies in hostcodec/
    # (all four LMs and the walk's constants: test_torch_celt_lockstep.py)
    from mousiki_tpu.ops import celt_lockstep as jax_lockstep
    from mousiki_tpu_torch.ops import celt_lockstep
    for C in (1, 2):
        got, want = celt_lockstep._tables(3, C), jax_lockstep._tables(3, C)
        for field in want._fields:
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field), err_msg=field)


@pytest.mark.parametrize("n", [120, 960])
def test_device_constants_equal_jax(n):
    got = synthesis.make_consts(n, "cpu")
    want = synthesis_jax.make_consts(n=n)
    for field in synthesis_jax.SynthesisConsts._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    window = opus_custom_mode(48000, 960).window
    pg = plc.make_plc_consts(n, window, "cpu")
    pw = plc_jax.make_plc_consts(n, window)
    for key in ("F", "han", "lagw", "comb_gains"):
        np.testing.assert_array_equal(pg[key].numpy(), np.asarray(pw[key]),
                                      err_msg=key)
    for got_t, want_t in zip(pg["fold"], pw["fold"]):
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    for got_m, want_m in zip(band_exec.plan_combo_mats(2, n, "cpu"),
                             band_exec_jax.plan_combo_mats(2, n)):
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


def test_mode_copy_equals_original():
    want = opus_custom_mode(48000, 960)
    got = modes.MODE
    for field in ("fs", "overlap", "num_ebands", "short_mdct_size"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("ebands", "window"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert modes.E_MEANS.dtype == E_MEANS.dtype
    np.testing.assert_array_equal(modes.E_MEANS, E_MEANS)
    for name in ("DECODE_BUFFER_SIZE", "CELT_LPC_ORDER", "PLC_PITCH_LAG_MAX",
                 "PLC_PITCH_LAG_MIN"):
        assert getattr(modes, name) == getattr(jax_decoder, name), name


@pytest.mark.parametrize("n2", [120, 240, 480, 960])
def test_mdct_matrices_equal_originals(n2):
    np.testing.assert_array_equal(mdct.imdct_matrix(n2),
                                  jax_mdct.imdct_matrix(n2))
    np.testing.assert_array_equal(mdct.mdct_matrix(n2),
                                  jax_mdct.mdct_matrix(n2))


def test_plan_transforms_equal_originals():
    assert plan.TIERS == jax_plan_pack.TIERS
    assert plan._ORDERY == jax_bands._ORDERY
    rng = np.random.default_rng(2)
    eb = modes.EBAND5MS
    for M in (1, 2, 4, 8):
        assert plan.combos_for_m(M) == jax_plan_pack.combos_for_m(M)
        for n_band in sorted({M * (eb[i + 1] - eb[i]) for i in range(21)}
                             - {1}):
            for b0, tf in plan.combos_for_m(M):
                for copy_fn, orig_fn in (
                        (plan._pre_transforms, jax_plan._pre_transforms),
                        (plan._post_transforms, jax_plan._post_transforms)):
                    v = rng.standard_normal(n_band)
                    got, want = v.copy(), v.copy()
                    try:
                        orig_fn(want, n_band, b0, tf)
                    except Exception as exc:  # rejected combos stay so
                        with pytest.raises(type(exc)):
                            copy_fn(got, n_band, b0, tf)
                        continue
                    copy_fn(got, n_band, b0, tf)
                    np.testing.assert_array_equal(got, want)
    # the combo operators built through the copies
    for frame in (240, 480):
        for got, want in zip(_tables.plan_combo_mats_np(frame),
                             band_exec_jax._plan_combo_mats_np(frame)):
            np.testing.assert_array_equal(got, want)


@contextlib.contextmanager
def _both_profiles(profile):
    """Set the plan profile of the port's host library and of the JAX
    package's, then restore both to the full profile."""
    host_native.set_plan_profile(*profile)
    jax_host_native.set_plan_profile(*profile)
    try:
        yield
    finally:
        host_native.set_plan_profile()
        jax_host_native.set_plan_profile()


@pytest.mark.parametrize("profile", [(None, None, None), SERVING_PROFILE])
def test_arena_layouts_equal_originals(profile):
    assert host_native._PLANE_DTYPES == jax_host_native._PLANE_DTYPES
    assert tuple(host_native._PTR_ORDER) == tuple(jax_host_native._PTR_ORDER)
    with _both_profiles(profile):
        assert host_native.get_plan_profile() \
            == jax_host_native.get_plan_profile()
        for S, C, frame in ((1, 2, 960), (3, 2, 960), (256, 2, 960),
                            (5, 1, 120)):
            assert host_native.plan_arena_layout(S, C, frame) \
                == jax_host_native.plan_arena_layout(S, C, frame)
            assert host_native.arena_word_layout(S, C, frame) \
                == jax_host_native.arena_word_layout(S, C, frame)


@pytest.mark.parametrize("name", ["celt_host.cpp", "celt_tables.h",
                                  "silk_host.cpp", "silk_tables.h",
                                  "opus_host.cpp"])
def test_host_sources_equal_originals(name):
    with open(os.path.join(_ROOT, "native", name), "rb") as fh:
        want = fh.read()
    with open(os.path.join(_ROOT, "mousiki_tpu_torch", "csrc", name),
              "rb") as fh:
        assert fh.read() == want


# files under hostcodec/ that are the port's own, with the reason
_HOSTCODEC_OWN = {
    "__init__.py": "the subpackage's docstring (the original is the JAX "
                   "package's top-level __init__)",
    "silk/host_native.py": "finds the native SILK library through the "
                           "port's ops/_build.load_host, not native/",
    "dred.py": "re-exports the port's DredEncoder, OpusDred, "
               "opus_dred_parse and opus_dred_process "
               "(mousiki_tpu_torch/dred.py)",
    "models/__init__.py": "the subpackage of the shims below",
    "models/deep_plc.py": "builds the port's DeepPlcState on its model's "
                          "device (else the GPU), where the copied "
                          "opus_decoder.py names no device",
    "models/dred.py": "re-exports DRED_EXTENSION_ID of the port's "
                      "models/dred.py",
    "ops/input_resampler.py": "re-exports the port's ArbitraryResampler "
                              "(mousiki_tpu_torch/ops/input_resampler.py)",
    "utils/__init__.py": "makes utils/ a package (the original is a "
                         "namespace directory), so that the import guard "
                         "walks into debug.py",
}


# docstring lines of a copy that differ from the original: (pattern of the
# original, its text in the copy)
_HOSTCODEC_LINE_EDITS = {
    # the original gives the reference source by an absolute directory
    "silk/nsq_del_dec.py": [
        (rb"\(`/\w+/reference/src/silk/nsq_del_dec\.rs:83`",
         b"(`src/silk/nsq_del_dec.rs:83`")],
    # a word of the original's docstring, reworded in the copy
    "celt/modes.py": [
        (rb"libopus's custom-mode \w+ does\)",
         b"libopus's custom-mode constructor does)")],
    # the same word, twice, in the docstrings of the typed API
    "codec.py": [
        (rb"Encoder/Decoder \+\n\w+s with Application",
         b"Encoder/Decoder +\nsetters with Application"),
        (rb"facade over OpusEncoder \(\w+-style setters\)",
         b"facade over OpusEncoder (chainable setters)")],
}


def _hostcodec_files():
    base = os.path.join(_ROOT, "mousiki_tpu_torch", "hostcodec")
    out = []
    for folder, _, names in os.walk(base):
        out += [os.path.relpath(os.path.join(folder, n), base)
                .replace(os.sep, "/") for n in names if n.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("rel", _hostcodec_files())
def test_hostcodec_file_equals_original(rel):
    """Every file of the copied host codec equals its original byte for
    byte, apart from four reworded docstring lines (listed); the port's
    own files there are listed by name."""
    with open(os.path.join(_ROOT, "mousiki_tpu_torch", "hostcodec", rel),
              "rb") as fh:
        got = fh.read()
    if rel in _HOSTCODEC_OWN:
        assert b"mousiki_tpu." not in got.replace(b"mousiki_tpu_torch", b"")
        return
    with open(os.path.join(_ROOT, "mousiki_tpu", rel), "rb") as fh:
        want = fh.read()
    for original, copy in _HOSTCODEC_LINE_EDITS.get(rel, ()):
        want, n = re.subn(original, copy, want)
        assert n == 1, (rel, original)
    assert got == want, rel


def test_hostcodec_is_the_encoder_closure():
    """The closure of OpusEncoder: its SILK encoder (38 files), the
    modules its other branches import (input resampler, repacketizer,
    extensions, tonality analysis, DRED); then the single-stream API on
    top of it (16 files: OpusDecoder with softclip and the deep-PLC shim,
    codec, ctl, utils/debug, multistream, projection, the Ogg containers,
    lightweight, celt/custom); the plan recorder and packer that the
    copied CELT decoder and the native plan packer's tests need
    (celt/plan, celt/plan_pack); the libopus oracle (testing/); and
    nothing else."""
    files = _hostcodec_files()
    assert len(files) == 66 and set(_HOSTCODEC_OWN) <= set(files)
    for rel in ("opus_encoder.py", "silk/encoder.py", "silk/nsq_del_dec.py",
                "silk/noise_shape.py", "celt/encoder.py",
                "bitstream/entcode.py", "bitstream/extensions.py",
                "bitstream/repacketizer.py", "analysis.py",
                "analysis_tables.py", "dred.py", "models/dred.py",
                "ops/input_resampler.py", "opus_decoder.py", "softclip.py",
                "models/deep_plc.py", "codec.py", "ctl.py", "utils/debug.py",
                "multistream.py", "projection.py", "projection_tables.py",
                "containers/__init__.py", "containers/ogg.py",
                "containers/picture.py", "containers/opusfile.py",
                "lightweight.py", "celt/custom.py", "celt/plan.py",
                "celt/plan_pack.py", "testing/__init__.py",
                "testing/oracle.py"):
        assert rel in files


@pytest.mark.parametrize("rel", ["models/lpcnet_features.py"])
def test_port_file_equals_original(rel):
    """Files of the port outside hostcodec/ that are byte copies."""
    with open(os.path.join(_ROOT, "mousiki_tpu_torch", rel), "rb") as fh:
        got = fh.read()
    with open(os.path.join(_ROOT, "mousiki_tpu", rel), "rb") as fh:
        assert got == fh.read()


def test_neural_numpy_parts_equal_originals():
    """The numpy parts of models/nnet.py, models/dred.py and
    ops/input_resampler.py, held to the reference's by behaviour: the
    weight blob written and parsed alike, the densifiers, the DRED
    constants and synthetic stats, the resampler's filter banks."""
    from mousiki_tpu.models import dred as jax_dred
    from mousiki_tpu.models import nnet as jax_nnet
    from mousiki_tpu.ops import input_resampler as jax_rs
    from mousiki_tpu_torch.models import dred, nnet
    from mousiki_tpu_torch.ops import input_resampler as rs

    rng = np.random.default_rng(3)
    arrays = {"dense1_weights_float": rng.standard_normal(12).astype(
                  "<f4").tobytes(),
              "dense1_bias": np.ones(3, "<f4").tobytes(),
              "x" * 40: b"\x01\x02", "odd": bytes(range(65))}
    blob = nnet.write_weight_blob(arrays)
    assert blob == jax_nnet.write_weight_blob(arrays)
    assert nnet.parse_weight_blob(blob) == jax_nnet.parse_weight_blob(blob) \
        == arrays
    for bad in (blob[:40], blob[:-100]):
        for parse in (nnet.parse_weight_blob, jax_nnet.parse_weight_blob):
            with pytest.raises(ValueError):
                parse(bad)
    w8 = rng.integers(-127, 128, 4 * 32, np.int8)
    scale = rng.uniform(1e-3, 1e-2, 16).astype(np.float32)
    idx = np.array([2, 0, 8, 2, 4, 12], np.int32)
    np.testing.assert_array_equal(
        nnet._densify_sparse8x4(w8, idx, 16, scale),
        jax_nnet._densify_sparse8x4(w8, idx, 16, scale))
    np.testing.assert_array_equal(
        nnet._densify_dense8x4(w8, 16, 8, scale),
        jax_nnet._densify_dense8x4(w8, 16, 8, scale))
    for name in [n for n in dir(jax_dred) if n.startswith(("DRED_", "_ENC",
                                                           "_DEC", "_G",
                                                           "_CONV"))]:
        assert getattr(dred, name) == getattr(jax_dred, name), name
    for seed in (0, 1, 7):
        for a, b in zip(dred.synthetic_stats(seed),
                        jax_dred.synthetic_stats(seed)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert rs._QUALITY == jax_rs._QUALITY
    for rate, out, q in ((16000, 48000, 5), (44100, 48000, 7),
                         (48000, 16000, 5), (96000, 48000, 3)):
        for got, want in zip(rs._design(rate, out, q),
                             jax_rs._design(rate, out, q)):
            np.testing.assert_array_equal(got, want)


def test_encode_front_constants_equal_originals():
    from mousiki_tpu.celt import encoder as jax_encoder
    assert modes.COMBFILTER_MINPERIOD == jax_decoder.COMBFILTER_MINPERIOD
    assert modes.COMBFILTER_MAXPERIOD == jax_decoder.COMBFILTER_MAXPERIOD
    np.testing.assert_array_equal(
        _tables.COMB_GAINS, np.asarray(jax_decoder._COMB_GAINS, np.float32))
    np.testing.assert_array_equal(
        _tables.TRANSIENT_INV_TABLE,
        np.asarray(jax_encoder._TRANSIENT_INV_TABLE, np.float32))
    from mousiki_tpu.ops import silk_nsq_jax
    from mousiki_tpu_torch.ops import silk_nsq
    for name in ("LTP_ORDER", "SHAPE_ORDER", "LPC_ORDER", "DECISION_DELAY",
                 "MAX_DD_STATES", "QUANT_LEVEL_ADJUST"):
        assert getattr(silk_nsq, name) == getattr(silk_nsq_jax, name), name
    assert silk_nsq.RAND_MULTIPLIER == int(silk_nsq_jax.RAND_MULTIPLIER)
    assert silk_nsq.RAND_INCREMENT == int(silk_nsq_jax.RAND_INCREMENT)
    assert silk_nsq.BIG_RD == float(silk_nsq_jax.BIG_RD)
    assert silk_nsq.NsqParams._fields == silk_nsq_jax.NsqParams._fields
    assert silk_nsq.NsqDevState._fields == silk_nsq_jax.NsqDevState._fields
    assert silk_nsq.NsqDelDecState._fields \
        == silk_nsq_jax.NsqDelDecState._fields


@pytest.mark.parametrize("frame", [480, 960])
def test_encode_front_device_constants_equal_jax(frame):
    from mousiki_tpu_torch.ops import encode_front
    got = encode_front.make_front_consts(frame, "cpu")
    want = encode_front_jax.make_front_consts(frame)
    np.testing.assert_array_equal(got["window2"].numpy(),
                                  np.asarray(want["window2"]))
    np.testing.assert_array_equal(got["inv_table"].numpy(),
                                  np.asarray(want["inv_table"]))
    np.testing.assert_array_equal(got["comb_gains"].numpy(),
                                  np.asarray(want["comb_gains"]))
    for nb in (frame, 120):
        np.testing.assert_array_equal(got[f"FT{nb}"].numpy().T,
                                      np.asarray(want[f"F{nb}"]))
        for g, w in zip(got[f"fold{nb}"], want[f"fold{nb}"]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_silk_tables_equal_originals():
    from mousiki_tpu.silk import tables as jax_tables
    from mousiki_tpu_torch.silk import tables
    names = [n for n in dir(tables) if n.isupper()]
    assert sorted(names) == ["SILK_RESAMPLER_FRAC_FIR_12",
                             "SILK_RESAMPLER_UP2_HQ_0",
                             "SILK_RESAMPLER_UP2_HQ_1"]
    for name in names:
        assert getattr(tables, name) == getattr(jax_tables, name), name


def test_parse_packet_equals_original():
    """Every golden packet, and packets of every frame-count code built
    from them (code 1, code 2, code 3 CBR/VBR with padding), parse as the
    original does; malformed ones raise on both sides."""
    from mousiki_tpu.bitstream import packet as jax_packet
    from mousiki_tpu_torch.bitstream import packet
    with np.load(os.path.join(_ROOT, "tests", "fixtures",
                              "golden.npz")) as g:
        packets = []
        for name in g["__manifest_names"]:
            blob, pos = g[f"{name}__packets"].tobytes(), 0
            for n in g[f"{name}__lens"]:
                packets.append(blob[pos:pos + int(n)])
                pos += int(n)
    assert len(packets) == 96
    built = []
    for a, b in zip(packets[::2], packets[1::2]):
        toc, fa, fb = a[0] & 0xFC, a[1:], b[1:]
        built.append(bytes([toc | 1]) + fa + fa)                    # code 1
        if len(fa) < 252:
            built.append(bytes([toc | 2, len(fa)]) + fa + fb)       # code 2
            built.append(bytes([toc | 3, 0x80 | 0x40 | 2, 3, len(fa)])
                         + fa + fb + b"\0\0\0")                     # code 3
        built.append(bytes([toc | 3, 3]) + fa * 3)                  # CBR
    bad = [b"", bytes([packets[0][0] | 1]) + b"abc",
           bytes([packets[0][0] | 2, 200]) + b"ab",
           bytes([packets[0][0] | 3]), bytes([packets[0][0] | 3, 0])]
    for data in packets + built:
        got, want = packet.parse_packet(data), jax_packet.parse_packet(data)
        for field in ("toc", "frames", "payload_offset", "packet_offset",
                      "padding"):
            assert getattr(got, field) == getattr(want, field), field
    for data in bad:
        with pytest.raises(jax_packet.InvalidPacket):
            jax_packet.parse_packet(data)
        with pytest.raises(packet.InvalidPacket):
            packet.parse_packet(data)


_BLOCK_JAX = r"""
import importlib, pkgutil, sys

_BLOCKED = ("jax", "jaxlib", "mousiki_tpu")

class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in _BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Blocked())
import mousiki_tpu_torch
names = ["mousiki_tpu_torch"]
for info in pkgutil.walk_packages(mousiki_tpu_torch.__path__,
                                  "mousiki_tpu_torch."):
    names.append(info.name)
# the smoke run, its fixture loader and the bench import nothing of JAX
# either
for name in names + ["golden_streams", "chip_smoke", "bench_torch"]:
    importlib.import_module(name)
for name in ("mousiki_tpu_torch.hostcodec.opus_encoder",
             "mousiki_tpu_torch.ops.encode_front",
             "mousiki_tpu_torch.ops.silk_nsq",
             "mousiki_tpu_torch.parallel.nsq_batch",
             "mousiki_tpu_torch.models.nnet",
             "mousiki_tpu_torch.models.fargan",
             "mousiki_tpu_torch.models.deep_plc",
             "mousiki_tpu_torch.models.dred",
             "mousiki_tpu_torch.models.lpcnet_features",
             "mousiki_tpu_torch.ops.input_resampler",
             "mousiki_tpu_torch.dred",
             "mousiki_tpu_torch.parallel.deep_recovery",
             "mousiki_tpu_torch.hostcodec.dred",
             "mousiki_tpu_torch.hostcodec.models.dred",
             "mousiki_tpu_torch.hostcodec.ops.input_resampler",
             "mousiki_tpu_torch.hostcodec.analysis",
             "mousiki_tpu_torch.hostcodec.bitstream.extensions",
             "mousiki_tpu_torch.hostcodec.bitstream.repacketizer",
             "mousiki_tpu_torch.hostcodec.softclip",
             "mousiki_tpu_torch.hostcodec.opus_decoder",
             "mousiki_tpu_torch.hostcodec.models.deep_plc",
             "mousiki_tpu_torch.hostcodec.codec",
             "mousiki_tpu_torch.hostcodec.ctl",
             "mousiki_tpu_torch.hostcodec.utils.debug",
             "mousiki_tpu_torch.hostcodec.multistream",
             "mousiki_tpu_torch.hostcodec.projection",
             "mousiki_tpu_torch.hostcodec.projection_tables",
             "mousiki_tpu_torch.hostcodec.containers.ogg",
             "mousiki_tpu_torch.hostcodec.containers.picture",
             "mousiki_tpu_torch.hostcodec.containers.opusfile",
             "mousiki_tpu_torch.hostcodec.lightweight",
             "mousiki_tpu_torch.hostcodec.celt.custom",
             "mousiki_tpu_torch.ops.ec_lockstep",
             "mousiki_tpu_torch.ops.celt_lockstep",
             "mousiki_tpu_torch.ops.celt_lockstep_walk",
             "mousiki_tpu_torch.ops.celt_lockstep_emit",
             "mousiki_tpu_torch.ops.celt_lockstep_top",
             "mousiki_tpu_torch.hostcodec.celt.plan",
             "mousiki_tpu_torch.hostcodec.celt.plan_pack",
             "mousiki_tpu_torch.hostcodec.testing.oracle",
             "mousiki_tpu_torch.parallel.streaming",
             "mousiki_tpu_torch.bench"):
    assert name in sys.modules, name
# every top-level name of the reference resolves without it
for name in mousiki_tpu_torch.__all__:
    getattr(mousiki_tpu_torch, name)
assert not any(m.split(".")[0] in _BLOCKED for m in sys.modules)
print("imported", len(names))
"""


def test_port_imports_without_jax():
    """The port, golden_streams, chip_smoke and bench_torch import with
    jax and every module of the JAX package (mousiki_tpu, mousiki_tpu.*)
    refused."""
    proc = subprocess.run([sys.executable, "-c", _BLOCK_JAX], cwd=_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.split()[-1])
    assert n >= 80, proc.stdout


def test_deemphasis_cpu_takes_plain_path():
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((2, 2, 240)).astype(np.float32))
    mem = torch.as_tensor(rng.standard_normal((2, 2)).astype(np.float32))
    deemphasis.reset_launches()
    pcm, m = deemphasis.deemphasis_pcm(x, mem)
    want_pcm, want_m = deemphasis.deemphasis_pcm_reference(x, mem)
    assert deemphasis.deemphasis_launches == 0
    assert torch.equal(pcm, want_pcm) and torch.equal(m, want_m)
    assert pcm.shape == (2, 240, 2) and pcm.is_contiguous()
    with pytest.raises(TypeError):
        deemphasis.deemphasis_pcm(x.double(), mem.double())
    with pytest.raises(ValueError):
        deemphasis.deemphasis_pcm(x, mem[:1])
    with pytest.raises(ValueError):  # three channels
        deemphasis.deemphasis_pcm(torch.zeros(2, 3, 240), torch.zeros(2, 3))


@pytest.mark.cuda
def test_deemphasis_kernel_matches_plain_on_gpu():
    """The fused CUDA kernel against its plain version (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the GPU")
    rng = np.random.default_rng(4)
    for S, C, N in ((256, 2, 960), (256, 2, 120), (7, 1, 960), (3, 2, 240)):
        x = torch.as_tensor((rng.standard_normal((S, C, N)) * 1000)
                            .astype(np.float32), device="cuda")
        mem = torch.as_tensor((rng.standard_normal((S, C)) * 100)
                              .astype(np.float32), device="cuda")
        before = deemphasis.deemphasis_launches
        pcm, m = deemphasis.deemphasis_pcm(x, mem)
        torch.cuda.synchronize()
        assert deemphasis.deemphasis_launches == before + 1
        want_pcm, want_m = deemphasis.deemphasis_pcm_reference(x, mem)
        assert pcm.shape == (S, N, C) and pcm.is_contiguous()
        scale = want_pcm.abs().max().item()
        assert (pcm - want_pcm).abs().max().item() < 1e-4 * scale
        assert (m - want_m).abs().max().item() < 1e-4 * scale * 32768


def test_device_is_required():
    """No default device: leaving it out raises instead of running on
    the CPU. The entry points that host code builds without a device
    (DredEncoder, opus_dred_process, and the DeepPlcState that the copied
    OpusDecoder's set_deep_plc builds) take their model's, and without a
    model the GPU, which raises where there is none."""
    from mousiki_tpu_torch import dred
    from mousiki_tpu_torch.hostcodec.models import deep_plc as plc_shim
    from mousiki_tpu_torch.hostcodec.opus_decoder import OpusDecoder
    from mousiki_tpu_torch.models import deep_plc, fargan, nnet
    from mousiki_tpu_torch.parallel.deep_recovery import BatchedDeepRecovery
    from mousiki_tpu_torch.pipeline import CeltStreamPipeline
    with pytest.raises(TypeError):
        CeltStreamPipeline(3)
    with pytest.raises(ValueError):
        synthesis.make_consts(960, None)
    with pytest.raises(ValueError):
        plc.init_plc_state(3, 2, None)
    from mousiki_tpu_torch.ops import celt_lockstep_top
    with pytest.raises(TypeError):
        celt_lockstep_top.init_state(3)
    with pytest.raises(ValueError):
        celt_lockstep_top.init_state(3, device=None)
    with pytest.raises(TypeError):
        BatchedDeepRecovery(3)
    with pytest.raises(ValueError):
        BatchedDeepRecovery(3, device=None)
    with pytest.raises(TypeError):
        deep_plc.DeepPlcState()
    with pytest.raises(TypeError):
        fargan.random_model(torch.Generator())
    with pytest.raises(TypeError):
        nnet.Linear(np.zeros((2, 2)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dred.DredEncoder(48000, 1)
        stats = dred.synthetic_stats()
        payload = dred.dred_encode([np.zeros(24)], np.zeros(24), stats)
        parsed = dred.OpusDred(dred.dred_parse(payload, stats), payload)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dred.opus_dred_process(parsed)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            plc_shim.DeepPlcState()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            OpusDecoder(48000, 1).set_deep_plc(None)
    cpu_model = dred.M.random_enc(torch.Generator().manual_seed(0),
                                  device="cpu")
    assert dred.DredEncoder(48000, 1, model=cpu_model).device.type == "cpu"
    gen = torch.Generator().manual_seed(2)
    cpu_fargan = fargan.random_model(gen, device="cpu")
    cpu_pitch = deep_plc.random_pitchdnn(gen, device="cpu")
    for models in ((cpu_fargan, None), (None, cpu_pitch),
                   (cpu_fargan, cpu_pitch)):
        dec = OpusDecoder(48000, 1)
        dec.set_deep_plc(*models)
        assert isinstance(dec.deep_plc, deep_plc.DeepPlcState)
        assert dec.deep_plc.device.type == "cpu"
        assert dec.deep_plc.pitch_state.device.type == "cpu"
