"""The copied plan recorder and packer (hostcodec/celt/plan.py,
hostcodec/celt/plan_pack.py) on the golden CELT packets: the port's
CeltDecoder(record_plan=True) against the JAX package's, field for field;
the port's pack_plans against the reference's, array for array; and the
port's pack_plans against the planes of the port's native decode_plan_arenas
(unpacked by ops/band_exec.unpack_plan_arenas on the CPU), the check
tests/test_native_plan.py makes for the reference.

Bars: exact equality throughout (the same float64 decoder, the same
packer, the same native library source).
"""

import dataclasses

import numpy as np
import pytest
import torch

from golden_streams import load_mono_mix, load_stereo_celt
from mousiki_tpu.celt.decoder import CeltDecoder as JaxCeltDecoder
from mousiki_tpu.celt.plan_pack import pack_plans as jax_pack_plans
from mousiki_tpu_torch.celt import host_native
from mousiki_tpu_torch.hostcodec.celt.decoder import CeltDecoder
from mousiki_tpu_torch.hostcodec.celt.plan_pack import pack_plans
from mousiki_tpu_torch.ops.band_exec import split_backing, unpack_plan_arenas
from mousiki_tpu_torch.pipeline import set_plan_profile
from torch_threads import one_torch_thread  # noqa: F401

# the three stereo CELT streams and the mono CELT stream of the fixture
STREAMS = ("celt_fb_stereo_128k", "celt_low_48k", "audio_music_96k",
           "celt_fb_mono_64k")

# tests/test_native_plan.py's plane list and its masks of inactive slots
KEYS = ["direct", "pvq_active", "pvq_n", "pvq_k", "pvq_b", "pvq_spread",
        "pvq_gain", "pvq_idx", "pvq_dst", "call_active", "call_has_lb",
        "call_lb_src", "call_lb_buf", "call_blend_upto", "call_pre",
        "call_post", "call_norm_write", "call_norm_buf", "fill_active",
        "fill_fold", "fill_off", "fill_n", "fill_gain", "fill_seed",
        "merge_active", "merge_mid", "merge_inv", "theta2_active",
        "theta2_cswap", "theta2_sign", "theta2_mid", "theta2_side",
        "theta2_inv", "n1_active", "n1_val", "ac_on", "ac_masks", "ac_r",
        "ac_seed"]
_GATES = {
    "call_lb_src": "call_has_lb", "call_lb_buf": "call_has_lb",
    "call_blend_upto": "call_has_lb",
    "call_pre": "call_active", "call_post": "call_active",
    "call_norm_buf": "call_norm_write",
    "fill_fold": "fill_active", "fill_off": "fill_active",
    "fill_n": "fill_active", "fill_gain": "fill_active",
    "fill_seed": "fill_active",
    "merge_mid": "merge_active", "merge_inv": "merge_active",
    "theta2_cswap": "theta2_active", "theta2_sign": "theta2_active",
    "theta2_mid": "theta2_active", "theta2_side": "theta2_active",
    "theta2_inv": "theta2_active",
    "n1_val": "n1_active",
    "ac_masks": "ac_on", "ac_r": "ac_on", "ac_seed": "ac_on",
}


def _masked(key, arr, planes, tier=None):
    """Value planes zeroed where their slot is inactive (stale contents
    are never read by the executor)."""
    arr = np.asarray(arr)
    if key.startswith("pvq_") and key != "pvq_active":
        return np.where(np.asarray(planes["pvq_active"][tier]) != 0, arr, 0)
    gate = _GATES.get(key)
    if gate is None:
        return arr
    g = np.asarray(planes[gate]).astype(bool)
    if key in ("ac_masks", "ac_r", "ac_seed"):
        g = g.reshape((-1,) + (1,) * (arr.ndim - 1))
    while g.ndim < arr.ndim:
        g = g[..., None]
    return np.where(np.broadcast_to(g, arr.shape), arr, 0)


def _stream(name):
    for s in load_stereo_celt() + load_mono_mix():
        if s.name == name:
            return s
    raise KeyError(name)


def _channels(stream):
    return stream.pcm.shape[1]


def _structure(v):
    """A comparable form of a recorded plan: dataclasses by class name and
    fields, arrays by dtype, shape and bytes."""
    if dataclasses.is_dataclass(v):
        return (type(v).__name__, {f.name: _structure(getattr(v, f.name))
                                   for f in dataclasses.fields(v)})
    if isinstance(v, np.ndarray):
        return ("ndarray", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, (list, tuple)):
        return type(v)(_structure(x) for x in v)
    if isinstance(v, dict):
        return {k: _structure(x) for k, x in v.items()}
    if isinstance(v, np.generic):
        return v.item()
    return v


def _record(decoder_cls, stream):
    C = _channels(stream)
    dec = decoder_cls(channels=C, stream_channels=C)
    dec.disable_inv = C == 1
    return [dec.decode_with_ec(p, 960, return_desc=True, record_plan=True)
            for p in stream.payloads]


@pytest.fixture(scope="module")
def full_profile():
    """The full plan profile in the port's native library (pack_plans
    packs at the full tiers); restored afterwards."""
    set_plan_profile()
    try:
        yield
    finally:
        set_plan_profile()


@pytest.mark.parametrize("name", STREAMS)
def test_record_plan_equals_reference(name):
    stream = _stream(name)
    got, want = _record(CeltDecoder, stream), _record(JaxCeltDecoder, stream)
    for f, (g, w) in enumerate(zip(got, want)):
        assert type(g["plan"]).__module__ == \
            "mousiki_tpu_torch.hostcodec.celt.plan"
        assert _structure(g["plan"]) == _structure(w["plan"]), f
        np.testing.assert_array_equal(g["x"], w["x"], err_msg=str(f))
    assert sum(len(d["plan"].ops) for d in got) > 100


@pytest.mark.parametrize("name", STREAMS)
def test_pack_plans_equals_reference(name):
    stream = _stream(name)
    C = _channels(stream)
    got = pack_plans([d["plan"] for d in _record(CeltDecoder, stream)],
                     C, 960)
    want = jax_pack_plans([d["plan"] for d in _record(JaxCeltDecoder,
                                                       stream)], C, 960)
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, list):
            assert len(g) == len(w), key
            for t, (gt, wt) in enumerate(zip(g, w)):
                assert gt.dtype == wt.dtype, (key, t)
                np.testing.assert_array_equal(gt, wt, err_msg=f"{key}[{t}]")
        else:
            assert g.dtype == w.dtype, key
            np.testing.assert_array_equal(g, w, err_msg=key)
    assert not got["direct"].any()


@pytest.mark.parametrize("name", STREAMS)
def test_pack_plans_equals_native_planes(name, full_profile):
    stream = _stream(name)
    C = _channels(stream)
    descs = _record(CeltDecoder, stream)
    batch = host_native.NativeCeltHostBatch(1, channels=C,
                                            disable_inv=C == 1)
    for f, (payload, d) in enumerate(zip(stream.payloads, descs)):
        arenas, aux, _ = batch.decode_plan_arenas([payload], 960)
        assert int(aux["rcs"][0]) == 0, f
        backing = torch.from_numpy(arenas["backing"].copy())
        p, ble, pf_gain, iflags = unpack_plan_arenas(
            *split_backing(backing, channels=C, frame=960, n_streams=1),
            channels=C, frame=960)
        native = {k: ([t.numpy() for t in v] if isinstance(v, list)
                      else v.numpy()) for k, v in p.items()}
        want = pack_plans([d["plan"]], C, 960)
        assert not want["direct"][0] and not native["direct"][0], f
        for key in KEYS:
            if isinstance(want[key], list):
                for t in range(3):
                    np.testing.assert_array_equal(
                        _masked(key, native[key][t], native, t),
                        _masked(key, want[key][t], want, t),
                        err_msg=f"frame {f} {key}[tier {t}]")
            else:
                np.testing.assert_array_equal(
                    _masked(key, native[key], native),
                    _masked(key, want[key], want),
                    err_msg=f"frame {f} {key}")
        # the frame descriptor rides the same arena
        np.testing.assert_allclose(ble.numpy()[0, :C], d["band_log_e"][:C],
                                   atol=1e-5, rtol=0)
        assert abs(float(pf_gain[0]) - float(d["pf_gain"])) < 1e-6
        assert iflags[0].tolist() == [int(d["transient"]),
                                      int(d["silence"]), int(d["pf_pitch"]),
                                      int(d["pf_tapset"])]
