"""The port's bench (mousiki_tpu_torch/bench.py, bench_torch.py) against
the JAX package's bench.py, on the CPU: its helpers equal bench.py's, its
quality gate agrees with the JAX pipeline's on the same frames, its one
JSON line carries every key of bench.py's end-to-end branch, it has no
fallback, and its committed libopus fixture is whole (every payload is
its packet's CELT frame, and the copied OpusDecoder reaches libopus's
final range on all 320 packets)."""

import ast
import inspect
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

import bench as jax_bench
from mousiki_tpu.celt import host_native as jax_host_native
from mousiki_tpu.pipeline import CeltStreamPipeline as JaxPipeline
from mousiki_tpu_torch import bench
from mousiki_tpu_torch.bitstream.packet import parse_packet
from mousiki_tpu_torch.celt import host_native
from mousiki_tpu_torch.hostcodec.opus_decoder import OpusDecoder
from mousiki_tpu_torch.pipeline import SERVING_PROFILE
from torch_threads import one_torch_thread  # noqa: F401

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "tools"))
from opus_compare import compare  # noqa: E402

# tests/test_pipeline.py's bar for the plan pipeline's PCM
PCM_TOL = 2e-4
GATE_TOL = 1e-4


@pytest.fixture(scope="module")
def fx():
    return bench.load_fixture()


@pytest.fixture
def serving():
    """The serving plan profile in both packages' native libraries (each
    has its own globals), restored afterwards."""
    host_native.set_plan_profile(*SERVING_PROFILE)
    jax_host_native.set_plan_profile(*SERVING_PROFILE)
    try:
        yield
    finally:
        host_native.set_plan_profile()
        jax_host_native.set_plan_profile()


def test_helpers_equal_bench_py():
    rng = np.random.default_rng(4)
    pcm = rng.standard_normal((960 * 5, 2)).astype(np.float32)
    got, want = bench.downmix_16k(pcm), jax_bench.downmix_16k(pcm)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    got, want = bench.load_corpus(), jax_bench.load_corpus()
    assert got.shape == (200 * 960, 2) and np.array_equal(got, want)


def test_fixture_payloads_are_their_packets_frames(fx):
    for name in bench.SIGNALS:
        sig = fx[name]
        assert len(sig["packets"]) == len(sig["payloads"]) \
            == len(sig["final_range"])
        for packet, payload in zip(sig["packets"], sig["payloads"]):
            assert parse_packet(packet).frames[0] == payload
    assert [len(fx[name]["packets"]) for name in bench.SIGNALS] == [48, 200]
    assert fx["mixed"]["final_range"].shape == (3, 24)
    assert fx["libopus"].startswith("libopus")


@pytest.mark.parametrize("name", ["synthetic", "corpus", "mixed"])
def test_copied_decoder_reaches_libopus_final_range(fx, name):
    """48 + 200 stereo and 3 x 24 mono packets: the final range of the
    copied single-stream decoder equals the one libopus stored."""
    if name == "mixed":
        streams = [(1, packets, ranges) for packets, ranges in
                   zip(fx["mixed"]["packets"], fx["mixed"]["final_range"])]
    else:
        streams = [(2, fx[name]["packets"], fx[name]["final_range"])]
    for channels, packets, ranges in streams:
        dec = OpusDecoder(48000, channels)
        for i, (packet, want) in enumerate(zip(packets, ranges)):
            dec.decode(packet, 960)
            assert dec.final_range == int(want), (name, i)


def test_fixture_round_trips(fx, tmp_path):
    path = str(tmp_path / "fx.npz")
    bench.save_fixture(path, fx)
    again = bench.load_fixture(path)
    assert again["libopus"] == fx["libopus"]
    for name in bench.SIGNALS:
        for key, value in fx[name].items():
            if isinstance(value, list):
                assert again[name][key] == value
            else:
                assert np.array_equal(again[name][key], value)
    assert again["mixed"]["packets"] == fx["mixed"]["packets"]


def test_gate_agrees_with_jax_pipeline(fx, serving):
    """The first 16 synthetic frames at gs = 8: the port's _gate_one, the
    JAX pipeline's scanned decode and libopus's reference, both PCMs
    through bench.py's own downmix and opus_compare."""
    n = bench.QUICK.gate_frames
    pays = fx["synthetic"]["payloads"][:n]
    ref16k = fx["synthetic"]["ref16k_quick"]
    got_r, got = bench._gate_one(pays, ref16k, torch.device("cpu"))
    pipe = JaxPipeline(8, channels=2, use_plan=True)
    want = np.asarray(pipe.decode_frames_scanned([[p] * 8 for p in pays],
                                                 960))[:, 0].reshape(-1, 2)
    assert got.shape == want.shape == (n * 960, 2)
    assert np.abs(got - want).max() < PCM_TOL
    r_port = compare(32768.0 * ref16k, 32768.0 * jax_bench.downmix_16k(got))
    r_jax = compare(32768.0 * ref16k, 32768.0 * jax_bench.downmix_16k(want))
    assert r_port == got_r
    assert r_port["ok"] == r_jax["ok"]
    assert r_port["ok"]
    for key in ("err4", "err16", "pitch"):
        assert abs(r_port[key] - r_jax[key]) <= GATE_TOL, key


def _bench_py_keys():
    """(keys of bench.py's `result` dict with their literal values, keys
    of its end-to-end `result.update`), read from its source."""
    tree = ast.parse(inspect.getsource(jax_bench))
    base, e2e = {}, set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "result"
                and isinstance(node.value, ast.Dict)):
            for k, v in zip(node.value.keys, node.value.values):
                base[k.value] = (v.value if isinstance(v, ast.Constant)
                                 else None)
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "update"
                and getattr(node.func.value, "id", None) == "result"):
            keys = {k.value for k in node.args[0].keys}
            if "quality_gate" in keys:
                e2e = keys
    return base, e2e


def test_main_line_carries_bench_py_keys(capsys, serving):
    base, e2e = _bench_py_keys()
    assert "value_stream_20ms" in e2e and "metric" in base
    assert bench.main(["4", "--device", "cpu", "--quick", "--s-big",
                       "8"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    for key in ("metric", "unit"):
        assert line[key] == base[key]
    assert line["device"] == "cpu" and line["streams"] == 4
    assert line["quick"] is True and line["gate_frames"] == 16
    assert line["quality_gate"] == "pass"
    assert set(line["quality"]) == {"err4", "err16", "pitch",
                                    "corpus_err4", "corpus_err16"}
    numeric = (set(base) | e2e) - {"metric", "unit", "device",
                                   "quality_gate", "quality"}
    for key in sorted(numeric) + [f"quality.{k}" for k in line["quality"]]:
        value = (line["quality"][key[8:]] if key.startswith("quality.")
                 else line[key])
        assert isinstance(value, (int, float)) and math.isfinite(value), \
            (key, value)
    assert line["value"] == max(line["value_stream_20ms"],
                                line["value_chunk4_80ms"],
                                line["value_chunk8_160ms"])


def test_missing_fixture_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="gen_torch_bench_fixture"):
        bench.load_fixture(str(tmp_path / "missing.npz"))


def test_main_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["4", "--quick"])


def test_bench_has_no_fallback():
    """No exception handler anywhere in the bench: a failure ends the
    run."""
    for path in ("mousiki_tpu_torch/bench.py", "bench_torch.py"):
        with open(os.path.join(_ROOT, path)) as fh:
            src = fh.read()
        assert "except Exception" not in src, path
        assert not any(isinstance(node, ast.ExceptHandler)
                       for node in ast.walk(ast.parse(src))), path


def test_quick_gate_takes_only_its_frames(fx):
    with pytest.raises(ValueError, match="16"):
        bench.quality_gate(fx, torch.device("cpu"), 8)


def test_plan_batch_call_equals_decode_plan_arenas(fx):
    """The native call alone writes the arenas a plan decode writes."""
    pays = fx["synthetic"]["payloads"][:4]
    a = host_native.NativeCeltHostBatch(4, channels=2, n_threads=1)
    b = host_native.NativeCeltHostBatch(4, channels=2, n_threads=1)
    for _ in range(2):
        want, _, _ = a.decode_plan_arenas(pays, 960)
        b.plan_batch_call(pays, 960)()
        got = b._plan_db[960][1][0][0]
        assert np.array_equal(got["backing"], want["backing"])
