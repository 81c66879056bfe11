"""mousiki_tpu_torch/bench.py: its main line carries bench.py's keys, it
raises without a GPU and has no fallback, the quick gate's frames, and
the host's batch call (split from tests/test_torch_bench.py so that the
tier-1 suite's files stay short).
"""

import ast
import json
import math
import os

import numpy as np
import pytest
import torch

from mousiki_tpu_torch import bench
from mousiki_tpu_torch.celt import host_native
from test_torch_bench import (_ROOT, _bench_py_keys, fx,  # noqa: F401
                              serving)
from torch_threads import one_torch_thread  # noqa: F401


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
