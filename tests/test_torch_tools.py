"""The port's twins of the JAX repo's tools (tools/torch_*.py) against the
reference tools on the CPU.

- codec_bench: the OPUSBEN1 corpus of a 10-frame PCM byte-equal to the
  JAX tool's; `encode` and `decode` print the reference's four keys, as
  text and as CSV;
- opus_packet_tool: the OPUSPKT1 file and its decoded PCM byte-equal to
  the JAX tool's;
- build_dnn_blob: the blob of a synthetic opus_data source (the one of
  tests/test_weight_blob.py) byte-equal to the JAX tool's;
- the lockstep probe: its committed packets equal a fresh libopus encode
  (skipped without libopus), its padded lanes equal the reference tool's
  construction, a bitrate the fixture lacks raises, and one step at
  S = 2 (slow) decodes every lane within 2e-4 of the port's plan
  pipeline (the step itself is held to JAX by
  tests/test_torch_celt_lockstep.py).
"""

import os
import sys

import numpy as np
import pytest

from mousiki_tpu_torch.hostcodec.testing import oracle
from mousiki_tpu_torch.pipeline import CeltStreamPipeline
from mousiki_tpu_torch.repo_files import load_script
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 10
KEYS = ("median_ns_per_frame", "p95_ns_per_frame", "median_packets_per_sec",
        "median_realtime_x")
GOLDEN_TOL = 2e-4


@pytest.fixture(scope="module")
def pcm_s16(tmp_path_factory):
    """10 frames of 48 kHz stereo 16-bit PCM (the copied oracle's seeded
    test signal)."""
    path = tmp_path_factory.mktemp("pcm") / "in.s16"
    sig = oracle.make_test_signal(960 * N_FRAMES, 2, seed=11)
    path.write_bytes(oracle.float_to_i16(sig).astype("<i2").tobytes())
    return str(path)


def _run_reference(module, monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", argv)
    module.main()


def test_codec_bench_corpus_and_keys(tmp_path, pcm_s16, monkeypatch, capsys):
    twin = load_script("tools/torch_codec_bench.py")
    ref = load_script("tools/codec_bench.py")
    got, want = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    twin.main(["packets", "--input", pcm_s16, "--output", got])
    _run_reference(ref, monkeypatch, ["codec_bench", "packets", "--input",
                                      pcm_s16, "--output", want])
    out = capsys.readouterr().out.splitlines()
    assert out == [f"wrote {N_FRAMES} packets to {got}",
                   f"wrote {N_FRAMES} packets to {want}"]
    assert open(got, "rb").read() == open(want, "rb").read()
    hdr, packets = twin.read_corpus(got)
    assert hdr == ref.read_corpus(want)[0] and len(packets) == N_FRAMES
    for cmd, inp in (("encode", pcm_s16), ("decode", got)):
        twin.main([cmd, "--input", inp, "--warmup", "0", "--measure", "1"])
        text = capsys.readouterr().out.splitlines()
        assert [line.split(":")[0] for line in text] == list(KEYS), cmd
        assert all(float(line.split(":")[1]) > 0 for line in text)
        twin.main([cmd, "--input", inp, "--warmup", "0", "--measure", "1",
                   "--format", "csv"])
        head, row = capsys.readouterr().out.splitlines()
        assert head.split(",") == list(KEYS), cmd
        assert len(row.split(",")) == 4


def test_opus_packet_tool_matches_jax(tmp_path, pcm_s16, capsys):
    twin = load_script("tools/torch_opus_packet_tool.py")
    ref = load_script("tools/opus_packet_tool.py")
    files = {side: (str(tmp_path / f"{side}.pkt"),
                    str(tmp_path / f"{side}.s16")) for side in ("port", "jax")}
    twin.main(["encode", pcm_s16, files["port"][0]])
    ref.encode(pcm_s16, files["jax"][0])
    twin.main(["decode", files["port"][0], files["port"][1]])
    ref.decode(files["jax"][0], files["jax"][1])
    assert capsys.readouterr().out.splitlines() == [
        f"encoded {N_FRAMES} packets"] * 2 + [
        f"decoded {N_FRAMES} packets"] * 2
    for got, want in zip(files["port"], files["jax"]):
        data = open(got, "rb").read()
        assert data == open(want, "rb").read()
    assert len(data) == 2 * 2 * 960 * N_FRAMES
    assert np.abs(np.frombuffer(data, "<i2")).max() > 1000


# tests/test_weight_blob.py:237-260
_SOURCE = '''
/* generated-ish */
const float dec_dense1_weights_float[6] = {
  1.0f, -2.5f, 3e-2f, 0.0f, /* mid */ 4.f, -0.125f
};
const opus_int8 dec_gru1_input_weights[4] = {1, -2, 127, -128};
const int dec_gru1_input_weights_idx[3] = {1, 0, 8};
const opus_uint8 some_table[2] = {0x10, 255};
static const float not_const_prefixed[2] = {9.0f, 8.0f};
'''


def test_build_dnn_blob_matches_jax(tmp_path, capsys):
    twin = load_script("tools/torch_build_dnn_blob.py")
    ref = load_script("tools/build_dnn_blob.py")
    src = tmp_path / "opus_data"
    src.mkdir()
    (src / "dred_rdovae_dec_data.c").write_text(_SOURCE)
    out = tmp_path / "blob.bin"
    twin.main([str(src), str(out)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "dred_rdovae_dec_data.c: 5 arrays"
    assert lines[1].startswith(f"wrote {out}: {out.stat().st_size} bytes")
    assert out.read_bytes() == ref.build_blob(str(src))
    from mousiki_tpu_torch.models.nnet import parse_weight_blob
    arrays = parse_weight_blob(out.read_bytes())
    assert np.array_equal(np.frombuffer(arrays["dec_gru1_input_weights"],
                                        np.int8), [1, -2, 127, -128])


@pytest.fixture(scope="module")
def probe():
    return load_script("tools/torch_bench_lockstep.py")


def test_lockstep_fixture_is_a_fresh_libopus_encode(probe):
    if not oracle.available():
        pytest.skip("no system libopus to encode with")
    gen = load_script("tools/gen_torch_lockstep_fixture.py")
    fresh = gen.make_fixture()
    fx = probe.load_fixture()
    assert fx == fresh
    assert fx["bitrate"] == probe.BITRATE and len(fx["packets"]) == 32


def test_lockstep_lanes_are_the_reference_tools(probe):
    """The padding block of tools/bench_lockstep.py (from `L = 512` to the
    device) run on the fixture's payloads, against the twin's pad."""
    src = open(os.path.join(ROOT, "tools", "bench_lockstep.py")).read()
    block = src[src.index("L = 512"): src.index("dev = jax.devices()")]
    pkts = probe.load_payloads()
    for S in (2, 40):
        scope = {"np": np, "S": S, "pkts": pkts}
        exec(block, scope)
        buf, st = probe.pad(pkts, S)
        assert buf.dtype == scope["buf"].dtype
        assert st.dtype == scope["st"].dtype
        np.testing.assert_array_equal(buf, scope["buf"])
        np.testing.assert_array_equal(st, scope["st"])
    with pytest.raises(ValueError, match="--bitrate 64000"):
        probe.load_payloads(64000)


@pytest.mark.slow
def test_lockstep_probe_step(probe, capsys):
    S = 2
    res = probe.run(S, device="cpu", iters=1, trials=1)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu" and lines[1].startswith("compile+first:")
    assert lines[2].startswith("step: ") and lines[3] == "ok(first step): True"
    assert res["ok_all"] and len(res["step_ms"]) == 1
    pays = probe.load_payloads()
    want = CeltStreamPipeline(S, use_plan=True, device="cpu").step(
        [pays[s % len(pays)] for s in range(S)])
    assert res["pcm"].shape == want.shape == (S, 960, 2)
    assert (res["pcm"] - want).abs().max().item() <= GOLDEN_TOL
