"""The port's twins of the JAX repo's examples (examples/torch_*.py)
against the JAX package on the CPU, at small sizes.

Each twin's body runs once with the port and once with the JAX package's
objects in its place (the same calls on both), so what differs is only
the library:

- batch decode (S = 2, 6 frames): packets byte-equal to the JAX
  OpusEncoder's, PCM within 1e-5 of the JAX CeltStreamPipeline(2) (its
  non-plan default, as the example's) on the same payloads, the bar of
  tests/test_torch_pipeline_modes.py for non-plan against JAX;
- DRED recovery (6 frames, frames 3-4 lost), the JAX models' seeded
  weights carried across: packets byte-equal, the same gap recovered
  through DRED on both sides, PCM within 1e-4
  (tests/test_deep_recovery.py:92);
- the single-stream chain on 0.5 s signals: the .opus file, its f32
  decode, the seek window and the trivial round trip's PCM, all exactly
  equal (the host code is a byte copy).
"""

import numpy as np

import mousiki_tpu
from mousiki_tpu.models import deep_plc as jax_plc
from mousiki_tpu.models import dred as jax_dred
from mousiki_tpu.models import fargan as jax_fargan
from mousiki_tpu.opus_decoder import OpusDecoder as JaxDecoder
from mousiki_tpu.opus_encoder import APP_VOIP
from mousiki_tpu.opus_encoder import OpusEncoder as JaxEncoder
from mousiki_tpu.pipeline import CeltStreamPipeline as JaxPipeline
from mousiki_tpu_torch import convert
from mousiki_tpu_torch.repo_files import load_script
from torch_threads import one_torch_thread  # noqa: F401
from torch_threads import seeded_jax_model

BATCH_TOL = 1e-5     # tests/test_torch_pipeline_modes.py, non-plan vs JAX
NEURAL_TOL = 1e-4    # tests/test_deep_recovery.py:92
SECONDS = 0.5
SYNTH_SECONDS = 0.1     # the seeking example's own file, when given none


def test_batch_decode_matches_jax(monkeypatch, capsys):
    twin = load_script("examples/torch_batch_decode.py")
    S, F = 2, 6
    pkts, pcm = twin.run(S, F, device="cpu")
    assert capsys.readouterr().out == (
        f"decoded {F} frames x {S} streams -> last block (2, 960, 2)\n")
    monkeypatch.setattr(twin, "OpusEncoder", JaxEncoder)
    assert pkts == twin.encode_tones(F)
    ref = JaxPipeline(S)
    assert not ref.use_plan
    for f, p in enumerate(pkts):
        want = np.asarray(ref.step([p[1:]] * S))
        got = pcm[f].numpy()
        assert got.shape == want.shape == (S, 960, 2)
        assert np.abs(want).max() > 0.05
        assert np.abs(got - want).max() <= BATCH_TOL, f


def test_dred_loss_recovery_matches_jax(capsys):
    twin = load_script("examples/torch_dred_loss_recovery.py")
    F, lost = 6, (3, 4)

    def rd(shape):
        return 0.3 / np.sqrt(shape[1])

    jax_models = {
        "enc": seeded_jax_model(jax_dred.random_enc, 0, rd),
        "dec": seeded_jax_model(jax_dred.random_dec, 1, rd),
        "fargan": seeded_jax_model(jax_fargan.random_model, 2,
                                   lambda s: 0.08),
        "pitch": seeded_jax_model(jax_plc.random_pitchdnn, 3,
                                  lambda s: 1.0 / np.sqrt(s[1]))}
    port_models = {
        "enc": convert.rdovae_enc_from_numpy(jax_models["enc"], "cpu"),
        "dec": convert.rdovae_dec_from_numpy(jax_models["dec"], "cpu"),
        "fargan": convert.fargan_from_numpy(jax_models["fargan"], "cpu"),
        "pitch": convert.pitchdnn_from_numpy(jax_models["pitch"], "cpu")}
    packets, pcm, how = twin.run(F, lost, port_models, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"encoded {F} packets, ")
    assert lines[1].startswith("frames [3, 4]: recovered via DRED (")
    assert lines[2].startswith(f"decoded {960 * F} samples, rms=")

    # the example's loop on the JAX package's objects
    enc = JaxEncoder(twin.FS, 1, APP_VOIP)
    enc.set_bitrate(24000)
    enc.set_dred_duration(40, model=jax_models["enc"])
    want_packets = twin.encode(enc, twin.voiced_signal(F), F)
    assert packets == want_packets
    dec = JaxDecoder(twin.FS, 1)
    dec.set_deep_plc(jax_models["fargan"], jax_models["pitch"])
    dec.set_dred_models(jax_models["dec"])
    want, want_how = twin.recover(dec, want_packets, set(lost))
    assert how == want_how == {lost: "dred"}
    assert pcm.shape == want.shape == (960 * F, 1)
    assert np.isfinite(pcm).all()
    gap = slice(960 * lost[0], 960 * (lost[-1] + 1))
    assert np.abs(want[gap]).max() > 1e-3
    assert np.abs(pcm - want).max() <= NEURAL_TOL


def test_single_stream_chain_matches_jax(tmp_path, monkeypatch, capsys):
    """libopusenc writes the .opus file, decode_ogg decodes it, the seeking
    example reads a window from its middle; then the trivial round trip.
    Each twin's body runs with mousiki_tpu_torch and with mousiki_tpu as
    its `m`."""
    names = ("libopusenc_example", "decode_ogg", "opusfile_seeking_example",
             "trivial_example")
    twins = {n: load_script(f"examples/torch_{n}.py") for n in names}

    def chain(side):
        path = tmp_path / side / "tone.opus"
        path.parent.mkdir()
        monkeypatch.chdir(path.parent)
        data = twins["libopusenc_example"].write(seconds=SECONDS)
        assert path.read_bytes() == data
        return (data, twins["decode_ogg"].decode(data).tobytes(),
                twins["opusfile_seeking_example"].seek(data),
                twins["opusfile_seeking_example"].synthesize(SYNTH_SECONDS),
                twins["trivial_example"].run(SECONDS))

    got = chain("port")
    printed = capsys.readouterr()
    for twin in twins.values():
        monkeypatch.setattr(twin, "m", mousiki_tpu)
    want = chain("jax")
    assert capsys.readouterr() == printed
    assert printed.err.startswith("links=1 channels=1 pcm_total=")
    assert got[0] == want[0] and b"ARTIST=mousiki_tpu" in got[0]
    assert got[1] == want[1] and len(got[1]) > 4 * 48000 * SECONDS * 0.9
    total, target, window = got[2]
    assert (total, target) == want[2][:2] and target == total // 2
    assert window.shape == (4800, 1)
    np.testing.assert_array_equal(window, want[2][2])
    assert got[3] == want[3]
    assert got[4].shape == (48000 * SECONDS, 2)
    np.testing.assert_array_equal(got[4], want[4])
