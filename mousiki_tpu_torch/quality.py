"""Encoder quality of the port against libopus, on the reference's corpora:
the port's counterpart of tools/celt_quality_report.py and
tools/silk_quality_report.py.

CELT: testdata/corpus.wav (48 kHz stereo music, 200 frames) through
`CeltEncodePipeline(1, channels=2, bitrate=rate)` a frame a step at 64,
96 and 128 kbit/s CBR, the TOC byte of a fullband 20 ms stereo CELT
frame prepended (the reference tool's loop). SILK: `make_speech()` (6 s
of synthetic speech, 300 frames) through ONE `SilkEncodePipeline` whose
lane k carries case k's bitrate; only wide-band lanes (24 and 32 kbit/s)
reach the device quantizer (`ops/silk_nsq.py`), the others quantize on
the host with the byte-copied quantizer. Either side's packets are
decoded by a decoder passed in (libopus's where it is installed, the
port's own on the card) and scored against the input with the repo's
opus_compare (`tools/opus_compare.py`): err4, err16, pitch (lower is
better) and the actual kbit/s.

The card's host has no libopus, so `testdata/encode_quality_fixture.npz`
(made by `tools/gen_torch_quality_fixture.py` where libopus is) holds the
CPU port's packets and libopus's side. Nothing falls back: a missing
libopus, fixture or native library raises.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from . import bench
from .bitstream.packet import parse_packet
from .pipeline import (CeltEncodePipeline, CeltStreamPipeline,
                       OpusStreamPipeline, SilkEncodePipeline)
from .repo_files import pack_bytes, unpack_bytes

FRAME = 960
CELT_RATES = (64000, 96000, 128000)
CELT_TOC = bytes([(31 << 3) | 4])        # CELT fullband 20 ms stereo
# (target of the port's encoder, target of libopus's, label): the
# reference's six cases (tools/silk_quality_report.py), the first capping
# the port's spend near libopus's actual 8 kbit/s spend
SILK_CASES = ((6000, 8000, "8kbps-spend-matched"), (8000, 8000, "8 kbps"),
              (12000, 12000, "12 kbps"), (16000, 16000, "16 kbps"),
              (24000, 24000, "24 kbps"), (32000, 32000, "32 kbps"))
# the cases whose lanes run at 16 kHz internal rate, the device
# quantizer's shape; the others never reach it
SILK_WIDEBAND = SILK_CASES[4:]
FIXTURE = os.path.join(bench._ROOT, "testdata", "encode_quality_fixture.npz")
GENERATOR = "tools/gen_torch_quality_fixture.py"
FIXTURE_SILK_FRAMES = 16
SCORE_KEYS = ("err4", "err16", "pitch", "kbps")


# ------------------------------------------- the reference tools' helpers

def load_corpus() -> np.ndarray:
    """testdata/corpus.wav as float32 (N, 2) in [-1, 1]."""
    sig = bench.load_corpus()
    if sig is None:
        raise FileNotFoundError("testdata/corpus.wav is missing")
    return sig


def downmix_16k(x48) -> np.ndarray:
    """48 kHz float, (N,) or (N, C) -> 16 kHz mono float32 through a
    windowed-sinc low-pass (both reference tools' downmix)."""
    taps = 96
    t = np.arange(-taps, taps + 1, dtype=np.float64)
    h = np.sinc(t / 3.0) / 3.0 * np.hanning(2 * taps + 1)
    mono = np.asarray(x48, np.float64)
    if mono.ndim > 1:
        mono = mono.mean(axis=1)
    return np.convolve(mono, h, mode="same")[::3].astype(np.float32)


def make_speech(seconds=6.0, fs=48000, seed=3):
    """Speech-like signal: voiced formant segments + fricatives + gaps."""
    rng = np.random.default_rng(seed)
    n = int(seconds * fs)
    out = np.zeros(n)
    pos = 0
    while pos < n - fs // 4:
        kind = rng.choice(["voiced", "unvoiced", "pause"],
                          p=[0.6, 0.25, 0.15])
        dur = min(int(rng.uniform(0.1, 0.35) * fs), n - pos)
        seg = np.zeros(dur)
        if kind == "voiced":
            f0 = rng.uniform(110, 230)
            f0_traj = f0 * (1 + 0.08 * np.sin(
                2 * np.pi * rng.uniform(1, 4) * np.arange(dur) / fs))
            phase = np.cumsum(f0_traj) / fs
            # glottal-ish pulse train (sawtooth with soft closure)
            src = ((phase % 1.0) ** 6) - 0.14
            # two time-varying formants as resonant biquads
            seg = src
            for fmt, bw in ((rng.uniform(350, 800), 120),
                            (rng.uniform(1000, 2300), 180),
                            (rng.uniform(2500, 3200), 260)):
                r = np.exp(-np.pi * bw / fs)
                th = 2 * np.pi * fmt / fs
                b0 = (1 - r) * np.sqrt(1 - 2 * r * np.cos(2 * th) + r * r)
                y = np.zeros(dur)
                y1 = y2 = 0.0
                a1, a2 = 2 * r * np.cos(th), -r * r
                for i in range(dur):
                    y0 = b0 * seg[i] + a1 * y1 + a2 * y2
                    y2, y1 = y1, y0
                    y[i] = y0
                seg = y
            seg *= 0.5 / (np.abs(seg).max() + 1e-9)
        elif kind == "unvoiced":
            noise = rng.standard_normal(dur)
            # high-pass shaped fricative
            seg = np.diff(noise, prepend=0.0) * 0.08
        # onset/offset ramps
        ramp = min(dur // 8, 240)
        seg[:ramp] *= np.linspace(0, 1, ramp)
        seg[-ramp:] *= np.linspace(1, 0, ramp)
        seg *= rng.uniform(0.6, 1.0)
        out[pos:pos + dur] = seg
        pos += dur
    return out.astype(np.float32)


def speech_frames() -> np.ndarray:
    """make_speech() cut to whole frames: float32 (300 * 960,)."""
    sig = make_speech()
    return sig[: len(sig) // FRAME * FRAME]


# --------------------------------------------------------------- encoders

def celt_packets(pipe, sig: np.ndarray) -> list:
    """Every whole frame of the (N, 2) signal through a one-stream CELT
    encode pipeline (the port's or the JAX package's: both take
    `step((1, 960, 2))`), a frame a step; full Opus packets."""
    return [CELT_TOC + pipe.step(sig[f * FRAME:(f + 1) * FRAME][None])[0]
            for f in range(len(sig) // FRAME)]


def encode_celt_corpus(rate: int, *, device) -> list:
    """The corpus through the port's CELT encoder at `rate` bit/s CBR."""
    pipe = CeltEncodePipeline(1, channels=2, bitrate=rate, device=device)
    return celt_packets(pipe, load_corpus())


def silk_packets(pipe, rates, sig: np.ndarray, n_frames=None) -> list:
    """Lane k of a SILK encode pipeline (the port's or the JAX package's)
    at rates[k] bit/s, every lane fed the same mono signal, a frame a
    step; returns the packets as [lane][frame]."""
    for enc, rate in zip(pipe.encs, rates, strict=True):
        enc.set_bitrate(rate)
    n = len(sig) // FRAME if n_frames is None else n_frames
    frames = [pipe.step(np.repeat(sig[f * FRAME:(f + 1) * FRAME][None],
                                  len(rates), axis=0))
              for f in range(n)]
    return [list(lane) for lane in zip(*frames)]


def encode_silk_cases(cases, *, device, n_frames=None):
    """make_speech() through one port SilkEncodePipeline, lane k at the
    port's target of cases[k] (the lanes are independent, so this equals
    one encoder a case). Returns (packets [lane][frame], the device
    quantizer calls that held each lane)."""
    pipe = SilkEncodePipeline(len(cases), device=device)
    packets = silk_packets(pipe, [c[0] for c in cases], speech_frames(),
                           n_frames)
    return packets, list(pipe._ex.lane_dispatches)


def _oracle():
    """The copied libopus oracle; raises where the system has no libopus."""
    from .hostcodec.testing import oracle
    if not oracle.available():
        raise RuntimeError("libopus is not installed: the quality chain "
                           "needs the system libopus here")
    return oracle


def encode_libopus_celt(sig: np.ndarray, rate: int) -> list:
    """libopus's side of the CELT report: CELT-only restricted low delay,
    CBR at `rate`, on the (N, 2) signal's whole frames."""
    oracle = _oracle()
    enc = oracle.RefEncoder(48000, 2, oracle.APP_RESTRICTED_LOWDELAY)
    enc.ctl_set(oracle.SET_BITRATE, rate)
    enc.ctl_set(oracle.SET_VBR, 0)
    pcm16 = oracle.float_to_i16(sig)
    return [enc.encode(pcm16[f * FRAME:(f + 1) * FRAME].reshape(-1))
            for f in range(len(sig) // FRAME)]


def encode_libopus_silk(sig: np.ndarray, rate: int) -> list:
    """libopus's side of the SILK report, with the reference tool's
    settings: VOIP at `rate`, then its ctl 4006 with 1103. 4006 is
    OPUS_SET_VBR, not the maximum bandwidth its comment names, so libopus
    runs VBR at a bandwidth of its own choice; kept, so that the rows are
    QUALITY_SILK.md's."""
    oracle = _oracle()
    enc = oracle.RefEncoder(48000, 1, oracle.APP_VOIP)
    enc.ctl_set(oracle.SET_BITRATE, rate)
    enc.ctl_set(4006, 1101 + 2)
    pcm16 = oracle.float_to_i16(sig[:, None])
    return [enc.encode(pcm16[f * FRAME:(f + 1) * FRAME].reshape(-1))
            for f in range(len(sig) // FRAME)]


# --------------------------------------------------------------- decoders

def decode_libopus(streams: list, channels: int) -> list:
    """Each stream's packets through its own libopus decoder (the system
    library, through the copied oracle): a list of (n * 960, channels)
    float32 arrays."""
    oracle = _oracle()
    out = []
    for packets in streams:
        dec = oracle.RefDecoder(48000, channels)
        out.append(np.concatenate([dec.decode_float(p, FRAME)
                                   for p in packets]).reshape(-1, channels))
    return out


def decode_celt_port(streams: list, channels: int, *, device) -> list:
    """The streams' CELT packets through the port's plan decoder, one
    stream of `CeltStreamPipeline(len(streams), use_plan=True)` each, all
    frames in one scanned dispatch (the bench gate's route)."""
    pipe = CeltStreamPipeline(len(streams), channels, use_plan=True,
                              device=device)
    frames = [[parse_packet(p).frames[0] for p in step]
              for step in zip(*streams)]
    pcm = pipe.decode_frames_scanned(frames, FRAME).cpu().numpy()
    return [pcm[:, s].reshape(-1, channels) for s in range(len(streams))]


def decode_opus_port(streams: list, channels: int, *, device) -> list:
    """The streams' packets through the port's mixed decoder,
    `OpusStreamPipeline(len(streams), channels=channels)`, a frame a
    step."""
    pipe = OpusStreamPipeline(len(streams), channels=channels,
                              device=device)
    pcm = [pipe.step(list(step)).cpu().numpy() for step in zip(*streams)]
    pcm = np.concatenate(pcm, axis=1)
    return [pcm[s] for s in range(len(streams))]


# ---------------------------------------------------------------- scoring

def _compare():
    tools = os.path.join(bench._ROOT, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    from opus_compare import compare
    return compare


def score(ref16: np.ndarray, streams: list, channels: int,
          decoder) -> list:
    """opus_compare of each decoded stream against the 16 kHz reference:
    a dict of err4, err16, pitch and kbps (the packets' actual rate) a
    stream. `decoder(streams, channels)` returns each stream's decoded
    (n * 960, channels) PCM."""
    compare = _compare()
    scores = []
    for packets, pcm in zip(streams, decoder(streams, channels),
                            strict=True):
        r = compare(32768.0 * ref16, 32768.0 * downmix_16k(pcm))
        kbps = 8 * sum(len(p) for p in packets) / (
            len(packets) * 0.02) / 1000.0
        scores.append({"err4": float(r["err4"]), "err16": float(r["err16"]),
                       "pitch": float(r["pitch"]), "kbps": kbps})
    return scores


def snr_db(ref48, got48, skip=FRAME) -> float:
    """SNR (dB) of decoded against input after downmix_16k, at the best
    delay of up to 120 samples at 16 kHz, past the first frame."""
    a = downmix_16k(ref48[skip:]).astype(np.float64)
    b = downmix_16k(got48[skip:]).astype(np.float64)
    best = -np.inf
    for lag in range(120):
        bb = b[lag:]
        aa = a[:len(bb)]
        best = max(best, 10 * np.log10(
            (aa ** 2).mean() / (((aa - bb) ** 2).mean() + 1e-20)))
    return float(best)


def equal_share(got: list, want: list) -> float:
    """The share of packets byte-equal between two lists."""
    if len(got) != len(want):
        raise ValueError(f"{len(got)} packets against {len(want)}")
    return sum(a == b for a, b in zip(got, want)) / len(got)


# ---------------------------------------------------------------- fixture

def save_fixture(path: str, fx: dict) -> None:
    """Write a fixture of load_fixture's form (no pickle)."""
    arrays = {"libopus": np.asarray(fx["libopus"]),
              "celt_rates": np.asarray(CELT_RATES),
              "silk_rates": np.asarray([c[0] for c in SILK_WIDEBAND])}
    for key in ("celt", "silk"):
        flat = [p for stream in fx[f"{key}_packets"] for p in stream]
        arrays[f"{key}_packets"], arrays[f"{key}_packets_len"] = \
            pack_bytes(flat)
    for key in ("celt_scores", "celt_libopus_scores"):
        arrays[key] = np.asarray([[s[k] for k in SCORE_KEYS]
                                  for s in fx[key]], np.float64)
    arrays["silk_libopus_pcm"] = np.asarray(fx["silk_libopus_pcm"],
                                            np.float32)
    np.savez_compressed(path, **arrays)


def load_fixture(path: str = FIXTURE) -> dict:
    """The CPU port's packets and libopus's side of the quality chain.

    Returns {"libopus": version, "celt_packets": 3 lists (one a rate of
    CELT_RATES) of 200 full Opus packets, "celt_scores": libopus-decoded
    scores of those packets (a dict a rate), "celt_libopus_scores": the
    same of libopus's own CBR restricted-low-delay encode, "silk_packets":
    2 lists (the SILK_WIDEBAND lanes) of the first FIXTURE_SILK_FRAMES
    frames of make_speech(), "silk_libopus_pcm": (2, frames * 960, 1)
    libopus's float decode of them}."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path}: the encode quality fixture is missing; make it with "
            f"`python3 {GENERATOR}` where libopus is installed")
    with np.load(path, allow_pickle=False) as z:
        fx = {"libopus": str(z["libopus"])}
        for key, rates in (("celt", z["celt_rates"]),
                           ("silk", z["silk_rates"])):
            flat = unpack_bytes(z[f"{key}_packets"],
                                 z[f"{key}_packets_len"])
            n = len(flat) // len(rates)
            fx[f"{key}_packets"] = [flat[i * n:(i + 1) * n]
                                    for i in range(len(rates))]
        for key in ("celt_scores", "celt_libopus_scores"):
            fx[key] = [dict(zip(SCORE_KEYS, map(float, row)))
                       for row in z[key]]
        fx["silk_libopus_pcm"] = z["silk_libopus_pcm"]
    return fx


# ------------------------------------------------------- markdown reports

def _reference_rows(path: str) -> dict:
    """The table rows of a reference report (QUALITY_CELT.md or
    QUALITY_SILK.md): {label: its eight numbers, as written}."""
    rows = {}
    with open(path) as fh:
        for line in fh:
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            if len(cells) == 9 and cells[1][:1].isdigit():
                rows[cells[0]] = cells[1:]
    return rows


def _fmt(s: dict | None) -> str:
    if s is None:
        return "— | — | — | —"
    return (f"{s['err4']:.3f} | {s['err16']:.3f} | {s['pitch']:.3f} | "
            f"{s['kbps']:.1f}")


def _err_pair(s: dict | None) -> str:
    return "— | —" if s is None else f"{s['err4']:.4f} | {s['err16']:.4f}"


def write_celt_report(path: str, rows: list, device: str,
                      card: dict | None = None) -> None:
    """QUALITY_CELT_TORCH.md. rows: one dict a rate with "rate", "port",
    "libopus" and, where the JAX pipeline ran, "jax" and
    "equal_to_jax" (scores are score()'s dicts); card: the encode_quality
    result of chip_smoke.py, or None."""
    ref = _reference_rows(os.path.join(bench._ROOT, "QUALITY_CELT.md"))
    with open(path, "w") as f:
        f.write(
            "# CELT encoder quality vs libopus: the PyTorch port "
            "(music corpus)\n\n"
            "The port's twin of QUALITY_CELT.md, written by "
            "`tools/torch_celt_quality_report.py`. testdata/corpus.wav "
            "(48 kHz stereo music, 200 frames) through the port's "
            "`CeltEncodePipeline(1, channels=2, bitrate=rate)` on "
            f"`{device}` (device front half + native symbol back half, "
            "CBR), a frame a step; with `--reference` the same loop "
            "through the JAX package's `CeltEncodePipeline`, run live; "
            "libopus = CELT-only restricted-lowdelay at the same CBR "
            "rates. Every side decoded by libopus and scored against the "
            "original with tools/opus_compare.py (lower is better). The "
            "reference-file columns are QUALITY_CELT.md's \"ours\" rows as "
            "written, which predate the JAX encoder's later changes: the "
            "port is held to the live JAX row.\n\n"
            "| rate | port err4 | port err16 | port pitch | kbps | "
            "JAX err4 | JAX err16 | JAX pitch | kbps | "
            "QUALITY_CELT.md err4 | err16 | libopus err4 | libopus err16 "
            "| libopus pitch | kbps |\n"
            "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"
            "---|\n")
        for r in rows:
            label = f"{r['rate'] // 1000} kbps"
            old = ref.get(label, ["—"] * 2)
            f.write(f"| {label} | {_fmt(r['port'])} | "
                    f"{_fmt(r.get('jax'))} | {old[0]} | {old[1]} | "
                    f"{_fmt(r['libopus'])} |\n")
        f.write("\nAgreement with the JAX pipeline (bar: err4 and err16 "
                "within 0.005 of the live JAX row):\n\n"
                "| rate | packets byte-equal to JAX | err4 port − JAX | "
                "err16 port − JAX | pitch port − JAX |\n"
                "|---|---|---|---|---|\n")
        for r in rows:
            if "jax" not in r:
                continue
            d = {k: r["port"][k] - r["jax"][k] for k in SCORE_KEYS}
            f.write(f"| {r['rate'] // 1000} kbps | "
                    f"{r['equal_to_jax']:.3f} | {d['err4']:+.5f} | "
                    f"{d['err16']:+.5f} | {d['pitch']:+.5f} |\n")
        if card is not None:
            f.write(
                "\nOn the card (`chip_smoke.py` phase encode_quality, "
                f"{card['card']}): the corpus encoded on the card, decoded "
                "on the card by the port's plan decoder "
                "(`CeltStreamPipeline(3, use_plan=True)`, "
                "`decode_frames_scanned`), scored against the corpus; the "
                "bar is the fixture's libopus-decoded score of the CPU "
                "port's packets, within 0.005:\n\n"
                "| rate | card err4 | card err16 | fixture err4 | "
                "fixture err16 | packets equal to the CPU port's |\n"
                "|---|---|---|---|---|---|\n")
            for rate, c in zip(CELT_RATES, card["celt"], strict=True):
                f.write(f"| {rate // 1000} kbps | {_err_pair(c['card'])} | "
                        f"{_err_pair(c['fixture'])} | "
                        f"{c['equal_to_fixture']:.3f} |\n")


def write_silk_report(path: str, rows: list, device: str,
                      card: dict | None = None) -> None:
    """QUALITY_SILK_TORCH.md. rows: one dict a case with "case" (a
    SILK_CASES entry), "port", "libopus", "device_calls" and, where the
    JAX pipeline ran, "jax", "jax_device_calls" and "equal_to_jax"; card:
    the encode_quality result of chip_smoke.py, or None."""
    ref = _reference_rows(os.path.join(bench._ROOT, "QUALITY_SILK.md"))
    with open(path, "w") as f:
        f.write(
            "# SILK encoder quality vs libopus: the PyTorch port (speech "
            "corpus)\n\n"
            "The port's twin of QUALITY_SILK.md, written by "
            "`tools/torch_silk_quality_report.py`. The reference's 6 s "
            "speech-like corpus (`make_speech()`, 300 frames) through ONE "
            f"port `SilkEncodePipeline(6)` on `{device}`, lane k at case "
            "k's target (the lanes are independent); with `--reference` "
            "every case also through the JAX package's "
            "`SilkEncodePipeline`, one a case, run live. libopus = VOIP at "
            "the same targets with the reference tool's settings. Every "
            "side decoded by libopus and scored against the original with "
            "tools/opus_compare.py (lower is better).\n\n"
            "Only lanes at 16 kHz internal rate (24 and 32 kbit/s) reach "
            "the device quantizer (`ops/silk_nsq.py` through "
            "`parallel/nsq_batch.py`); 6-16 kbit/s run at 8 or 12 kHz and "
            "quantize inline with the byte-copied host quantizer at the "
            "lane's own warping, so they test no device code: their "
            "packets are the copied host encoder's, fed the float64 PCM "
            "the pipeline hands it (the reference tool feeds float32, "
            "which changes packets from frame 84 on at 8 kbit/s), and "
            "their rows sit within a few thousandths of QUALITY_SILK.md's. "
            "The JAX package's "
            "hook gives that quantizer the warping of 16 kHz at every "
            "rate, which wrecks its narrow-band rows (ROADMAP.md F4; the "
            "JAX package stays as it is). \"device calls\" counts the "
            "device quantizer calls that held the lane.\n\n"
            "| case | quantizer | device calls | port err4 | port err16 | "
            "port pitch | kbps | JAX err4 | JAX err16 | JAX pitch | kbps "
            "| QUALITY_SILK.md err4 | err16 | libopus err4 | "
            "libopus err16 | libopus pitch | kbps |\n"
            "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---"
            "|---|---|\n")
        for r in rows:
            label = r["case"][2]
            old = ref.get(label, ["—"] * 2)
            quant = ("device (`ops/silk_nsq.py`)" if r["device_calls"]
                     else "host quantizer (byte copy; no device code)")
            f.write(f"| {label} | {quant} | {r['device_calls']} | "
                    f"{_fmt(r['port'])} | {_fmt(r.get('jax'))} | "
                    f"{old[0]} | {old[1]} | {_fmt(r['libopus'])} |\n")
        jax_rows = [r for r in rows if "jax" in r]
        if jax_rows:
            f.write("\nAgreement with the JAX pipeline (bar on the "
                    "wide-band lanes: err4, err16 and pitch within 0.005 of "
                    "the live JAX row):\n\n"
                    "| case | packets byte-equal to JAX | device calls port"
                    " / JAX | err4 port − JAX | err16 port − JAX | "
                    "pitch port − JAX |\n|---|---|---|---|---|---|\n")
            for r in jax_rows:
                d = {k: r["port"][k] - r["jax"][k] for k in SCORE_KEYS}
                f.write(f"| {r['case'][2]} | {r['equal_to_jax']:.3f} | "
                        f"{r['device_calls']} / {r['jax_device_calls']} | "
                        f"{d['err4']:+.5f} | {d['err16']:+.5f} | "
                        f"{d['pitch']:+.5f} |\n")
        if card is not None:
            f.write(
                "\nOn the card (`chip_smoke.py` phase encode_quality, "
                f"{card['card']}): the wide-band lanes for the first "
                f"{FIXTURE_SILK_FRAMES} frames encoded on the card, decoded "
                "on the card by `OpusStreamPipeline(2, channels=1)`; the "
                "bar is the SNR of the fixture's libopus decode of the CPU "
                f"port's packets less {card['silk_margin_db']} dB:\n\n"
                "| case | device calls | card SNR dB | fixture SNR dB | "
                "packets equal to the CPU port's |\n|---|---|---|---|---|\n")
            for case, c in zip(SILK_WIDEBAND, card["silk"], strict=True):
                f.write(f"| {case[2]} | {c['device_calls']} | "
                        f"{c['snr_db']:.2f} | {c['fixture_snr_db']:.2f} | "
                        f"{c['equal_to_fixture']:.3f} |\n")
