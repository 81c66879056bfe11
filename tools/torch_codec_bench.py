#!/usr/bin/env python3
"""In-memory encode/decode benchmark with OPUSBEN1 packet corpora, over
the PyTorch/CUDA port's copy of the single-stream codec (the twin of
tools/codec_bench.py).

    python3 tools/torch_codec_bench.py packets --input in.s16 --output c.bin
    python3 tools/torch_codec_bench.py encode --input in.s16 [--format csv]
    python3 tools/torch_codec_bench.py decode --input c.bin [--format csv]

Three modes (`packets` builds an OPUSBEN1 corpus from raw PCM,
`encode`/`decode` benchmark the codec over it), reporting median/p95 ns
per frame, packets/sec and realtime-x, as text or CSV. The corpus format
is the reference's, byte for byte (magic, LE header: rate u32, channels
u16, frame u16, application u32, bitrate i32, complexity u8, mode u8, pad
u16; then u16-length-prefixed packets).

The codec is the copied numpy host code (OpusEncoder / OpusDecoder of
mousiki_tpu_torch.hostcodec): these times are the host CPU's, never the
card's. Nothing of it reaches the card, so it takes no --device.
"""

import argparse
import os
import statistics
import struct
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

MAGIC = b"OPUSBEN1"


def write_corpus(path, packets, rate, channels, frame, application, bitrate,
                 complexity, mode):
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<IHHIiBBH", rate, channels, frame, application,
                            bitrate, complexity, mode, 0))
        for pkt in packets:
            f.write(struct.pack("<H", len(pkt)))
            f.write(pkt)


def read_corpus(path):
    with open(path, "rb") as f:
        if f.read(8) != MAGIC:
            raise ValueError("invalid packet corpus magic")
        rate, channels, frame, app, bitrate, cx, mode, _pad = struct.unpack(
            "<IHHIiBBH", f.read(20))
        packets = []
        while True:
            raw = f.read(2)
            if len(raw) < 2:
                break
            (n,) = struct.unpack("<H", raw)
            packets.append(f.read(n))
        return dict(rate=rate, channels=channels, frame=frame,
                    application=app, bitrate=bitrate, complexity=cx,
                    mode=mode), packets


def _stats(times_ns, frame, rate, fmt, header=True):
    med = statistics.median(times_ns)
    p95 = sorted(times_ns)[int(0.95 * (len(times_ns) - 1))]
    pps = 1e9 / med
    rtx = pps * frame / rate
    if fmt == "csv":
        if header:
            print("median_ns_per_frame,p95_ns_per_frame,"
                  "median_packets_per_sec,median_realtime_x")
        print(f"{med:.0f},{p95:.0f},{pps:.1f},{rtx:.1f}")
    else:
        print(f"median_ns_per_frame:    {med:.0f}")
        print(f"p95_ns_per_frame:       {p95:.0f}")
        print(f"median_packets_per_sec: {pps:.1f}")
        print(f"median_realtime_x:      {rtx:.1f}")


def _read_pcm(a):
    pcm = np.frombuffer(open(a.input, "rb").read(), "<i2").astype(np.float64)
    return pcm.reshape(-1, a.channels) / 32768.0


def cmd_packets(a):
    from mousiki_tpu_torch.hostcodec.opus_encoder import OpusEncoder

    pcm = _read_pcm(a)
    enc = OpusEncoder(a.sample_rate, a.channels, a.application)
    enc.set_bitrate(a.bitrate)
    packets = []
    for off in range(0, len(pcm) - a.frame_size + 1, a.frame_size):
        packets.append(enc.encode(pcm[off: off + a.frame_size], a.frame_size))
        if a.max_frames and len(packets) >= a.max_frames:
            break
    write_corpus(a.output, packets, a.sample_rate, a.channels, a.frame_size,
                 a.application, a.bitrate, a.complexity, 0)
    print(f"wrote {len(packets)} packets to {a.output}")


def cmd_decode(a):
    from mousiki_tpu_torch.hostcodec.opus_decoder import OpusDecoder

    hdr, packets = read_corpus(a.input)
    if a.max_frames:
        packets = packets[: a.max_frames]
    dec = OpusDecoder(hdr["rate"], hdr["channels"])
    for _ in range(a.warmup):
        for pkt in packets:
            dec.decode(pkt, hdr["frame"])
    times = []
    for _ in range(a.measure):
        for pkt in packets:
            t0 = time.perf_counter_ns()
            dec.decode(pkt, hdr["frame"])
            times.append(time.perf_counter_ns() - t0)
    _stats(times, hdr["frame"], hdr["rate"], a.format, not a.no_header)


def cmd_encode(a):
    from mousiki_tpu_torch.hostcodec.opus_encoder import OpusEncoder

    pcm = _read_pcm(a)
    enc = OpusEncoder(a.sample_rate, a.channels, a.application)
    enc.set_bitrate(a.bitrate)
    frames = [pcm[o: o + a.frame_size]
              for o in range(0, len(pcm) - a.frame_size + 1, a.frame_size)]
    if a.max_frames:
        frames = frames[: a.max_frames]
    for _ in range(a.warmup):
        for fr in frames:
            enc.encode(fr, a.frame_size)
    times = []
    for _ in range(a.measure):
        for fr in frames:
            t0 = time.perf_counter_ns()
            enc.encode(fr, a.frame_size)
            times.append(time.perf_counter_ns() - t0)
    _stats(times, a.frame_size, a.sample_rate, a.format, not a.no_header)


def main(argv=None):
    p = argparse.ArgumentParser(prog="codec_bench")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("packets", "encode", "decode"):
        s = sub.add_parser(name)
        s.add_argument("--input", required=True)
        if name == "packets":
            s.add_argument("--output", required=True)
        s.add_argument("--sample-rate", type=int, default=48000)
        s.add_argument("--channels", type=int, default=2)
        s.add_argument("--frame-size", type=int, default=960)
        s.add_argument("--application", type=int, default=2049)
        s.add_argument("--bitrate", type=int, default=64000)
        s.add_argument("--complexity", type=int, default=10)
        s.add_argument("--warmup", type=int, default=3)
        s.add_argument("--measure", type=int, default=10)
        s.add_argument("--max-frames", type=int, default=0)
        s.add_argument("--format", choices=("text", "csv"), default="text")
        s.add_argument("--no-header", action="store_true")
    a = p.parse_args(argv)
    {"packets": cmd_packets, "encode": cmd_encode, "decode": cmd_decode}[a.cmd](a)


if __name__ == "__main__":
    main()
