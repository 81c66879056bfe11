#!/usr/bin/env python3
"""Encode/decode OPUSPKT1 packet streams with the PyTorch/CUDA port's
copy of the single-stream codec (the twin of tools/opus_packet_tool.py).

    python3 tools/torch_opus_packet_tool.py <encode|decode> <input> <output>

encode: 16-bit LE stereo 48 kHz PCM -> u16-length-prefixed packet stream
decode: OPUSPKT1 packet stream -> 16-bit LE PCM

The codec is the copied numpy host code: it runs on the host, as the
reference does, and nothing of it reaches the card, so it takes no
--device.
"""

import argparse
import os
import struct
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

MAGIC = b"OPUSPKT1"
FRAME_SIZE = 960
SAMPLE_RATE = 48000
CHANNELS = 2
APPLICATION = 2049
BITRATE = 64000


def encode(inp, outp):
    from mousiki_tpu_torch.hostcodec.opus_encoder import OpusEncoder

    pcm = np.frombuffer(open(inp, "rb").read(), "<i2").astype(np.float64)
    pcm = pcm.reshape(-1, CHANNELS) / 32768.0
    enc = OpusEncoder(SAMPLE_RATE, CHANNELS, APPLICATION)
    enc.set_bitrate(BITRATE)
    with open(outp, "wb") as f:
        f.write(MAGIC)
        n = 0
        for off in range(0, len(pcm) - FRAME_SIZE + 1, FRAME_SIZE):
            pkt = enc.encode(pcm[off: off + FRAME_SIZE], FRAME_SIZE)
            f.write(struct.pack("<H", len(pkt)))
            f.write(pkt)
            n += 1
    print(f"encoded {n} packets")


def decode(inp, outp):
    from mousiki_tpu_torch.hostcodec.opus_decoder import OpusDecoder

    data = open(inp, "rb").read()
    if data[:8] != MAGIC:
        raise SystemExit("invalid packet header: magic")
    dec = OpusDecoder(SAMPLE_RATE, CHANNELS)
    pos = 8
    n = 0
    with open(outp, "wb") as f:
        while pos + 2 <= len(data):
            (plen,) = struct.unpack_from("<H", data, pos)
            pos += 2
            if plen == 0 or pos + plen > len(data):
                break
            pcm = dec.decode(data[pos: pos + plen], FRAME_SIZE)
            pos += plen
            f.write(np.clip(pcm * 32768.0, -32768,
                            32767).astype("<i2").tobytes())
            n += 1
    print(f"decoded {n} packets")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="opus_packet_tool.py",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("encode", "decode"))
    ap.add_argument("input")
    ap.add_argument("output")
    args = ap.parse_args(argv)
    (encode if args.mode == "encode" else decode)(args.input, args.output)


if __name__ == "__main__":
    main()
