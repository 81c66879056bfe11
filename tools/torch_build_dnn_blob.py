#!/usr/bin/env python3
"""Build a libopus-format DNN weight blob from the Xiph `opus_data` C
sources (the dump_data-generated dred_rdovae_*_data.c / pitchdnn_data.c /
fargan_data.c / plc_data.c files), with the PyTorch/CUDA port's blob
writer (the twin of tools/build_dnn_blob.py).

Every `const <type> <name>[<len>] = { ... };` array in the sources becomes
a named entry in a weight blob (mousiki_tpu_torch/models/nnet.py
write_weight_blob, 64-byte header format) that the port's from_blob model
builders (models/fargan.py, models/deep_plc.py, models/dred.py) read.

Usage:
  python3 tools/torch_build_dnn_blob.py <opus_data dir | tarball> [out.bin]

Point the first argument at an extracted opus_data-<sha>.tar.gz (or the
tarball itself). The parse and the blob are host work, as in the
reference: nothing reaches the card, so it takes no --device.
"""

import argparse
import os
import re
import sys
import tarfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WANTED = ("dred_rdovae_dec_data.c", "dred_rdovae_stats_data.c",
          "dred_rdovae_enc_data.c", "pitchdnn_data.c", "fargan_data.c",
          "plc_data.c", "lossgen_data.c")

_C_TYPES = {
    "float": np.dtype("<f4"),
    "opus_int8": np.int8,
    "qweight": np.int8,
    "opus_uint8": np.uint8,
    "opus_int16": np.dtype("<i2"),
    "opus_uint16": np.dtype("<u2"),
    "int": np.dtype("<i4"),
    "opus_int32": np.dtype("<i4"),
    "opus_uint32": np.dtype("<u4"),
}

_ARRAY_RE = re.compile(
    r"const\s+(?P<type>\w+)\s+(?P<name>\w+)\s*\[\s*(?P<len>\d*)\s*\]\s*=\s*\{",
    re.S)


def strip_comments(src: str) -> str:
    src = re.sub(r"/\*.*?\*/", " ", src, flags=re.S)
    src = re.sub(r"//[^\n]*", " ", src)
    return src


def parse_c_arrays(src: str) -> dict:
    """Extract every const array; returns {name: numpy array}."""
    src = strip_comments(src)
    out = {}
    for m in _ARRAY_RE.finditer(src):
        ctype = m.group("type")
        if ctype not in _C_TYPES:
            continue
        end = src.find("};", m.end())
        if end < 0:
            raise ValueError(f"missing array terminator for {m.group('name')}")
        body = src[m.end(): end]
        toks = [t for t in re.split(r"[\s,]+", body) if t]
        vals = []
        for t in toks:
            t = t.rstrip("fF") if ctype == "float" else t
            vals.append(float(t) if ctype == "float" else int(t, 0))
        arr = np.asarray(vals, dtype=_C_TYPES[ctype])
        want = m.group("len")
        if want and int(want) != len(arr):
            raise ValueError(
                f"{m.group('name')}: declared [{want}] but parsed {len(arr)}")
        out[m.group("name")] = arr
    return out


def find_sources(path: str):
    """Yield (filename, text) for the wanted C files in a dir or tarball."""
    if os.path.isdir(path):
        for root, _dirs, files in os.walk(path):
            for f in files:
                if f in WANTED:
                    with open(os.path.join(root, f)) as fh:
                        yield f, fh.read()
        return
    with tarfile.open(path) as tar:
        for mem in tar.getmembers():
            base = os.path.basename(mem.name)
            if base in WANTED:
                yield base, tar.extractfile(mem).read().decode()


def build_blob(path: str) -> bytes:
    from mousiki_tpu_torch.models.nnet import write_weight_blob
    arrays = {}
    n_files = 0
    for fname, text in find_sources(path):
        parsed = parse_c_arrays(text)
        print(f"{fname}: {len(parsed)} arrays")
        for name, arr in parsed.items():
            arrays[name] = arr.tobytes()
        n_files += 1
    if n_files == 0:
        raise FileNotFoundError(
            f"no opus_data C sources found under {path} (wanted any of "
            f"{WANTED})")
    return write_weight_blob(arrays)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("source", help="an opus_data directory or tarball")
    ap.add_argument("out", nargs="?", default="dnn_blob.bin")
    args = ap.parse_args(argv)
    blob = build_blob(args.source)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"wrote {args.out}: {len(blob)} bytes — run the gated tests with "
          f"DNN_BLOB={args.out} python -m pytest tests/test_weight_blob.py")


if __name__ == "__main__":
    main()
