"""The repo's files around the package, as the port's scripts and tests
read them: lists of byte strings kept in .npz fixtures without pickle, and
the scripts of examples/ and tools/ loaded as modules."""

import importlib.util
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pack_bytes(items: list) -> tuple[np.ndarray, np.ndarray]:
    """A list of byte strings as one uint8 array and its int32 lengths."""
    lens = np.asarray([len(p) for p in items], np.int32)
    return np.frombuffer(b"".join(items), np.uint8), lens


def unpack_bytes(blob: np.ndarray, lens: np.ndarray) -> list:
    """pack_bytes' list, read back."""
    ends = np.cumsum(lens)
    raw = blob.tobytes()
    return [raw[e - n:e] for e, n in zip(ends.tolist(), lens.tolist())]


def load_script(path: str):
    """A script of the repo (an example or a tool, by its path from the
    repo root) as a module, run under its own name and not as __main__."""
    name = "script_" + os.path.splitext(path.replace("/", "_"))[0]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
