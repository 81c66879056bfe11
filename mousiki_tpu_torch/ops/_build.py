"""Build and load the port's CUDA kernels at first use.

Each `csrc/*.cu` file has a plain `extern "C"` entry point and is
compiled by `nvcc` into its own shared library under
`mousiki_tpu_torch/build/` (listed in .gitignore), then loaded with
ctypes. Nothing is compiled when a module is imported: the CPU tests
import every module on a machine without `nvcc`.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels build only where the CUDA toolkit is")


def build(name: str) -> str:
    """Compile csrc/<name>.cu into build/lib<name>.so unless it is up to
    date; returns the library path. Raises with nvcc's stderr on failure."""
    src = os.path.join(CSRC, f"{name}.cu")
    out = os.path.join(BUILD, f"lib{name}.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(BUILD, exist_ok=True)
    # compile to a private name and rename, so a concurrent loader never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first call."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        _libs[name] = lib
    return lib
