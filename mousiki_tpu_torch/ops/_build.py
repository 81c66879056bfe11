"""Build and load the port's native libraries at first use.

Two kinds of library live in `csrc/`, each compiled into its own shared
library under `mousiki_tpu_torch/build/` (listed in .gitignore) and
loaded with ctypes:

  * CUDA kernels (`csrc/<name>.cu`), each with a plain `extern "C"`
    entry point, compiled by `nvcc` for sm_90a (`load`);
  * the C++ host symbol stage (`csrc/celt_host.cpp`), compiled by `g++`
    (`load_host`).

Nothing is compiled when a module is imported: the CPU tests import
every module on a machine without `nvcc`. A library is compiled to a
private name and renamed into place, so several processes may build it
at once and a loader never sees a half-written file.
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
# the flags of the JAX package's host build, plus -Bsymbolic: the library
# binds its own globals (the plan profile) even when the JAX package's
# copy of the same symbols is loaded in the same process
HOST_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread",
              "-Wl,-Bsymbolic")
HOST_SOURCES = ("celt_host.cpp", "celt_tables.h")

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


def _compile(cmd: list, srcs: list, out: str) -> str:
    """Run `cmd + ["-o", tmp, srcs[0]]` unless `out` is newer than every
    file of `srcs`; returns `out`. Raises with the compiler's stderr."""
    if os.path.exists(out) and os.path.getmtime(out) >= max(
            os.path.getmtime(s) for s in srcs):
        return out
    os.makedirs(BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        proc = subprocess.run([*cmd, "-o", tmp, srcs[0]],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cmd[0]} failed on {srcs[0]}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build(name: str) -> str:
    """Compile csrc/<name>.cu into build/lib<name>.so unless it is up to
    date; returns the library path. Raises with nvcc's stderr on failure."""
    return _compile([nvcc_path(), *NVCC_FLAGS],
                    [os.path.join(CSRC, f"{name}.cu")],
                    os.path.join(BUILD, f"lib{name}.so"))


def build_host() -> str:
    """Compile csrc/celt_host.cpp into build/libcelt_host.so unless it is
    up to date; returns the library path. Raises with g++'s stderr."""
    return _compile(["g++", *HOST_FLAGS],
                    [os.path.join(CSRC, s) for s in HOST_SOURCES],
                    os.path.join(BUILD, "libcelt_host.so"))


def _cached(key: str, path_fn) -> ctypes.CDLL:
    lib = _libs.get(key)
    if lib is None:
        lib = ctypes.CDLL(path_fn())
        _libs[key] = lib
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first call."""
    return _cached(name, lambda: build(name))


def load_host() -> ctypes.CDLL:
    """The loaded host symbol stage (csrc/celt_host.cpp), built on first
    call."""
    return _cached("celt_host", build_host)
