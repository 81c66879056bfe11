"""Build and load the port's native libraries at first use.

Two kinds of library live in `csrc/`, each compiled into its own shared
library under `mousiki_tpu_torch/build/` (listed in .gitignore) and
loaded with ctypes:

  * CUDA kernels (`csrc/<name>.cu`), each with a plain `extern "C"`
    entry point, compiled by `nvcc` for sm_90a (`load`);
  * the C++ host stages, compiled by `g++` (`load_host`): `celt_host`
    (the CELT symbol decoder), `silk_host` (the SILK decoder) and
    `opus_host` (the TOC-routed mixed stage, which links the other two
    sources in and so carries its own copy of their globals);
  * `plc_rows.h`, the concealment kernel's row arithmetic, compiled by
    `g++` alone with its array entry points for the CPU tests
    (`load_plc_rows_host`), without contracting a multiply and an add.

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
# library -> (sources to compile, headers they include)
HOST_LIBS = {
    "celt_host": (("celt_host.cpp",), ("celt_tables.h",)),
    "silk_host": (("silk_host.cpp",), ("silk_tables.h",)),
    "opus_host": (("opus_host.cpp", "celt_host.cpp", "silk_host.cpp"),
                  ("celt_tables.h", "silk_tables.h")),
}

# kernel source -> the headers of csrc/ it includes
KERNEL_HEADERS = {"plc_rows": ("plc_rows.h",)}
# the row arithmetic's host build: rounded as the device rounds it
PLC_ROWS_HOST_FLAGS = ("-O2", "-shared", "-fPIC", "-ffp-contract=off",
                       "-DPLC_ROWS_HOST_API", "-x", "c++")

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


def _compile(cmd: list, srcs: list, out: str, deps: tuple = ()) -> str:
    """Run `cmd + ["-o", tmp] + srcs` unless `out` is newer than every
    file of `srcs` and `deps`; returns `out`. Raises with the compiler's
    stderr."""
    if os.path.exists(out) and os.path.getmtime(out) >= max(
            os.path.getmtime(s) for s in (*srcs, *deps)):
        return out
    os.makedirs(BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        proc = subprocess.run([*cmd, "-o", tmp, *srcs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{cmd[0]} failed on {' '.join(srcs)}:\n{proc.stderr}")
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
                    os.path.join(BUILD, f"lib{name}.so"),
                    tuple(os.path.join(CSRC, h)
                          for h in KERNEL_HEADERS.get(name, ())))


def build_host(name: str = "celt_host") -> str:
    """Compile the host library `name` (a key of HOST_LIBS) into
    build/lib<name>.so unless it is up to date; returns the library
    path. Raises with g++'s stderr."""
    srcs, headers = HOST_LIBS[name]
    return _compile(["g++", *HOST_FLAGS],
                    [os.path.join(CSRC, s) for s in srcs],
                    os.path.join(BUILD, f"lib{name}.so"),
                    tuple(os.path.join(CSRC, h) for h in headers))


def build_plc_rows_host() -> str:
    """Compile csrc/plc_rows.h with its host entry points into
    build/libplc_rows_host.so unless it is up to date; returns the
    library path. Raises with g++'s stderr."""
    return _compile(["g++", *PLC_ROWS_HOST_FLAGS],
                    [os.path.join(CSRC, "plc_rows.h")],
                    os.path.join(BUILD, "libplc_rows_host.so"))


def _cached(key: str, path_fn) -> ctypes.CDLL:
    lib = _libs.get(key)
    if lib is None:
        lib = ctypes.CDLL(path_fn())
        _libs[key] = lib
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first call."""
    return _cached(name, lambda: build(name))


def load_host(name: str = "celt_host") -> ctypes.CDLL:
    """The loaded host library `name` (a key of HOST_LIBS), built on
    first call."""
    return _cached(name, lambda: build_host(name))


def load_plc_rows_host() -> ctypes.CDLL:
    """The loaded host build of csrc/plc_rows.h, built on first call."""
    return _cached("plc_rows_host", build_plc_rows_host)


def loaded_host(name: str):
    """The host library `name` if this process has loaded it, else None."""
    return _libs.get(name)
