"""Build and load the hand-written kernels' shared libraries.

The CUDA sources under ``csrc/`` are compiled at first use, with ``nvcc``
into a plain-C shared library bound with ``ctypes``, into
``stm32f4_sdr_gps_torch/_build/``.  Each library's file name carries a
hash of its sources and compiler command, so an edited source builds
anew and a stale library is never loaded.

The same arithmetic is also built with ``g++`` into a host library
(``csrc/track_scan_host.cpp``) so the CPU tests can check the CUDA
source's loop update on a machine without a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-std=c++17", "-ffp-contract=off", "-D__host__=",
             "-D__device__=", "-fPIC", "-shared"]

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
#: compiler output and seconds of the last build in this process, by name
build_info: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _build(name: str, compiler: list, sources: list) -> str:
    """Compile ``sources`` (csrc/ file names) with ``compiler`` into
    _build/lib<name>_<hash>.so unless it is already there."""
    paths = [os.path.join(CSRC, s) for s in sources]
    h = hashlib.sha256(" ".join(compiler).encode())
    for p in paths + [os.path.join(CSRC, "track_epoch.cuh")]:
        with open(p, "rb") as f:
            h.update(f.read())
    lib = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        build_info[name] = {"seconds": 0.0, "log": "cached"}
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        res = subprocess.run(compiler + ["-o", tmp] + paths, cwd=CSRC,
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"building {name} failed:\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_info[name] = {"seconds": time.perf_counter() - t0,
                        "log": (res.stdout + res.stderr).strip()}
    return lib


def _load(name: str, compiler: list, sources: list, symbol: str,
          n_ptr_tail: int) -> ctypes.CDLL:
    lib = ctypes.CDLL(_build(name, compiler, sources))
    fn = getattr(lib, symbol)
    # x, u2, f32s, i32s, wins, out, T, C, fp, ip [, stream]
    fn.argtypes = ([_PTR] * 6 + [_INT, _INT] + [_PTR, _PTR]
                   + [_PTR] * n_ptr_tail)
    fn.restype = _INT
    return lib


# cached: the wrapper asks for its library on every launch, and finding
# nvcc on PATH costs more host time than the launch itself
@functools.cache
def cuda_lib() -> ctypes.CDLL:
    """The tracking-scan kernel library (``track_scan_launch``), built
    with nvcc for sm_90a at first use."""
    return _load("track_scan_cuda", [_nvcc()] + NVCC_FLAGS,
                 ["track_scan.cu"], "track_scan_launch", 1)


@functools.cache
def host_lib() -> ctypes.CDLL:
    """The host build of the kernel's arithmetic (``track_scan_host``),
    built with g++ at first use."""
    return _load("track_scan_host", ["g++"] + GXX_FLAGS,
                 ["track_scan_host.cpp"], "track_scan_host", 0)
