"""Build and load the hand-written kernels' shared libraries.

The CUDA sources under ``csrc/`` are compiled at first use, with ``nvcc``
into a plain-C shared library bound with ``ctypes``, into
``stm32f4_sdr_gps_torch/_build/``.  Each library's file name carries a
hash of its compiler command, its sources and every header they include
from ``csrc/``, so an edited source or header builds anew and a stale
library is never loaded.

One library per kernel source:

* ``cuda_lib``: the tracking scan (``csrc/track_scan.cu``, kernel K1);
* ``epl_lib``: the per-epoch E/P/L correlator (``csrc/epl.cu``, K2);
* ``corr_bank_lib``: the correlator-bank probe (``csrc/corr_bank.cu``,
  P5);
* ``forest_lib``: the epoch-cost probes (``csrc/forest.cu``, P6-P8);
* ``roll_lib``: the row rolls and K1's replica barrel (``csrc/roll.cu``,
  the roll probes P1-P4);
* ``pretrack_lib``: the handoff search's squared prompts and half-chip
  power (``csrc/pretrack.cu``);
* ``if_resample_lib``: the real-IF ingest's mix and polyphase resampler
  (``csrc/if_resample.cu``, kernel R1).

The same arithmetic is also built with ``g++`` into a host library
(``csrc/kernels_host.cpp``, ``csrc/forest_host.cpp``,
``csrc/roll_host.cpp``, ``csrc/pretrack_host.cpp``,
``csrc/if_resample_host.cpp``) so the CPU tests can check the CUDA
sources' loop update, correlator, probe bodies, roll lanes, handoff
search and real-IF ingest on a machine without a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
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
_FLOAT = ctypes.c_float
_LONG = ctypes.c_longlong
#: compiler output, seconds and library path of the last build in this
#: process, by name
build_info: dict = {}

_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _inputs(sources: list, csrc: str) -> list:
    """The source paths, then every header they include with
    ``#include "..."`` that lies in ``csrc`` (transitively, each once)."""
    paths = [os.path.join(csrc, s) for s in sources]
    seen, order, todo = set(paths), list(paths), list(paths)
    while todo:
        with open(todo.pop(), "rb") as f:
            text = f.read()
        for inc in _INCLUDE.findall(text):
            p = os.path.join(csrc, inc.decode())
            if p not in seen and os.path.exists(p):
                seen.add(p)
                order.append(p)
                todo.append(p)
    return order


def _build(name: str, compiler: list, sources: list, csrc: str = CSRC,
           build_dir: str = BUILD_DIR) -> str:
    """Compile ``sources`` (file names in ``csrc``) with ``compiler`` into
    ``build_dir``/lib<name>_<hash>.so unless it is already there.  The
    compiler's output is kept beside it (``.log``), so ``build_info``
    has the ptxas lines of a cached library too."""
    h = hashlib.sha256(" ".join(compiler).encode())
    for p in _inputs(sources, csrc):
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    lib = os.path.join(build_dir, f"lib{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        log = ""
        if os.path.exists(lib + ".log"):
            with open(lib + ".log") as f:
                log = f.read()
        build_info[name] = {"seconds": 0.0, "cached": True, "log": log,
                            "path": lib}
        return lib
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    t0 = time.perf_counter()
    paths = [os.path.join(csrc, s) for s in sources]
    try:
        res = subprocess.run(compiler + ["-o", tmp] + paths, cwd=csrc,
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"building {name} failed:\n{res.stdout}\n{res.stderr}")
        log = (res.stdout + res.stderr).strip()
        with open(tmp + ".log", "w") as f:
            f.write(log)
        os.replace(tmp + ".log", lib + ".log")
        os.replace(tmp, lib)
    finally:
        for path in (tmp, tmp + ".log"):
            if os.path.exists(path):
                os.remove(path)
    build_info[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                        "log": log, "path": lib}
    return lib


def _load(name: str, compiler: list, sources: list, signatures: dict,
          csrc: str = CSRC) -> ctypes.CDLL:
    """Build and load a library, and give each exported function in
    ``signatures`` (symbol -> ctypes argument types) its argument list;
    every function returns an int status."""
    lib = ctypes.CDLL(_build(name, compiler, sources, csrc))
    for symbol, argtypes in signatures.items():
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = _INT
    return lib


def ptxas_report(log: str, kernel: str) -> list:
    """For each entry function whose name contains ``kernel``, in the
    ``ptxas -v`` lines of a build's log (``build_info[name]["log"]``), a
    dict of its name, registers, stack frame bytes, spill bytes, static
    shared memory bytes (``smem``) and named barriers (both 0 where ptxas
    names none)."""
    report, cur = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            cur = {"name": entry.group(1)} if kernel in entry.group(1) \
                else None
            if cur is not None:
                report.append(cur)
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        if cur is not None and frame:
            cur.update(stack=int(frame[1]), spill_stores=int(frame[2]),
                       spill_loads=int(frame[3]))
        regs = re.search(r"Used (\d+) registers", line)
        if cur is not None and regs:
            smem = re.search(r"(\d+) bytes smem", line)
            bars = re.search(r"used (\d+) barriers", line)
            cur.update(registers=int(regs[1]),
                       smem=int(smem[1]) if smem else 0,
                       barriers=int(bars[1]) if bars else 0)
    return report


# x, u2, f32s, i32s, wins, out, T, C, fp, ip
_TRACK_SCAN_ARGS = [_PTR] * 6 + [_INT, _INT] + [_PTR, _PTR]
# x, u2, cp, dop, ph, out, C, fs
_EPL_ARGS = [_PTR] * 6 + [_INT, _FLOAT]
# x, out, variant, C, K, G
_CHAIN_ARGS = [_PTR] * 2 + [_INT] * 4
# x, out, st, sti, variant, C, G
_CONSTRUCTS_ARGS = [_PTR] * 4 + [_INT] * 3
# x, w, st, wst, variant, C, G
_LAYOUT_ARGS = [_PTR] * 4 + [_INT] * 3
# x, amt, out, R, W, src_row
_ROLL_ROWS_ARGS = [_PTR] * 3 + [_INT] * 3
# u2, mc, es, e, p, l, R
_BARREL_ARGS = [_PTR] * 6 + [_INT]
# x, table, cp0, rate, dop, out, E, C, S, s_over_fs, fs
_SQ_PROMPTS_ARGS = [_PTR] * 6 + [_INT] * 3 + [_FLOAT] * 2
# x, table, cp, dop, corr, power, E, C, S, K, cps, s_over_fs, fs
_PRETRACK_POWER_ARGS = [_PTR] * 6 + [_INT] * 4 + [_FLOAT] * 3
# x, taps, out, n, frames, L, M, D, off_max
_IF_RESAMPLE_ARGS = [_PTR] * 3 + [_LONG] + [_INT] * 5


# cached: the wrapper asks for its library on every launch, and finding
# nvcc on PATH costs more host time than the launch itself
@functools.cache
def cuda_lib() -> ctypes.CDLL:
    """The tracking-scan kernel library (``track_scan_launch``,
    ``track_scan_channels_per_block``), built with nvcc for sm_90a at
    first use."""
    return _load("track_scan_cuda", [_nvcc()] + NVCC_FLAGS,
                 ["track_scan.cu"],
                 {"track_scan_launch": _TRACK_SCAN_ARGS + [_PTR],
                  "track_scan_channels_per_block": [_INT]})


@functools.cache
def epl_lib() -> ctypes.CDLL:
    """The per-epoch E/P/L kernel library (``epl_launch``)."""
    return _load("epl_cuda", [_nvcc()] + NVCC_FLAGS, ["epl.cu"],
                 {"epl_launch": _EPL_ARGS + [_PTR]})


@functools.cache
def corr_bank_lib() -> ctypes.CDLL:
    """The correlator-bank probe library (``corr_bank_fma_launch``,
    ``corr_bank_mma_launch``)."""
    # fma: yr, yi, rep, out, partial; mma: yr, yi, repT, mask, out,
    # partial; then C, T, stream
    return _load("corr_bank_cuda", [_nvcc()] + NVCC_FLAGS,
                 ["corr_bank.cu"],
                 {"corr_bank_fma_launch": [_PTR] * 5 + [_INT, _INT, _PTR],
                  "corr_bank_mma_launch": [_PTR] * 6 + [_INT, _INT, _PTR]})


@functools.cache
def forest_lib() -> ctypes.CDLL:
    """The epoch-cost probes' library (``forest_chain_launch``,
    ``forest_constructs_launch``, ``forest_layout_launch``)."""
    return _load("forest_cuda", [_nvcc()] + NVCC_FLAGS, ["forest.cu"],
                 {"forest_chain_launch": _CHAIN_ARGS + [_PTR],
                  "forest_constructs_launch": _CONSTRUCTS_ARGS + [_PTR],
                  "forest_layout_launch": _LAYOUT_ARGS + [_PTR]})


@functools.cache
def roll_lib() -> ctypes.CDLL:
    """The roll probes' library (``roll_rows_launch``, ``barrel_launch``)."""
    return _load("roll_cuda", [_nvcc()] + NVCC_FLAGS, ["roll.cu"],
                 {"roll_rows_launch": _ROLL_ROWS_ARGS + [_PTR],
                  "barrel_launch": _BARREL_ARGS + [_PTR]})


@functools.cache
def pretrack_lib() -> ctypes.CDLL:
    """The handoff search's library (``sq_prompts_launch``,
    ``pretrack_power_launch``)."""
    return _load("pretrack_cuda", [_nvcc()] + NVCC_FLAGS, ["pretrack.cu"],
                 {"sq_prompts_launch": _SQ_PROMPTS_ARGS + [_PTR],
                  "pretrack_power_launch": _PRETRACK_POWER_ARGS + [_PTR]})


@functools.cache
def if_resample_lib() -> ctypes.CDLL:
    """The real-IF ingest's library (``if_resample_launch``)."""
    return _load("if_resample_cuda", [_nvcc()] + NVCC_FLAGS,
                 ["if_resample.cu"],
                 {"if_resample_launch": _IF_RESAMPLE_ARGS + [_PTR]})


@functools.cache
def host_lib() -> ctypes.CDLL:
    """The host build of the kernels' arithmetic (``track_scan_host``,
    ``k1_channels_per_block``, ``watchdog_host``, ``code_phase_mod_host``,
    ``epl_host``, ``forest_chain_host``, ``forest_constructs_host``,
    ``forest_layout_host``, ``forest_layout_col_host``,
    ``forest_trig_host``, ``roll_rows_host``, ``barrel_host``,
    ``pretrack_states_host``, ``pretrack_chip_host``, ``sq_prompts_host``,
    ``pretrack_power_host``, ``if_resample_host``), built with g++ at
    first use."""
    return _load("kernels_host", ["g++"] + GXX_FLAGS,
                 ["kernels_host.cpp", "forest_host.cpp", "roll_host.cpp",
                  "pretrack_host.cpp", "if_resample_host.cpp"],
                 {"track_scan_host": _TRACK_SCAN_ARGS,
                  "k1_channels_per_block": [_INT, _INT],
                  # wins, sgn, hold, trans, win, n
                  "watchdog_host": [_PTR] * 4 + [_INT, _INT],
                  "code_phase_mod_host": [_PTR] * 3 + [_INT],
                  "epl_host": _EPL_ARGS,
                  "forest_chain_host": _CHAIN_ARGS,
                  "forest_constructs_host": _CONSTRUCTS_ARGS,
                  "forest_layout_host": _LAYOUT_ARGS,
                  "forest_layout_col_host": _LAYOUT_ARGS,
                  "forest_trig_host": [_PTR, _PTR, _INT, _INT],
                  "roll_rows_host": _ROLL_ROWS_ARGS,
                  "barrel_host": _BARREL_ARGS,
                  # cp0, rate, dop, cp_out, ph_out, E, C, S, s_over_fs
                  "pretrack_states_host": [_PTR] * 5 + [_INT] * 3
                  + [_FLOAT],
                  # rate, k, base, out, n
                  "pretrack_chip_host": [_PTR] * 4 + [_INT],
                  "sq_prompts_host": _SQ_PROMPTS_ARGS,
                  "pretrack_power_host": _PRETRACK_POWER_ARGS,
                  "if_resample_host": _IF_RESAMPLE_ARGS})
