"""The roll kernels' design choices, timed: each P1-P4 case through the
shipped ``csrc/roll.cu`` and through builds of patched copies of it.

    python -m stm32f4_sdr_gps_torch.probes.roll_parts [rows ...]

The patches (``PATCHES``) are exact text replacements at fixed anchors in
``roll.cu`` or ``roll_ops.cuh``, written under ``_build/roll_parts/``; each
anchor must occur once, so an edit that moves one fails here and not
silently:

* ``shipped``: the source itself;
* ``funnel_loads``: a row roll's four source lanes read as two aligned
  16-byte loads (the chunk holding the first and the next, lane 0 after
  the last) and a funnel by (-a) mod 4, the same in every thread of a
  row, instead of four scalar loads at the wrapped indices (the store
  stays one 16-byte store; the row plane must start 16-byte aligned);
* ``tma_rows``: the row rolls (P1, P2, P4) by one 256-thread block a
  row that brings its whole source row into shared memory with one bulk
  copy (TMA, completing on an mbarrier) issued before the amount is read,
  so the amount's load and the row's overlap, then reads the shifted
  lanes from shared memory (two aligned 16-byte loads and a funnel) and
  stores 16 bytes a chunk; widths that are multiples of 4 up to 4352;
* ``threads_32``, ``threads_64``, ``threads_256``: other threads a block
  (the shipped kernels take 128), each thread still writing four lanes;
* ``chunks_2``, ``chunks_4``: each thread writing two or four 4-lane
  chunks, a block's width apart (the shipped kernels: one), so a row
  takes fewer blocks.

For each build, case (P1's four, P2, P3, P4's two) and row count
(default 8, 32 and 128): the kernel's outputs on the seeded inputs
against the plain version, bit for bit, and the device time per launch
on the tools' inputs (20 launches queued behind a device sleep, median of
5, after a warm-up), one JSON line each; then the card's ``nvidia-smi``
name and power limit.  Exits 1 without a card, 2 on a bad argument, 3 if
a check fails.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from ..ops import kernel_lib

ROWS = (8, 32, 128)
SOURCES = ("roll.cu", "roll_ops.cuh")

_LOADS_OLD = """        store4(dst + j, vec4{src[wrap_src(j, a, w)],
                             src[wrap_src(j + 1, a, w)],
                             src[wrap_src(j + 2, a, w)],
                             src[wrap_src(j + 3, a, w)]});"""
# (src 16-byte aligned; q = (-a) mod 4, the same in every thread of a row)
_FUNNEL_NEW = """        const int s0 = wrap_src(j, a, w), q = s0 & 3, lo = s0 - q;
        const int hi = lo + 4 == w ? 0 : lo + 4;
        const vec4 u = *reinterpret_cast<const vec4*>(src + lo);
        const vec4 v = *reinterpret_cast<const vec4*>(src + hi);
        store4(dst + j, q == 0   ? u
                        : q == 1 ? vec4{u.y, u.z, u.w, v.x}
                        : q == 2 ? vec4{u.z, u.w, v.x, v.y}
                                 : vec4{u.w, v.x, v.y, v.z});"""
_KERNEL_OLD = """__global__ void __launch_bounds__(ROLL_THREADS)
roll_rows_kernel(const float* __restrict__ x, const int* __restrict__ amt,
                 float* __restrict__ out, int W, int src_row) {
    const int r = blockIdx.y;
    const int j0 = blockIdx.x * LANES + threadIdx.x * VEC;
    if (j0 >= W) return;
    const int a = fold(amt[r], W);"""
# one block a row: its source row in one bulk copy (TMA) into shared
# memory, issued before the amount is read, then two aligned 16-byte
# shared loads and a funnel a chunk; W % 4 == 0 and W <= TMA_MAX_W only
_TMA_NEW = """constexpr int TMA_THREADS = 256;
constexpr int TMA_MAX_W = 4352;

__global__ void __launch_bounds__(TMA_THREADS)
roll_rows_tma(const float* __restrict__ x, const int* __restrict__ amt,
              float* __restrict__ out, int W, int src_row) {
    __shared__ __align__(16) float s_row[TMA_MAX_W];
    __shared__ __align__(8) unsigned long long s_bar;
    const int r = blockIdx.y;
    const unsigned bar = (unsigned)__cvta_generic_to_shared(&s_bar);
    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                     :: "r"(bar) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(bar), "r"(W * 4) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];"
            :: "r"((unsigned)__cvta_generic_to_shared(s_row)),
               "l"(x + (size_t)(src_row < 0 ? r : src_row) * W),
               "r"(W * 4), "r"(bar) : "memory");
    }
    const int a = fold(amt[r], W);
    __syncthreads();
    asm volatile("{\\n.reg .pred done;\\nWAIT:\\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\\n"
                 "@!done bra WAIT;\\n}\\n" :: "r"(bar) : "memory");
    float* dst = out + (size_t)r * W;
    for (int j = threadIdx.x * VEC; j < W; j += TMA_THREADS * VEC) {
        const int s0 = wrap_src(j, a, W), q = s0 & 3, lo = s0 - q;
        const int hi = lo + 4 == W ? 0 : lo + 4;
        const vec4 u = *reinterpret_cast<const vec4*>(s_row + lo);
        const vec4 v = *reinterpret_cast<const vec4*>(s_row + hi);
        store4(dst + j, q == 0   ? u
                        : q == 1 ? vec4{u.y, u.z, u.w, v.x}
                        : q == 2 ? vec4{u.z, u.w, v.x, v.y}
                                 : vec4{u.w, v.x, v.y, v.z});
    }
}

""" + _KERNEL_OLD
_LAUNCH_OLD = """    const dim3 grid((W + LANES - 1) / LANES, R);
    roll_rows_kernel<<<grid, ROLL_THREADS, 0,"""
_TMA_LAUNCH = """    if (W % VEC || W > TMA_MAX_W) return invalid();
    const dim3 grid(1, R);
    roll_rows_tma<<<grid, TMA_THREADS, 0,"""
_THREADS_OLD = "constexpr int ROLL_THREADS = 128;"
_CHUNKS_OLD = "constexpr int CHUNKS = 1;"

#: build -> [(source file, anchor, replacement)]
PATCHES = {
    "funnel_loads": [("roll_ops.cuh", _LOADS_OLD, _FUNNEL_NEW)],
    "tma_rows": [("roll.cu", _KERNEL_OLD, _TMA_NEW),
                 ("roll.cu", _LAUNCH_OLD, _TMA_LAUNCH)],
    **{f"threads_{n}": [("roll.cu", _THREADS_OLD,
                         f"constexpr int ROLL_THREADS = {n};")]
       for n in (32, 64, 256)},
    **{f"chunks_{n}": [("roll.cu", _CHUNKS_OLD,
                        f"constexpr int CHUNKS = {n};")]
       for n in (2, 4)},
}
BUILDS = ("shipped",) + tuple(PATCHES)


def _replace_once(text: str, old: str, new: str) -> str:
    n = text.count(old)
    if n != 1:
        raise RuntimeError(f"roll sources: anchor found {n} times: {old!r}")
    return text.replace(old, new)


def patched_sources(build: str) -> dict:
    """The build's csrc/roll.cu and csrc/roll_ops.cuh, by file name."""
    if build not in BUILDS:
        raise ValueError(f"unknown build {build!r}")
    texts = {}
    for name in SOURCES:
        with open(os.path.join(kernel_lib.CSRC, name)) as f:
            texts[name] = f.read()
    for name, old, new in PATCHES.get(build, []):
        texts[name] = _replace_once(texts[name], old, new)
    return texts


def load(build: str) -> ctypes.CDLL:
    """Build (once) and load the build's library."""
    if build == "shipped":
        return kernel_lib.roll_lib()
    csrc = os.path.join(kernel_lib.BUILD_DIR, "roll_parts", build)
    os.makedirs(csrc, exist_ok=True)
    for name, text in patched_sources(build).items():
        with open(os.path.join(csrc, name), "w") as f:
            f.write(text)
    return kernel_lib._load(
        f"roll_parts_{build}", [kernel_lib._nvcc()] + kernel_lib.NVCC_FLAGS,
        ["roll.cu"],
        {"roll_rows_launch": kernel_lib._ROLL_ROWS_ARGS + [ctypes.c_void_p],
         "barrel_launch": kernel_lib._BARREL_ARGS + [ctypes.c_void_p]},
        csrc)


def _cases():
    from . import mosaic_bisect, roll_wide

    return ([(roll_wide, c) for c in roll_wide.CASES]
            + [(mosaic_bisect, c) for c in mosaic_bisect.CASES])


def _launcher(lib, case, args):
    """A function of no arguments that launches the build's kernel for
    the case on ``args`` into preallocated outputs, and the outputs."""
    import torch

    from .common import stream

    if case == "barrel":
        u2, mc, es = args
        out = tuple(torch.empty((u2.shape[0], 2176), device=u2.device)
                    for _ in range(3))
        ptrs = [t.data_ptr() for t in (u2, mc, es, *out)]

        def launch():
            rc = lib.barrel_launch(*ptrs, u2.shape[0], stream(u2.device))
            if rc != 0:
                raise RuntimeError(f"barrel: CUDA error {rc}")
        return launch, out
    x, amt = args
    out = torch.empty_like(x)
    src_row = 0 if case == "statwin" else -1

    def launch():
        rc = lib.roll_rows_launch(x.data_ptr(), amt.data_ptr(),
                                  out.data_ptr(), x.shape[0], x.shape[1],
                                  src_row, stream(x.device))
        if rc != 0:
            raise RuntimeError(f"{case}: CUDA error {rc}")
    return launch, (out,)


def run(rows=ROWS) -> list:
    """Every build, case and row count; returns the records."""
    import torch

    from .common import SLEEP_CYCLES, queued_ms, warm_up

    with ThreadPoolExecutor(len(BUILDS)) as pool:
        libs = dict(zip(BUILDS, pool.map(load, BUILDS)))
    recs = []
    for mod, case in _cases():
        for r in rows:
            for build, lib in libs.items():
                args = mod.check_args(case, "seeded", "cuda", r)
                launch, out = _launcher(lib, case, args)
                launch()
                want = mod.PLAIN[case](*args)
                want = want if isinstance(want, tuple) else (want,)
                check = all(torch.equal(g, w) for g, w in zip(out, want))
                args = mod.check_args(case, "probe", "cuda", r)
                launch, _ = _launcher(lib, case, args)
                warm_up(launch, 0.1)
                us = queued_ms(launch, 5, 20, SLEEP_CYCLES) * 1e3
                rec = {"build": build, "case": case, "rows": r,
                       "us_per_launch": us, "check": check}
                print(json.dumps(rec), flush=True)
                recs.append(rec)
    return recs


def main(argv) -> int:
    try:
        rows = [int(a) for a in argv[1:]] or list(ROWS)
    except ValueError:
        rows = [0]
    if any(not 1 <= r <= 65535 for r in rows):
        print(f"usage: {argv[0]} [rows ...] (1 <= rows <= 65535)",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("roll_parts: needs a CUDA device", file=sys.stderr)
        return 1
    recs = run(rows)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 3 if not all(r["check"] for r in recs) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
