"""P8's col kernels by part, on the card: red_col and roll_col with
their exchange left out or changed, and the SMs the blocks run on.

    python -m stm32f4_sdr_gps_torch.probes.col_parts [C ...]

The shipped kernels (``csrc/forest.cu``, build ``col``) are timed beside
builds of patched copies of that source, written under ``_build/`` (the
patches are exact text replacements at fixed anchors, ``PATCHES``; each
anchor must occur once, so an edit of the kernel that moves one fails
here and not silently):

* ``no_exchange``: red_col without its exchange (ranks 1-7 push nothing,
  rank 0 waits for nothing and adds its slots' stale contents) and
  roll_col without its halo (no push, no wait; stage 0 reads a stale
  halo): what the iteration costs without the exchange.  Not checked;
* ``slots4``: red_col's slots four deep (iteration & 3) instead of two,
  so ranks 1-7 may run three iterations ahead of rank 0;
* ``sm_ids``: thread 0 of each block writes its SM's id (``%smid``) over
  the first element of its slab, and the record counts the distinct SMs
  (``sms``), which must be C / CG * 8: every block on an SM of its own.

``col`` and ``slots4`` must equal the host build of the
decomposition (``forest_layout.layout_col_host``) bit for bit, at G = 2
on the seeded inputs.  At each channel count C (default 32 and 4), one
JSON line per build and each variant it changes (wide_col only in
``col`` and ``sm_ids``): ns per iteration at G = 128 on the
probe's inputs (``forest_layout.ns_per_iter``'s timing), the check, the
SMs, and ptxas's most registers, stack frame and spills over the
variant's instantiations; then the card's ``nvidia-smi`` name and power
limit.  Exits 1 without a card, 2 on a bad argument, 3 if a check fails.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from ..ops import kernel_lib

CHANNELS = (32, 4)
VARIANTS = ("wide_col", "red_col", "roll_col")

_RED_FREE = "bar_wait(&s_bar[FREE + par], use ^ 1u);"
_RED_PUSH4 = "push4(dst, blk[0], blk[1], blk[2], blk[3], bar);"
_RED_PUSH2 = "push2(dst + 16, blk[4], blk[5], bar);"
_RED_EXPECT = "if (tid == 0) bar_expect(&s_bar[FULL + par], BYTES);"
_RED_FULL = "bar_wait(&s_bar[FULL + par], use);"
_RED_RELEASE = "bar_arrive_remote(remote_addr(&s_bar[FREE + par], lane));"
_ROLL_EXPECT = "if (tid == 0) bar_expect(&s_bar[FULL + p], BYTES);"
_ROLL_FULL = "bar_wait(&s_bar[FULL + p], (uint32_t)(it >> 1) & 1u);"
_ROLL_FREE = "bar_arrive_remote(remote_addr(&s_bar[FREE + p], right));"
_ROLL_PUSH0 = "push_halo<CG>(s_bar, s_halo, left, 0, r[0]);"
_ROLL_PUSH = ("            if (it + 1 < iters && tid < HALO * CG)\n"
              "                push_halo<CG>(s_bar, s_halo, left, it + 1, "
              "r[0]);")

# thread 0 of each block writes its SM's id over the first element of its
# slab in wst
_EXIT = "    if constexpr (V != WIDE_COL) cluster.sync();\n}"
_SM_IDS = (_EXIT, "    if (tid == 0) {\n"
           "        unsigned sm;\n"
           "        asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
           "        wst[base] = (float)sm;\n"
           "    }\n" + _EXIT)
# (anchor, replacement) in csrc/forest.cu, by build
PATCHES = {
    "no_exchange": [(a, ";") for a in (
        _RED_FREE, _RED_PUSH4, _RED_PUSH2, _RED_EXPECT, _RED_FULL,
        _RED_RELEASE, _ROLL_EXPECT, _ROLL_FULL, _ROLL_FREE, _ROLL_PUSH0)]
    + [(_ROLL_PUSH, "            ;")],
    "slots4": [
        ("constexpr int FULL = 0, FREE = 2;",
         "constexpr int FULL = 0, FREE = 4;"),
        ("__shared__ __align__(8) uint64_t s_bar[4];",
         "__shared__ __align__(8) uint64_t s_bar[8];"),
        ("for (int b = 0; b < 4; ++b) bar_init(&s_bar[b]);",
         "for (int b = 0; b < 8; ++b) bar_init(&s_bar[b]);"),
        ("s_slot[V == RED_COL ? 2 : 1]", "s_slot[V == RED_COL ? 4 : 1]"),
        ("const uint32_t use = (uint32_t)(it >> 1) & 1u;  // slot use parity",
         "const uint32_t use = (uint32_t)(it >> 2) & 1u;\n"
         "            const int sl = it & 3;"),
        (_RED_FREE, "bar_wait(&s_bar[FREE + sl], use ^ 1u);"),
        ("remote_addr(&s_slot[par][rank][tid][0], 0);",
         "remote_addr(&s_slot[sl][rank][tid][0], 0);"),
        ("remote_addr(&s_bar[FULL + par], 0);",
         "remote_addr(&s_bar[FULL + sl], 0);"),
        (_RED_EXPECT, "if (tid == 0) bar_expect(&s_bar[FULL + sl], BYTES);"),
        (_RED_FULL, "bar_wait(&s_bar[FULL + sl], use);"),
        ("tj += s_slot[par][b][tid][j];", "tj += s_slot[sl][b][tid][j];"),
        ("lane < COL_RANKS && it + 2 < iters",
         "lane < COL_RANKS && it + 4 < iters"),
        (_RED_RELEASE, _RED_RELEASE.replace("FREE + par", "FREE + sl")),
    ],
    "sm_ids": [_SM_IDS],
}
BUILDS = ("col",) + tuple(PATCHES)
# the builds checked against the host build (sm_ids: the SM count)
CHECKED = ("col", "slots4", "sm_ids")
# which variants each build changes (the others equal the shipped ones)
CHANGES = {"col": VARIANTS, "no_exchange": VARIANTS[1:],
           "slots4": ("red_col",), "sm_ids": VARIANTS}


def _replace_once(text: str, old: str, new: str) -> str:
    n = text.count(old)
    if n != 1:
        raise RuntimeError(f"forest.cu: anchor found {n} times: {old!r}")
    return text.replace(old, new)


def patched_source(build: str) -> str:
    """The build's csrc/forest.cu."""
    if build not in BUILDS:
        raise ValueError(f"unknown build {build!r}")
    with open(os.path.join(kernel_lib.CSRC, "forest.cu")) as f:
        text = f.read()
    for old, new in PATCHES.get(build, []):
        text = _replace_once(text, old, new)
    return text


def load(build: str) -> ctypes.CDLL:
    """Build (once) and load the build's library."""
    if build == "col":
        return kernel_lib.forest_lib()
    csrc = os.path.join(kernel_lib.BUILD_DIR, "col_parts", build)
    os.makedirs(csrc, exist_ok=True)
    with open(os.path.join(csrc, "forest.cu"), "w") as f:
        f.write(patched_source(build))
    for name in ("forest_ops.cuh", "track_epoch.cuh"):
        with open(os.path.join(kernel_lib.CSRC, name)) as f, \
                open(os.path.join(csrc, name), "w") as g:
            g.write(f.read())
    return kernel_lib._load(
        f"col_parts_{build}", [kernel_lib._nvcc()] + kernel_lib.NVCC_FLAGS,
        ["forest.cu"],
        {"forest_layout_launch": kernel_lib._LAYOUT_ARGS + [ctypes.c_void_p]},
        csrc)


def _ptxas(build: str, variant: str) -> dict:
    name = "forest_cuda" if build == "col" else f"col_parts_{build}"
    code = {"wide_col": 3, "red_col": 5, "roll_col": 7}[variant]
    rep = kernel_lib.ptxas_report(kernel_lib.build_info[name]["log"],
                                  f"col_kernelILi{code}E")
    return {"registers": max(k["registers"] for k in rep),
            "stack": max(k["stack"] for k in rep),
            "spills": max(k["spill_stores"] + k["spill_loads"] for k in rep)}


def run(channels=CHANNELS) -> list:
    """Every build at each C, each variant it changes; returns the
    records."""
    import torch

    from . import forest_layout as p8
    from .common import SLEEP_CYCLES, queued_ms, stream, warm_up

    with ThreadPoolExecutor(len(BUILDS)) as pool:
        libs = dict(zip(BUILDS, pool.map(load, BUILDS)))
    recs = []
    for c in channels:
        for v in VARIANTS:
            for build, lib in libs.items():
                if v not in CHANGES[build]:
                    continue

                def launch(x, w, out, g):
                    rc = lib.forest_layout_launch(
                        x.data_ptr(), w.data_ptr(), out[0].data_ptr(),
                        out[1].data_ptr(), p8.VARIANTS.index(v), c, g,
                        stream(x.device))
                    if rc != 0:
                        raise RuntimeError(f"{build} {v}: CUDA error {rc}")

                check, sms = None, None
                if build in CHECKED:
                    x, w, _, g = p8.check_args(v, "seeded", "cuda", c)
                    out = (torch.empty_like(x), torch.empty_like(w))
                    launch(x, w, out, g)
                    torch.cuda.synchronize()
                    if build == "sm_ids":          # a block an SM
                        firsts = out[1].cpu().reshape(8, 256, c)[
                            :, 0, ::min(c, 8)]
                        sms = len(set(firsts.flatten().tolist()))
                        check = sms == firsts.numel()
                    else:
                        want = p8.layout_col_host(x.cpu(), w.cpu(), v, g)
                        check = all(torch.equal(a.cpu(), b)
                                    for a, b in zip(out, want))
                x, w = (torch.as_tensor(a, device="cuda")
                        for a in p8.probe_inputs(v, c))
                out = (torch.empty_like(x), torch.empty_like(w))
                warm_up(lambda: launch(x, w, out, p8.G))
                ns = queued_ms(lambda: launch(x, w, out, p8.G), 5, 10,
                               SLEEP_CYCLES) * 1e6 / (p8.G * p8.ITERS)
                rec = {"build": build, "variant": v, "C": c,
                       "ns_per_iter": ns, "check": check, "sms": sms,
                       **_ptxas(build, v)}
                print(json.dumps(rec), flush=True)
                recs.append(rec)
    return recs


def main(argv) -> int:
    try:
        channels = [int(a) for a in argv[1:]] or list(CHANNELS)
    except ValueError:
        channels = [0]
    if any(c not in (1, 2, 4, 8, 16, 32) for c in channels):
        print(f"usage: {argv[0]} [C ...] (C in 1, 2, 4, 8, 16, 32)",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("col_parts: needs a CUDA device", file=sys.stderr)
        return 1
    recs = run(channels)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 3 if any(r["check"] is False for r in recs) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
