"""K1's epoch by part: the tracking scan's time per 1000-epoch block with
parts of its epoch left out, and with other threads per channel, on the
card.

    python -m stm32f4_sdr_gps_torch.probes.scan_parts [C ...]

The shipped kernel (``csrc/track_scan.cu``, ``full``) is timed beside
builds of patched copies of its source, written under ``_build/`` (the
patches are exact text replacements at fixed anchors, ``PATCHES``; each
anchor must occur once, so an edit of the kernel that moves one fails
here and not silently).  Every part left in sees the inputs it sees in
the real scan, so it takes the real scan's branches:

* ``record``: the kernel, also storing each epoch's six sums and the
  channel's code phase, Doppler and carrier phase after its update,
  (T, C, 9) floats; its outputs must equal the kernel's bit for bit;
* ``replay``: nothing left out, but the update takes the recorded sums
  (plus 0 times its own) read as the builds below read them: the
  replay's own cost; its outputs must equal the kernel's bit for bit;
* ``no_samples``: no sample loop (each thread's sums a stand-in); the
  update takes the recorded sums, so its outputs must equal the kernel's
  bit for bit;
* ``no_update``: no loop update: the code phase, Doppler and carrier
  phase come from the record (the output slots take the sums), so the
  sample loop reads what it reads in the scan and its sums must equal the
  recorded ones bit for bit;
* ``no_staging``: the first two epochs are staged and no later one (no
  copies, no waits), so the sample loop reruns them; the update takes the
  recorded sums (plus 0 times the loop's, which keeps the loop), so the
  outputs must equal the kernel's bit for bit;
* ``rest``: neither sample loop nor update; ``rest_no_staging``: nor
  staging.  Their outputs are stand-ins and are not checked;
* ``threads_N``: the kernel with N threads per channel (``K1_THREADS``).
  Its sums are added in another order, so a decision that lies within
  float32 summation error of zero may go the other way: whether its
  integer decisions equal the kernel's and its prompt sums' largest
  difference are reported, not checked.

The replaying builds read the record one epoch ahead into registers, so
the record's loads stay off the epoch's critical path.  At each channel
count C (default 4, 32 and 256; the 32-channel scenario of
probes/scan_time.py, tiled), one JSON line per build: its ms per block
(median of 5 x 20 launches by CUDA events), the channels per block, the
check and ptxas's registers, stack frame and spills; then the card's
``nvidia-smi`` name and power limit.  Exits 1 without a card, 2 on a bad
argument, 3 if a check fails.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from ..ops import kernel_lib

CHANNELS = (4, 32, 256)
THREADS = (64, 256, 512)

_PRELUDE = '''
// probes/scan_parts.py: the parts of the epoch left out (0 or 1 each) and
// the record of each epoch's sums and loop state, (T, C, 9) floats
#ifndef SP_RECORD
#define SP_RECORD 0
#endif
#ifndef SP_REPLAY_SUMS
#define SP_REPLAY_SUMS 0
#endif
#ifndef SP_NO_SAMPLES
#define SP_NO_SAMPLES 0
#endif
#ifndef SP_NO_UPDATE
#define SP_NO_UPDATE 0
#endif
#ifndef SP_NO_STAGING
#define SP_NO_STAGING 0
#endif
constexpr bool SP_SUMS = SP_REPLAY_SUMS || SP_NO_SAMPLES || SP_NO_STAGING;
constexpr bool SP_REPLAY = SP_SUMS || SP_NO_UPDATE;
__device__ float* scan_parts_rec;
extern "C" int scan_parts_set_record(void* rec) {
    return static_cast<int>(
        cudaMemcpyToSymbol(scan_parts_rec, &rec, sizeof(rec)));
}
'''

_UPDATE = '''{
                if (SP_SUMS) {
#pragma unroll
                    for (int j = 0; j < 6; ++j)
                        sums[j] = rec[j] + 0.f * sums[j];
                }
                if (SP_NO_UPDATE) {
#pragma unroll
                    for (int j = 0; j < M::nout; ++j) o[j] = sums[j % 6];
                    st.f[track::CP] = rec[6];
                    st.f[track::DOP] = rec[7];
                    st.f[track::PH] = rec[8];
                } else {
                    track::epoch_update<M>(st, sums, p, c, o);
                }
                if (SP_RECORD && lane == 0) {
                    float* r = scan_parts_rec + ((size_t)t * C + c) * 9;
#pragma unroll
                    for (int j = 0; j < 6; ++j) r[j] = sums[j];
                    r[6] = st.f[track::CP];
                    r[7] = st.f[track::DOP];
                    r[8] = st.f[track::PH];
                }
            }'''

# (anchor, replacement) in csrc/track_scan.cu
PATCHES = [
    ('#include "track_epoch.cuh"\n', '#include "track_epoch.cuh"\n'
     + _PRELUDE),
    ('    for (int t = 0; t < T; ++t) {\n        const int b = t & 1;\n',
     '''    float rec_next[9] = {};
    if (SP_REPLAY && live && updater) {
#pragma unroll
        for (int j = 0; j < 9; ++j) rec_next[j] = scan_parts_rec[c * 9 + j];
    }
    for (int t = 0; t < T; ++t) {
        const int b = t & 1;
        float rec[9];
#pragma unroll
        for (int j = 0; j < 9; ++j) rec[j] = rec_next[j];
        if (SP_REPLAY && live && updater && t + 1 < T) {
#pragma unroll
            for (int j = 0; j < 9; ++j)
                rec_next[j] =
                    scan_parts_rec[((size_t)(t + 1) * C + c) * 9 + j];
        }
'''),
    ('            wait_epoch(&s_bar[b], (t >> 1) & 1);\n',
     '            if (!SP_NO_STAGING || t < 2)\n'
     '                wait_epoch(&s_bar[b], (t >> 1) & 1);\n'),
    ('            float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};\n',
     '''            float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            if (SP_NO_SAMPLES) {
#pragma unroll
                for (int j = 0; j < 6; ++j) acc[j] = ph * (float)(tid + j);
            }
'''),
    ('            for (int j = 0; j < NJ; ++j) {\n',
     '            for (int j = 0; j < (SP_NO_SAMPLES ? 0 : NJ); ++j) {\n'),
    ('        if (threadIdx.x == STAGER && t + 2 < T)\n',
     '        if (threadIdx.x == STAGER && t + 2 < T && !SP_NO_STAGING)\n'),
    ('            track::epoch_update<M>(st, sums, p, c, o);', _UPDATE),
]
# the threads per channel in csrc/track_epoch.cuh
THREADS_ANCHOR = "constexpr int K1_THREADS = 128;"

PARTS = {
    "record": ("SP_RECORD",),
    "replay": ("SP_REPLAY_SUMS",),
    "no_samples": ("SP_NO_SAMPLES",),
    "no_update": ("SP_NO_UPDATE",),
    "no_staging": ("SP_NO_STAGING",),
    "rest": ("SP_NO_SAMPLES", "SP_NO_UPDATE"),
    "rest_no_staging": ("SP_NO_SAMPLES", "SP_NO_UPDATE", "SP_NO_STAGING"),
}
BUILDS = list(PARTS) + [f"threads_{n}" for n in THREADS]


def _replace_once(text: str, old: str, new: str, where: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"scan_parts: anchor found {text.count(old)} "
                           f"times in {where}: {old.strip()[:60]!r}")
    return text.replace(old, new)


def patched_sources(build: str) -> dict:
    """The build's csrc/track_scan.cu and csrc/track_epoch.cuh, as
    {file name: text}."""
    if build not in BUILDS:
        raise ValueError(f"unknown build {build!r}")
    files = {}
    for name in ("track_scan.cu", "track_epoch.cuh"):
        with open(os.path.join(kernel_lib.CSRC, name)) as f:
            files[name] = f.read()
    if build in PARTS:
        for old, new in PATCHES:
            files["track_scan.cu"] = _replace_once(
                files["track_scan.cu"], old, new, "track_scan.cu")
    else:
        files["track_epoch.cuh"] = _replace_once(
            files["track_epoch.cuh"], THREADS_ANCHOR,
            f"constexpr int K1_THREADS = {build.split('_')[1]};",
            "track_epoch.cuh")
    return files


def load(build: str) -> ctypes.CDLL:
    """Build (at first use) and load one of the ``BUILDS``."""
    csrc = os.path.join(kernel_lib.BUILD_DIR, "scan_parts", build)
    os.makedirs(csrc, exist_ok=True)
    for name, text in patched_sources(build).items():
        with open(os.path.join(csrc, name), "w") as f:
            f.write(text)
    signatures = {"track_scan_launch": kernel_lib._TRACK_SCAN_ARGS
                  + [ctypes.c_void_p],
                  "track_scan_channels_per_block": [ctypes.c_int]}
    if build in PARTS:
        signatures["scan_parts_set_record"] = [ctypes.c_void_p]
    defines = [f"-D{d}=1" for d in PARTS.get(build, ())]
    return kernel_lib._load(f"scan_parts_{build}",
                            [kernel_lib._nvcc()] + kernel_lib.NVCC_FLAGS
                            + defines, ["track_scan.cu"], signatures, csrc)


def _ptxas(name: str) -> dict:
    k1 = kernel_lib.ptxas_report(kernel_lib.build_info[name]["log"],
                                 "track_scan_kernel")
    return {"registers": max(k["registers"] for k in k1),
            "stack": max(k["stack"] for k in k1),
            "spills": max(k["spill_stores"] + k["spill_loads"] for k in k1)}


def _launch(lib, ps, x, u2, cfg):
    """One launch of ``lib``'s kernel, as ops/track_scan.py:
    track_scan_cuda makes it; returns the new state planes and the
    outputs."""
    import torch

    from ..config import BASEBAND_PLAN
    from ..ops.track_scan import kernel_params

    f32, i32, win = (t.clone() for t in ps)
    fp, ip = kernel_params(BASEBAND_PLAN, cfg)
    t_cnt, c = x.shape[0], u2.shape[0]
    out = torch.empty((t_cnt, int(ip[9]), c), dtype=torch.float32,
                      device=x.device)
    rc = lib.track_scan_launch(
        torch.view_as_real(x).data_ptr(), u2.data_ptr(), f32.data_ptr(),
        i32.data_ptr(), win.data_ptr(), out.data_ptr(), t_cnt, c,
        fp.ctypes.data, ip.ctypes.data,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"scan_parts: launch failed: CUDA error {rc}")
    return (f32, i32, win), out


def run(channels=CHANNELS) -> list:
    """Build everything, then time and check every build at each channel
    count; returns the JSON records (also printed)."""
    import torch

    from ..config import TrackConfig
    from ..ops import track_scan as ts
    from .scan_time import CIB, _block_ms, k1_scenario, tiled

    with ThreadPoolExecutor(len(BUILDS) + 1) as pool:
        futs = [pool.submit(kernel_lib.cuda_lib)] + \
            [pool.submit(load, b) for b in BUILDS]
        full, *libs = [f.result() for f in futs]
    libs = dict(zip(BUILDS, libs))
    ptxas = {"full": _ptxas("track_scan_cuda")}
    ptxas.update({b: _ptxas(f"scan_parts_{b}") for b in BUILDS})
    st, x, u2_all = k1_scenario(torch.device("cuda"))
    cfg = TrackConfig(codes_in_bit=CIB)
    ps_all = ts.state_from_track_state(st)
    records, failed = [], []
    for c in channels:
        ps, u2 = tiled(ps_all, u2_all, c)
        rec = torch.zeros((x.shape[0], c, 9), dtype=torch.float32,
                          device=x.device)
        for b in PARTS:
            if libs[b].scan_parts_set_record(rec.data_ptr()) != 0:
                raise RuntimeError("scan_parts: setting the record failed")
        want_st, want = _launch(full, ps, x, u2, cfg)
        for b in ["full"] + BUILDS:
            lib = full if b == "full" else libs[b]
            got_st, got = _launch(lib, ps, x, u2, cfg)
            torch.cuda.synchronize()
            if b in ("record", "replay", "no_samples", "no_staging"):
                ok = torch.equal(got, want) and all(
                    torch.equal(p, q) for p, q in zip(got_st, want_st))
                check = {"equal_to_kernel": ok}
            elif b == "no_update":
                ok = torch.equal(got[:, :6], rec[..., :6].transpose(1, 2))
                check = {"sums_equal_to_record": ok}
            elif b.startswith("threads"):
                ints = [4, 5, 6, 7, 9]
                ok, check = True, {
                    "ints_equal": torch.equal(got[:, ints], want[:, ints]),
                    "max_prompt_diff": float(
                        (got[:, :2] - want[:, :2]).abs().max())}
            else:
                ok, check = True, {}
            if not ok:
                failed.append((c, b))
            r = {"C": c, "build": b,
                 "G": lib.track_scan_channels_per_block(c),
                 "ms": _block_ms(lambda: _launch(lib, ps, x, u2, cfg)),
                 **check, **ptxas[b]}
            records.append(r)
            print(json.dumps(r), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if failed:
        raise AssertionError(f"scan_parts: checks failed: {failed}")
    return records


def main(argv) -> int:
    try:
        channels = [int(a) for a in argv[1:]] or list(CHANNELS)
    except ValueError:
        channels = []
    if not channels or min(channels) < 1:
        print(f"usage: {argv[0]} [C ...]", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("scan_parts: needs a CUDA device", file=sys.stderr)
        return 1
    try:
        run(channels)
    except AssertionError as e:
        print(e, file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
