"""The weak-signal chain's first and later runs in one fresh process on
the card.

    python -m stm32f4_sdr_gps_torch.probes.weak_chain [--phase 11|12]
        [--runs N]

Simulates the capture of chip_smoke.py's phase 11 (``fix_scenario(
num_epochs=36_000, cn0_dbhz=32.0)``, ``DEEP_ACQ`` + ``COHERENT_TRACK``)
or phase 12 (66 000 epochs at 29 dBHz with the frame sent twice,
``ULTRA_ACQ`` + ``DEEP_COHERENT_TRACK``), builds K1's library (or finds
it built), then runs ``Receiver.run`` on the card with
``track_block_epochs=1000`` ``N`` times (default 2).  The first run is
what a fresh process pays beyond the build, as the CLI does: CUDA's,
cuFFT's and cuBLAS's first calls; the later runs are warm, as
chip_smoke.py's phases 11 and 12 are (they follow phases 1-10).

Prints one JSON line a run: wall seconds, real-time factor, K1 launches,
fix error (m), and each profiler stage's calls, mean and total ms and
overruns (the ``track`` stage's budget is its block's length of
signal, so an overrun is a block tracked slower than real time); then the
build's seconds and the card's ``nvidia-smi`` name and power limit.
Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

PHASES = {
    11: (dict(num_epochs=36_000, cn0_dbhz=32.0), "DEEP_ACQ",
         "COHERENT_TRACK"),
    12: (dict(num_epochs=66_000, cn0_dbhz=29.0, frame_repeats=2),
         "ULTRA_ACQ", "DEEP_COHERENT_TRACK"),
}


def run_once(sc, cfg, device="cuda") -> dict:
    """One ``Receiver.run`` on ``device`` (the card unless the caller asks
    for the CPU); its record, with each channel's bit sync, ephemeris mask
    (subframes 1-3 as bits 0-2), SNR and subframes."""
    import numpy as np
    import torch

    from stm32f4_sdr_gps_torch.ops import track_scan as ts
    from stm32f4_sdr_gps_torch.runtime.receiver import Receiver

    ts.track_scan_cuda.launches = 0
    rx = Receiver(cfg, device=device)
    t0 = time.perf_counter()
    report = rx.run(sc.samples)
    if rx.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sol = report.solutions[-1] if report.solutions else None
    return {
        "wall_s": wall,
        "x_real_time": len(sc.samples) / cfg.plan.sample_rate_hz / wall,
        "k1_launches": ts.track_scan_cuda.launches,
        "fix_error_m": (float(np.linalg.norm(sol.rr - sc.rr_true))
                        if sol is not None else None),
        "stages": {name: {"calls": st.calls, "mean_ms": st.mean_s * 1e3,
                          "total_ms": st.total_s * 1e3,
                          "overruns": st.overruns}
                   for name, st in sorted(rx.profiler.stages.items())},
        "solutions": len(report.solutions),
        "channels": [{"prn": ch.prn, "bit_synced": bool(ch.bit_synced),
                      "eph_full": bool(ch.eph.has_full_set),
                      "mask": ch.eph.received_mask_proc,
                      "snr_db": float(ch.snr_db),
                      "subframes": ch.subframe_count}
                     for ch in report.channels],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", type=int, choices=sorted(PHASES), default=11)
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("weak_chain: needs a CUDA device", file=sys.stderr)
        return 1
    from stm32f4_sdr_gps_torch import config
    from stm32f4_sdr_gps_torch.ops import kernel_lib
    from stm32f4_sdr_gps_torch.signal.scenarios import fix_scenario

    kw, acq, track = PHASES[args.phase]
    t0 = time.perf_counter()
    sc = fix_scenario(**kw)
    sim_s = time.perf_counter() - t0
    cfg = config.ReceiverConfig(prns=sc.prns, track_block_epochs=1000,
                                acq=getattr(config, acq),
                                track=getattr(config, track))
    t0 = time.perf_counter()
    kernel_lib.cuda_lib()
    build = dict(kernel_lib.build_info.get("track_scan_cuda", {}))
    build.pop("log", None)
    build["build_and_load_s"] = time.perf_counter() - t0
    for i in range(args.runs):
        rec = {"phase": args.phase, "run": i + 1, "acq": acq,
               "track": track, **run_once(sc, cfg)}
        print(json.dumps(rec))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"simulate_s": sim_s, "k1_build": build}))
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
