"""The extended K-bit data-wipeoff PLL (``pll_ext_bits``) against the
per-bit coherent loop from a synced handoff (the port of the JAX
package's tools/ext_pll_tune.py).

    python -m stm32f4_sdr_gps_torch.probes.ext_pll [--bits 75]
        [--seeds 42 7 21] [--cn0 26 25 24 23] [--device cuda]

The synced-handoff scenario (the aided / fading use case of
COHERENT_TRACK): PRN 12 at 250 Hz with real 20 ms nav bits, tracked by
``track_block`` from a state whose bit grid is already synced
(``period_sync_ok = 1``, ``right_period_cnt = 10``), per-bit
``COHERENT_TRACK`` against ``DEEP_COHERENT_TRACK`` (``pll_ext_bits = 5``)
at each C/N0 and seed.  Counts the decided nav bits' errors modulo the
polarity and the 95th-percentile Doppler error, summed (errors, bits)
and maxed (Doppler) over the seeds.  On the card ``track_block`` is the
tracking-scan kernel K1 in its ``coherent_pll`` modes; on the CPU the
reference scan.  The environment's EXT_C1 / EXT_C2 / EXT_K override the
ext loop's gains and K on the command line, as in the tool.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

from ..config import COHERENT_TRACK, DEEP_COHERENT_TRACK
from .stress import run_track

CIB = 20
PRN, DOPPLER_HZ = 12, 250.0
CN0S = (26.0, 25.0, 24.0, 23.0)
SEEDS = (42, 7, 21)
N_BITS = 75


def ext_config(env=None):
    """DEEP_COHERENT_TRACK with the tool's EXT_C1 / EXT_C2 / EXT_K
    overrides from ``env`` (none when None)."""
    env = env or {}
    ext = DEEP_COHERENT_TRACK
    if env.get("EXT_C1"):
        ext = dataclasses.replace(ext, pll_ext_c1=float(env["EXT_C1"]))
    if env.get("EXT_C2"):
        ext = dataclasses.replace(ext, pll_ext_c2=float(env["EXT_C2"]))
    if env.get("EXT_K"):
        ext = dataclasses.replace(ext, pll_ext_bits=int(env["EXT_K"]))
    return ext


def capture(cn0, seed, n_bits=N_BITS):
    """(samples, planted bits) of one C/N0 and seed."""
    from ..signal.nav_message import build_bitstream
    from ..signal.scenarios import CANONICAL_EPH
    from ..signal.simulator import SimSat, simulate_capture

    stream = build_bitstream(CANONICAL_EPH, start_tow_6s=40,
                             num_subframes=5, subframe_ids=(1, 2, 3, 4, 5))
    bits = list(stream[:n_bits])
    sat = SimSat(prn=PRN, doppler_hz=DOPPLER_HZ, code_phase_chips=0.0,
                 cn0_dbhz=cn0, codes_in_bit=CIB, nav_bits=bits)
    x, _ = simulate_capture([sat], num_epochs=CIB * len(bits), seed=seed)
    return x, bits


def run(cfg, x, bits, device="cuda"):
    """One synced handoff through ``track_block`` under ``cfg``:
    (bit errors modulo polarity, bits decided, 95th-percentile |Doppler
    error| in Hz, the final state, the outputs)."""
    st, outs = run_track(x, [PRN], [0.0], [DOPPLER_HZ], cfg, device,
                         synced=True)
    ready = outs.bit_ready[:, 0].cpu().numpy()
    vals = outs.bit_value[:, 0].cpu().numpy()[ready]
    eps = outs.bit_epoch[:, 0].cpu().numpy()[ready].astype(int)
    planted = np.array([bits[e // CIB] for e in eps])
    errs = min(int(np.sum(vals != planted)),
               int(np.sum((1 - vals) != planted)))
    dop = float(np.percentile(
        np.abs(outs.doppler_hz[:, 0].cpu().numpy() - DOPPLER_HZ), 95))
    return errs, len(vals), dop, st, outs


def sweep(cn0s=CN0S, seeds=SEEDS, n_bits=N_BITS, device="cuda", ext=None):
    """Both loops at each C/N0 on every seed (one capture for both):
    a row per C/N0 and loop, {"cn0", "loop", "errs", "bits", "dop95_hz",
    "seeds": [(errors, bits, Doppler p95) a seed]}."""
    loops = (("per-bit", COHERENT_TRACK),
             ("ext", ext if ext is not None else DEEP_COHERENT_TRACK))
    rows = []
    for cn0 in cn0s:
        caps = [capture(cn0, seed, n_bits) for seed in seeds]
        for name, cfg in loops:
            per = [run(cfg, x, bits, device)[:3] for x, bits in caps]
            rows.append({"cn0": cn0, "loop": name,
                         "errs": sum(p[0] for p in per),
                         "bits": sum(p[1] for p in per),
                         "dop95_hz": max(p[2] for p in per),
                         "seeds": per})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bits", type=int, default=N_BITS)
    ap.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    ap.add_argument("--cn0", type=float, nargs="+", default=list(CN0S))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ext = ext_config(os.environ)
    print(f"ext: K={ext.pll_ext_bits} c1={ext.pll_ext_c1} "
          f"c2={ext.pll_ext_c2} dll=({ext.dll_c1},{ext.dll_c2})", flush=True)
    rows = sweep(args.cn0, args.seeds, args.bits, args.device, ext)
    for r in rows:
        print(f"cn0={r['cn0']:4.1f} {r['loop']:8s} errs={r['errs']:4d}/"
              f"{r['bits']} dop95={r['dop95_hz']:6.2f} Hz")
    print(json.dumps({"device": args.device, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
