"""The readings that the limits of ``correct`` are set from, on the
card, at the cell's own size, many seeds in one process:

    python3 -m benchmark.readings --workload NAME --seconds S
        --seeds N [N ...] [--control] [--verbose]

Per seed, one line: every number the comparison reads from the run's
answers, beside those compared (the lower readings); with ``--control``
the cell's control runs in the program's place (``jobs.receiver_config``:
a replay solving half as often, a cold start acquiring on half the
epochs and judged on its unrefined Doppler) for the upper readings.
``--verbose`` describes each failing job or start.  The benchmark's own
runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import spec, truth
from .run import Run


def _explain(run, handoff: str) -> None:
    lims = truth.limits(run.cell.config, run.kind)
    for rec in run.records:
        sc = run.scenes[rec["capture"]]
        n = run.check([rec], handoff)
        if truth.judge(n, lims)[0]:
            continue
        sky = [(s.prn, round(s.elevation_deg, 1), round(s.cn0_dbhz, 1),
                round(s.doppler_hz, 1),
                round(truth.sat_ready_s(sc, s), 3)) for s in sc.sats]
        rec = dict(rec, eph=sorted(rec.get("eph", {})),
                   fixes=[f[0] for f in rec.get("fixes", [])])
        print(json.dumps({"numbers": n, "record": rec, "sky": sky}),
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--verbose", action="store_true",
                    help="describe each failing job or start")
    args = ap.parse_args(argv)
    cell = spec.load(args.workload, ".")
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        run = Run(cell, seed, "cuda", control=args.control)
        run.setup()
        run.window(args.seconds)
        run.finish()
        handoff = "acq" if args.control and run.kind == "coldstart" \
            else "handoff"
        ok, attempted, failed, rows = run.judge(handoff)
        read = run.read
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": args.control, "correct": ok,
                          "attempted": attempted, "failed": failed,
                          "read": read}), flush=True)
        if args.verbose and not ok:
            _explain(run, handoff)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
