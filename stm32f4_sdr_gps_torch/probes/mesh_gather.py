"""The MeshReceiver's gather of the tracker's state, left off and done
every block, in one process on the card.

    python -m stm32f4_sdr_gps_torch.probes.mesh_gather [--epochs N]
        [--rounds R]

Simulates ``fix_scenario(num_epochs=N)`` (default 10 000, ten blocks of
1000 epochs), then runs ``MeshReceiver`` with the default config on a
2 x 4 grid of ``cuda:0`` (4 PRNs and 4 ghost channels, K1 once a
position a block): one warm-up run, then ``lazy, eager, eager, lazy``
R times (default 2).  ``lazy`` is the class as it ships: the default
config never reads ``track_state`` during the run, so no block gathers
it.  ``eager`` reads it after every block: the 8 positions' state
planes concatenated on the receiver's device each block, timed in the
profiler's ``gather`` stage.  Every run must end in the same tracker
state, bit for bit.

Prints one JSON line a run (variant, wall seconds, K1 launches, each
profiler stage's calls, mean and total ms), then the median wall and
``track`` / ``gather`` means of each variant, then the card's
``nvidia-smi`` name and power limit.  Exits 1 without a card, 2 if the
runs' states differ.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def _receivers():
    from stm32f4_sdr_gps_torch.runtime.mesh_receiver import MeshReceiver

    class Eager(MeshReceiver):
        """Reads the tracker's state after every block."""

        def _aided_sync_on_shards(self, step, *args) -> None:
            super()._aided_sync_on_shards(step, *args)
            self.track_state      # noqa: B018 -- the read gathers

    return {"lazy": MeshReceiver, "eager": Eager}


def run_once(cls, sc, cfg, mesh) -> tuple:
    """One run; (its record, the tracker's final state)."""
    import torch

    from stm32f4_sdr_gps_torch.ops import track_scan as ts

    ts.track_scan_cuda.launches = 0
    rx = cls(cfg, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rx.run(sc.samples)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = {"wall_s": wall, "k1_launches": ts.track_scan_cuda.launches,
           "stages": {name: {"calls": st.calls, "mean_ms": st.mean_s * 1e3,
                             "total_ms": st.total_s * 1e3}
                      for name, st in sorted(rx.profiler.stages.items())}}
    return rec, rx.tracker.gather_state(rx.device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=10_000)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("mesh_gather: needs a CUDA device", file=sys.stderr)
        return 1
    from stm32f4_sdr_gps_torch.config import ReceiverConfig
    from stm32f4_sdr_gps_torch.parallel.mesh import make_mesh
    from stm32f4_sdr_gps_torch.signal.scenarios import fix_scenario

    sc = fix_scenario(num_epochs=args.epochs)
    cfg = ReceiverConfig(prns=sc.prns, track_block_epochs=1000)
    mesh = make_mesh(time=2, devices=[torch.device("cuda", 0)] * 8)
    classes = _receivers()
    _, ref = run_once(classes["lazy"], sc, cfg, mesh)     # warm-up
    recs = {"lazy": [], "eager": []}
    for _ in range(args.rounds):
        for variant in ("lazy", "eager", "eager", "lazy"):
            rec, state = run_once(classes[variant], sc, cfg, mesh)
            print(json.dumps({"variant": variant, **rec}))
            recs[variant].append(rec)
            for f, g, w in zip(ref._fields, state, ref):
                if not torch.equal(g, w):
                    print(f"mesh_gather: {variant} run's {f} differs",
                          file=sys.stderr)
                    return 2
    summary = {}
    for variant, rs in recs.items():
        summary[variant] = {
            "median_wall_s": statistics.median(r["wall_s"] for r in rs),
            **{f"median_{s}_ms": statistics.median(
                r["stages"][s]["mean_ms"] for r in rs)
               for s in ("track", "gather") if s in rs[0]["stages"]}}
    print(json.dumps({"summary": summary, "epochs": args.epochs,
                      "runs_a_variant": 2 * args.rounds}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
