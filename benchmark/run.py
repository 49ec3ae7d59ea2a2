"""The port's benchmark: one run of one cell.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  Set-up (imports, the kernels' load or
build, the captures made on the card from the seed, one warm job on
each capture or a few cold starts), then a window of ``--seconds`` of
the cell's closed loop, then the comparison of every answer with the
plain reference (``truth``).  With ``--trace 1`` a traced sub-window
follows the window for the device metrics.  The last line of standard
output is the result as one JSON object; the numbers compared, each
beside its limit, are the last lines of standard error.  Exit 2 without
a result where the card is missing, 3 where JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import os
import time

_T0 = time.perf_counter()

# one process with one compute thread a pool: the host work is eager
# Python around small launches, and idle worker threads only add jitter
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_v, "1")

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import gen, roofline, scene, spec, truth  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "stm32f4_sdr_gps_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def p95(values) -> float:
    """95th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(values, float), 95))


class Run:
    """One run of a cell on ``device``: ``setup``, ``window``, then
    ``finish`` and ``judge``."""

    def __init__(self, cell: spec.Cell, seed: int, device,
                 control: bool = False):
        from . import jobs

        self.jobs = jobs
        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        self.tr = cell.traffic
        self.kind = self.tr["kind"]
        self.rcfg = jobs.receiver_config(cell.config, self.tr, control)
        self.records: list = []
        self.ctx: dict = {"kind": self.kind}

    # -- set-up ----------------------------------------------------------

    def setup(self) -> None:
        cfg, tr = self.cell.config, self.tr
        t0 = time.perf_counter()
        n_cap = tr["captures"]
        span = tr["capture_epochs"]
        self.scenes = [scene.build(cfg, self.seed, k, span * 1e-3)
                       for k in range(n_cap)]
        self.data = [gen.synthesize(sc, cfg["frontend"], span,
                                    self.seed * 7919 + k, self.device)
                     for k, sc in enumerate(self.scenes)]
        self._sync()
        t1 = time.perf_counter()
        if self.kind == "coldstart":
            self.offsets = self.jobs.coldstart_offsets(
                self.seed, n_cap, span, tr["window_epochs"])
            for k in range(tr["warm_starts"]):
                self._coldstart(record=False)
        else:
            self.next_capture = 0
            for _ in range(tr["warm_jobs"]):
                job = self._new_job()
                while not job.done:
                    job.step()
        self._sync()
        self.setup_split = {"captures_s": t1 - t0,
                            "warm_s": time.perf_counter() - t1}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _new_job(self):
        k = self.next_capture % len(self.data)
        self.next_capture += 1
        return self.jobs.ReplayJob(self.data[k], k, self.rcfg, self.tr,
                                   self.device)

    def _coldstart(self, record: bool = True):
        cap, off = next(self.offsets)
        cs = self.jobs.ColdStart(self.data[cap], cap, off, self.rcfg,
                                 self.tr, self.device)
        cs.run()
        if record:
            self.records.append(cs.record())
        return cs

    # -- the window ------------------------------------------------------

    def window(self, seconds: float) -> None:
        from stm32f4_sdr_gps_torch.utils import graphs

        captures0 = graphs.stats["captures"]
        t0 = time.perf_counter()
        deadline = t0 + seconds
        if self.kind == "coldstart":
            walls, acq, pre, cond = [], [], [], []
            while True:
                cs = self._coldstart()
                walls.append(cs.wall_s)
                cond.append(cs.condition_s)
                st = cs.rx.profiler.stages
                acq.append(st["acquire"].last_s)
                pre.append(st["pretrack"].last_s)
                if time.perf_counter() >= deadline:
                    break
            self.window_s = time.perf_counter() - t0
            self.ctx["cold"] = dict(wall_s=walls, acquire_s=acq,
                                    pretrack_s=pre, condition_s=cond)
        else:
            tracked, jobs_in = 0, []
            job = None
            while True:
                if job is None or job.done:
                    job = self._new_job()
                    jobs_in.append(job)
                tracked += job.step()
                if time.perf_counter() >= deadline:
                    break
            self.window_s = time.perf_counter() - t0
            stages: dict = {}
            for j in jobs_in:
                for name, st in j.rx.profiler.stages.items():
                    stages[name] = stages.get(name, 0.0) + st.total_s
            self.ctx.update(
                tracked_epochs=tracked, jobs_started=len(jobs_in),
                stages_s=stages,
                condition_s=sum(j.condition_s for j in jobs_in))
            self.window_jobs = jobs_in
            self.inflight = job
        self.ctx["captures"] = graphs.stats["captures"] - captures0
        self.ctx["window_s"] = self.window_s

    def finish(self) -> None:
        """Runs the in-flight job to its end (untimed) and collects the
        window's records."""
        if self.kind == "coldstart":
            return
        while not self.inflight.done:
            self.inflight.step()
        self.records.extend(j.record() for j in self.window_jobs)
        self.window_jobs = None
        self.inflight = None

    # -- the traced sub-window --------------------------------------------

    def traced(self) -> None:
        from .trace import Trace

        blocks, bound, epochs = 0, 0.0, 0
        with Trace() as tr:
            if self.kind == "coldstart":
                for _ in range(self.tr["trace_starts"]):
                    self._coldstart()
            else:
                for _ in range(self.tr["trace_jobs"]):
                    job = self._new_job()
                    while not job.done:
                        n = job.step()
                        if n:
                            blocks += 1
                            epochs += n
                            bound += roofline.k1_bound_s(
                                n, len(job.rx.channels))
                    self.records.append(job.record())
        self.ctx["trace"] = dict(tr.summary, blocks=blocks, epochs=epochs,
                                 k1_bound_s=bound)

    # -- the verdict -----------------------------------------------------

    def check(self, recs: list, handoff: str = "handoff") -> dict:
        """The numbers ``truth`` reads from the records ``recs``."""
        rc = self.cell.config["receiver"]
        searched = tuple(rc["prns"])
        if self.kind == "coldstart":
            lag = truth.frontend_lag_s(self.cell.config["frontend"])
            return truth.check_coldstart(recs, self.scenes, searched, lag,
                                         handoff)
        return truth.check_replay(recs, self.scenes, rc["solve_period_ms"],
                                  searched)

    def judge(self, handoff: str = "handoff") -> tuple:
        """(correct, attempted, failed, [[name, value, limit], ...])."""
        lims = truth.limits(self.cell.config, self.kind)
        failed = sum(not truth.judge(self.check([r], handoff), lims)[0]
                     for r in self.records)
        self.read = self.check(self.records, handoff)
        ok, rows = truth.judge(self.read, lims)
        return ok and bool(self.records), len(self.records), failed, rows

    def end_to_end(self, setup_s: float) -> dict:
        out = {}
        for m in self.cell.end_to_end:
            name = m["name"]
            if name == "setup_s":
                v = setup_s
            elif name == "rt_x":
                v = self.ctx["tracked_epochs"] * 1e-3 / self.window_s
            elif name == "coldstart_p95_ms":
                v = p95(self.ctx["cold"]["wall_s"]) * 1e3
            else:
                raise KeyError(f"no end-to-end metric {name!r}")
            out[name] = {"value": v, "unit": m["unit"]}
        return out

    def per_layer(self) -> dict:
        out = {}
        for m in self.cell.per_layer:
            v = spec.reader(m["name"])(self.ctx)
            if v is not None:
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
        return out


def _breakdown(summary: dict) -> dict:
    ops = sorted(summary["device_ops"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in summary["idle_gaps"][:10]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.load(args.workload, os.getcwd())
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); "
              f"cuda available: {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats(0)
    run = Run(cell, args.seed, device)
    imports_s = time.perf_counter() - _T0
    run.setup()
    setup_s = time.perf_counter() - _T0
    run.window(args.seconds)
    memory_peak = torch.cuda.max_memory_allocated(0)
    run.finish()
    if args.trace:
        run.traced()
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    correct, attempted, failed, rows = run.judge()
    metrics = run.per_layer() if args.trace else run.end_to_end(setup_s)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if args.trace:
        s = run.ctx["trace"]
        dev.update(busy_s=s["busy_s"], window_s=s["window_s"])
        result["breakdown"] = _breakdown(s)
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}

    from . import hostinfo

    for k, v, lim in rows:
        print(f"check {k}: {v} (limit {lim})", file=sys.stderr)
    print(json.dumps({"card": hostinfo.card(), "host_cpu": hostinfo.cpu(),
                      "seed": args.seed, "window_s": run.window_s,
                      "setup_s": setup_s, "imports_s": imports_s,
                      **run.setup_split, "read": run.read}))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
