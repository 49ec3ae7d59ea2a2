"""Timing and throughput instrumentation.

The firmware's only profiling primitive is the DWT cycle counter
(``delay_us_timer.c``), used to timestamp IRQs, bound the snapshot copy
window and measure solver slices with a >900 us budget alarm
(solving.c:119-138).  Host equivalents: wall-clock stage timers with
budget alarms and a samples/s throughput counter; on the card, a
``torch.profiler`` trace of a block (:meth:`Profiler.device_trace`).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class StageTimer:
    """Accumulating per-stage wall-clock timer with optional budget
    alarm (the solver-slice TIME/TIMEOUT printout, solving.c:133-138)."""

    budget_s: Optional[float] = None
    total_s: float = 0.0
    calls: int = 0
    overruns: int = 0
    last_s: float = 0.0

    @contextlib.contextmanager
    def time(self):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.last_s = dt
        self.total_s += dt
        self.calls += 1
        if self.budget_s is not None and dt > self.budget_s:
            self.overruns += 1

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.calls, 1)


@dataclass
class Throughput:
    """Samples/s counter for the streaming pipeline."""

    samples: int = 0
    seconds: float = 0.0
    _t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, samples: int):
        if self._t0 is None:
            return
        self.seconds += time.perf_counter() - self._t0
        self.samples += samples
        self._t0 = None

    @property
    def samples_per_s(self) -> float:
        return self.samples / max(self.seconds, 1e-12)

    def realtime_factor(self, sample_rate_hz: float) -> float:
        return self.samples_per_s / sample_rate_hz


class Profiler:
    """Named stage timers."""

    def __init__(self):
        self.stages: Dict[str, StageTimer] = {}

    def stage(self, name: str, budget_s: Optional[float] = None) -> StageTimer:
        if name not in self.stages:
            self.stages[name] = StageTimer(budget_s=budget_s)
        return self.stages[name]

    def report(self) -> str:
        rows = [f"{'stage':<16} {'calls':>6} {'mean ms':>9} "
                f"{'total s':>8} {'overruns':>8}"]
        for name, st in sorted(self.stages.items()):
            rows.append(
                f"{name:<16} {st.calls:>6} {st.mean_s * 1e3:>9.2f} "
                f"{st.total_s:>8.2f} {st.overruns:>8}"
            )
        return "\n".join(rows)

    @contextlib.contextmanager
    def device_trace(self, logdir: str):
        """Capture a ``torch.profiler`` trace around a block: the CPU's
        activity, and the card's where CUDA is available.  On exit the
        trace is written into ``logdir`` as a Chrome trace
        (``trace.json``)."""
        import os

        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        with profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
