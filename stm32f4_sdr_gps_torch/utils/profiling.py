"""Timing instrumentation: spans, counters and stage timers.

The firmware's only profiling primitive is the DWT cycle counter
(``delay_us_timer.c``), used to timestamp IRQs, bound the snapshot copy
window and measure solver slices with a >900 us budget alarm
(solving.c:119-138).  Host equivalents:

* spans (:func:`span`, and every :class:`StageTimer` call): wall-clock
  intervals, nested per thread, each appended when it closes to the
  bounded process-wide log :data:`spans` as a :class:`Span` record.
  Under an active ``torch.profiler`` a span also opens
  ``record_function("gps." + name)``, so it sits in the device trace
  beside the kernels, on the trace's clock; with none active nothing of
  ``torch.profiler`` is called;
* counters (:func:`count`): process-wide totals in :data:`counters`,
  also added to the innermost open span's record (``readback`` and
  ``upload``, the host<->device copies, ``utils.device``);
* named stage timers with budget alarms (:class:`Profiler`);
* a ``torch.profiler`` trace of a block (:meth:`Profiler.device_trace`).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
from collections import deque
from dataclasses import dataclass, field
from time import perf_counter
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch._C._autograd import _profiler_enabled

#: records kept in :data:`spans`; the oldest are dropped beyond it
SPAN_LOG_SIZE = 65536
#: durations each stage keeps for its p95
STAGE_SAMPLES = 4096


class Span(NamedTuple):
    """One closed span."""

    name: str
    rid: int                 # request id: the Profiler's, else inherited
    parent: Optional[str]    # the enclosing span's name, None at the top
    t0: float                # perf_counter at the start
    dur_s: float
    self_s: float            # dur_s less the child spans' durations
    counts: Dict[str, int]   # counters attributed to this span alone
    traced: bool             # a torch profiler was active at the start


#: the process-wide span log, oldest first
spans: deque = deque(maxlen=SPAN_LOG_SIZE)
#: process-wide counter totals (:func:`count`)
counters: Dict[str, int] = {}

_tls = threading.local()
_rids = itertools.count(1)
_count_lock = threading.Lock()


def _stack() -> list:
    try:
        return _tls.stack
    except AttributeError:
        _tls.stack = []
        return _tls.stack


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to counter ``name``, process-wide and in the innermost
    open span of this thread."""
    with _count_lock:
        counters[name] = counters.get(name, 0) + n
    stack = _stack()
    if stack:
        c = stack[-1].counts
        c[name] = c.get(name, 0) + n


class _Open:
    """An open span: the context manager :func:`span` and
    :meth:`StageTimer.time` return."""

    __slots__ = ("name", "rid", "counts", "child_s", "t0", "dur_s",
                 "_parent", "_rf", "_stage")

    def __init__(self, name: str, rid: Optional[int] = None,
                 stage: Optional["StageTimer"] = None):
        self.name, self.rid, self._stage = name, rid, stage
        self.counts: Dict[str, int] = {}
        self.child_s = 0.0

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        if self.rid is None:
            self.rid = parent.rid if parent is not None else 0
        self._parent = parent
        self._rf = None
        if _profiler_enabled():
            self._rf = torch.profiler.record_function("gps." + self.name)
            self._rf.__enter__()
        stack.append(self)
        self.t0 = perf_counter()
        return self

    def __exit__(self, et, ev, tb):
        self.dur_s = dur = perf_counter() - self.t0
        _stack().pop()
        traced = self._rf is not None
        if traced:
            self._rf.__exit__(et, ev, tb)
        parent = self._parent
        if parent is not None:
            parent.child_s += dur
        spans.append(Span(self.name, self.rid,
                          None if parent is None else parent.name, self.t0,
                          dur, dur - self.child_s, self.counts, traced))
        if self._stage is not None and et is None:
            self._stage._close(self, parent)
        return False


def span(name: str) -> _Open:
    """A span outside any Profiler stage (``with span("condition"):``);
    it inherits the enclosing span's request id, 0 where none is
    open."""
    return _Open(name)


@dataclass
class StageTimer:
    """Accumulating per-stage wall-clock timer with optional budget
    alarm (the solver-slice TIME/TIMEOUT printout, solving.c:133-138).
    Each :meth:`time` is a span named after the stage."""

    budget_s: Optional[float] = None
    total_s: float = 0.0
    calls: int = 0
    overruns: int = 0
    last_s: float = 0.0
    name: str = ""
    rid: int = 0
    parent: Optional[str] = None   # the enclosing span at the first call
    counts: Dict[str, int] = field(default_factory=dict)
    recent: deque = field(
        default_factory=lambda: deque(maxlen=STAGE_SAMPLES))

    def time(self) -> _Open:
        return _Open(self.name, self.rid, self)

    def _close(self, sp: _Open, parent: Optional[_Open]) -> None:
        dt = sp.dur_s
        self.last_s = dt
        self.total_s += dt
        self.calls += 1
        self.recent.append(dt)
        if self.calls == 1 and parent is not None:
            self.parent = parent.name
        for k, n in sp.counts.items():
            self.counts[k] = self.counts.get(k, 0) + n
        if self.budget_s is not None and dt > self.budget_s:
            self.overruns += 1

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.calls, 1)

    @property
    def p95_s(self) -> float:
        """95th percentile of the last :data:`STAGE_SAMPLES` calls."""
        if not self.recent:
            return 0.0
        return float(np.percentile(np.asarray(self.recent), 95))


class Profiler:
    """Named stage timers under one request id (fresh per Profiler)."""

    def __init__(self):
        self.rid = next(_rids)
        self.stages: Dict[str, StageTimer] = {}

    def stage(self, name: str, budget_s: Optional[float] = None) -> StageTimer:
        if name not in self.stages:
            self.stages[name] = StageTimer(budget_s=budget_s, name=name,
                                           rid=self.rid)
        return self.stages[name]

    def report(self) -> str:
        """One row a stage, each nested stage indented under its
        parent: calls, mean and p95 ms, total s, budget overruns and the
        stage's own ``readback`` / ``upload`` counts."""
        rows = [f"{'stage':<20} {'calls':>6} {'mean ms':>9} {'p95 ms':>9} "
                f"{'total s':>8} {'overruns':>8} {'readback':>8} "
                f"{'upload':>8}"]
        kids: Dict[Optional[str], list] = {}
        for name, st in self.stages.items():
            up = st.parent if st.parent in self.stages and \
                st.parent != name else None
            kids.setdefault(up, []).append(name)

        def walk(parent, depth):
            for name in sorted(kids.get(parent, ())):
                st = self.stages[name]
                label = "  " * depth + name
                rows.append(
                    f"{label:<20} {st.calls:>6} {st.mean_s * 1e3:>9.2f} "
                    f"{st.p95_s * 1e3:>9.2f} {st.total_s:>8.2f} "
                    f"{st.overruns:>8} {st.counts.get('readback', 0):>8} "
                    f"{st.counts.get('upload', 0):>8}")
                walk(name, depth + 1)

        walk(None, 0)
        return "\n".join(rows)

    @contextlib.contextmanager
    def device_trace(self, logdir: str):
        """Capture a ``torch.profiler`` trace around a block: the CPU's
        activity, and the card's where CUDA is available.  On exit the
        trace is written into ``logdir`` as a Chrome trace
        (``trace.json``)."""
        import os

        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        with profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
