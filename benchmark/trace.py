"""The device trace of a sub-window: ``torch.profiler`` (CUPTI) around a
few steps, exported as a Chrome trace into the run's temporary
directory, read and deleted.

From it: the seconds in which a kernel, copy or memset ran on the card
(the union of their intervals), the window's length, device time by
operation name, host-to-device copy time, and the longest idle gaps of
the card labelled by the host operation running in each.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    def __init__(self):
        self.summary = None

    def __enter__(self):
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.summary = summarize(events)
        return False


def _union(intervals: list) -> tuple:
    """(covered seconds, gaps [(start, end)]) of (start, end) in us."""
    covered, gaps, end = 0.0, [], None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            covered += b - a
            end = b
        elif b > end:
            covered += b - end
            end = b
    return covered * 1e-6, gaps


def summarize(events: list) -> dict:
    dev, host = [], []
    by_name = defaultdict(float)
    kernels = defaultdict(lambda: [0.0, 0])
    htod = 0.0
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, d = float(e["ts"]), float(e["dur"])
        cat = e.get("cat", "")
        if cat in _DEVICE_CATS:
            dev.append((a, a + d))
            by_name[e["name"]] += d * 1e-6
            if cat == "kernel":
                kernels[e["name"]][0] += d * 1e-6
                kernels[e["name"]][1] += 1
            if cat == "gpu_memcpy" and "HtoD" in e["name"]:
                htod += d * 1e-6
        elif cat in ("cpu_op", "python_function", "user_annotation"):
            host.append((a, a + d, e["name"]))
    if not dev:
        return dict(busy_s=0.0, window_s=0.0, device_ops={}, kernels={},
                    htod_s=0.0, idle_gaps=[])
    busy, gaps = _union(dev)
    t0 = min(min(a for a, _ in dev), min((h[0] for h in host), default=1e30))
    t1 = max(max(b for _, b in dev), max((h[1] for h in host), default=0))
    gaps = [(t0, min(a for a, _ in dev))] + gaps + [(max(b for _, b in dev),
                                                    t1)]
    by_host = defaultdict(float)
    host.sort()
    stack, i = [], 0
    for a, b in sorted(g for g in gaps if g[1] > g[0]):
        mid = 0.5 * (a + b)
        # sweep the host operations in start order, keeping those open
        # (nested) at the gap's middle; the innermost is on top
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "host (no operation)"
        by_host[name] += (b - a) * 1e-6
    return dict(busy_s=busy, window_s=(t1 - t0) * 1e-6,
                device_ops=dict(by_name),
                kernels={k: tuple(v) for k, v in kernels.items()},
                htod_s=htod, idle_gaps=sorted(by_host.items(),
                                              key=lambda kv: -kv[1]))
