"""if_resample_roofline: the real-IF ingest kernel's share of its
roofline in the traced sub-window, %: the least time the card could take
for the traced windows (``if_resample_work.if_resample_bound_s`` of each
window's int8 samples, the bytes the program's traced ``condition``
spans count under ``condition.bytes``) over the kernel's traced time.
Nothing is read where the kernel never ran, where its launches are not
one a traced window, or where the program counts no bytes."""

import importlib.util
import os

from benchmark.if_resample_work import if_resample_bound_s

_spec = importlib.util.spec_from_file_location(
    "benchmark.metrics.if_resample_us",
    os.path.join(os.path.dirname(__file__), "if_resample_us.py"))
_us = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_us)


def read(ctx):
    if ctx.get("kind") != "coldstart":
        return None
    s, n = _us.kernel_seconds(ctx)
    if not n or not s:
        return None
    try:
        from stm32f4_sdr_gps_torch.utils.profiling import spans
    except ImportError:
        return None
    windows = [r.counts.get("condition.bytes", 0) for r in spans
               if r.traced and r.name == "condition"]
    if len(windows) != n or not all(windows):
        return None
    return 100.0 * sum(if_resample_bound_s(b) for b in windows) / s
