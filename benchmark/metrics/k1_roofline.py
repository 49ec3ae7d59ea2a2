"""k1_roofline: K1's share of its roofline in the traced sub-window:
the least time the card could take for the traced blocks
(``roofline.k1_bound_s`` of each block's T and C, the larger of
operations over the FP32 peak and bytes over the HBM peak), over K1's
traced time, in %.  Nothing is read where the trace's K1 launches are
not one a traced block."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "benchmark.metrics.k1_ms", os.path.join(os.path.dirname(__file__),
                                            "k1_ms.py"))
_k1 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_k1)


def read(ctx):
    s, n = _k1.k1_seconds(ctx)
    tr = ctx.get("trace") or {}
    if not n or n != tr.get("blocks") or not s:
        return None
    return 100.0 * tr["k1_bound_s"] / s
