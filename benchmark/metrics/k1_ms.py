"""k1_ms: K1's device time in the traced sub-window, from the trace's
kernel events whose name holds one of ``NAMES``, ms per 1000 traced
epochs."""

#: K1's kernel in the trace (``csrc/track_scan.cu``, a template)
NAMES = ("track_scan_kernel",)


def k1_seconds(ctx):
    """(seconds, launches) of K1 in the traced sub-window."""
    tr = ctx.get("trace") or {}
    s = n = 0
    for name, (sec, calls) in tr.get("kernels", {}).items():
        if any(k in name for k in NAMES):
            s += sec
            n += calls
    return s, n


def read(ctx):
    s, n = k1_seconds(ctx)
    epochs = (ctx.get("trace") or {}).get("epochs")
    if not n or not epochs:
        return None
    return s / epochs * 1e6
