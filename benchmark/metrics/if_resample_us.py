"""if_resample_us: the real-IF ingest kernel's device time a cold start
in the traced sub-window, µs: the trace's kernel events whose name holds
``if_resample_kernel`` (the program's ``csrc/if_resample.cu``), over the
program's traced ``acquire`` spans (one a start, ``utils.profiling``).
None without a cold-start trace, where the kernel never ran (a program
without it) or where the program keeps no span log."""

#: the kernel in the trace (a template)
NAMES = ("if_resample_kernel",)


def kernel_seconds(ctx):
    """(seconds, launches) of the kernel in the traced sub-window."""
    tr = ctx.get("trace") or {}
    s = n = 0
    for name, (sec, calls) in tr.get("kernels", {}).items():
        if any(k in name for k in NAMES):
            s += sec
            n += calls
    return s, n


def read(ctx):
    if ctx.get("kind") != "coldstart":
        return None
    s, n = kernel_seconds(ctx)
    if not n:
        return None
    try:
        from stm32f4_sdr_gps_torch.utils.profiling import spans
    except ImportError:
        return None
    starts = sum(r.traced and r.name == "acquire" for r in spans)
    return s / starts * 1e6 if starts else None
