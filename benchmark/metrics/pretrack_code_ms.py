"""pretrack_code_ms: the program's span ``pretrack.code`` of each cold
start (``track/pretrack.refine_code_phase``: the 20-epoch half-chip code
search, its uploads and its readback), median self time over the span
log of ``utils.profiling``. Only the records with ``traced`` false are
read: the window's cold starts and the warm starts (4 of ~1,700); the
traced sub-window's carry the profiler's cost. None outside a cold-start
run or where the program keeps no span log."""

import statistics


def read(ctx):
    if not ctx.get("cold"):
        return None
    try:
        from stm32f4_sdr_gps_torch.utils.profiling import spans
    except ImportError:
        return None
    v = [s.self_s for s in spans
         if s.name == "pretrack.code" and not s.traced]
    return statistics.median(v) * 1e3 if v else None
