"""pretrack_ms: the ``pretrack`` stage of each cold start (fine Doppler and code
refinement), host clock, median over the window's cold starts."""

import statistics


def read(ctx):
    cold = ctx.get("cold")
    if not cold or not cold["pretrack_s"]:
        return None
    return statistics.median(cold["pretrack_s"]) * 1e3
