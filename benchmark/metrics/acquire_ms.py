"""acquire_ms: the ``acquire`` stage of each cold start (``acquire/engine.py``: the
PRN x Doppler cube, peak analysis), host clock, median over the window's
cold starts."""

import statistics


def read(ctx):
    cold = ctx.get("cold")
    if not cold or not cold["acquire_s"]:
        return None
    return statistics.median(cold["acquire_s"]) * 1e3
