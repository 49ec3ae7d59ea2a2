"""coldstart_p50_ms: the median cold start of the window, the same samples as
``coldstart_p95_ms``."""

import statistics


def read(ctx):
    cold = ctx.get("cold")
    if not cold or not cold["wall_s"]:
        return None
    return statistics.median(cold["wall_s"]) * 1e3
