"""condition_ms.coldstart: the wire ingest of each cold start: uploading
its window of SPI words and conditioning them on the card
(``signal/capture.reference_to_baseband_device``), host clock ended by a
synchronise, median over the window's cold starts."""

import statistics


def read(ctx):
    cold = ctx.get("cold")
    if not cold or not any(cold.get("condition_s", ())):
        return None
    return statistics.median(cold["condition_s"]) * 1e3
