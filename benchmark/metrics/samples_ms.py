"""samples_ms: the host window's crossing a cold start: the program's
spans ``samples`` (``acquire.engine.epochs_on`` taking a numpy window to
the card, ``utils.device.upload_window``), summed over each start's
spans (one request id a start) and the median taken over the starts.
Only the records with ``traced`` false are read: the window's cold
starts and the warm starts. None outside a cold-start run, where the
program keeps no span log, or where no ``samples`` span was opened (a
window handed over on the device, or a program without the span)."""

import statistics


def read(ctx):
    if not ctx.get("cold"):
        return None
    try:
        from stm32f4_sdr_gps_torch.utils.profiling import spans
    except ImportError:
        return None
    by_start = {}
    for s in spans:
        if s.name == "samples" and not s.traced:
            by_start[s.rid] = by_start.get(s.rid, 0.0) + s.dur_s
    if not by_start:
        return None
    return statistics.median(by_start.values()) * 1e3
