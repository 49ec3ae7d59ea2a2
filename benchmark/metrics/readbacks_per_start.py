"""readbacks_per_start: device-to-host copies a cold start: the
``readback`` counts (``utils.device.readback``) in the program's spans,
over the ``acquire`` spans (one a start). Only the records with
``traced`` false are read: the window's cold starts and the warm starts.
None outside a cold-start run or where the program keeps no span log."""


def per_start(ctx, counter):
    """``counter``'s count in the untraced spans a cold start, or None."""
    if not ctx.get("cold"):
        return None
    try:
        from stm32f4_sdr_gps_torch.utils.profiling import spans
    except ImportError:
        return None
    n = starts = 0
    for s in spans:
        if s.traced:
            continue
        n += s.counts.get(counter, 0)
        starts += s.name == "acquire"
    return n / starts if starts else None


def read(ctx):
    return per_start(ctx, "readback")
