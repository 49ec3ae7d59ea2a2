"""condition_host_ms: the program's span ``condition``
(``signal/capture.reference_to_baseband_device``), median duration over
the span log of ``utils.profiling``. Host time only: the words' upload
and the launches; the kernels finish inside the acquisition's first
readback (``condition_ms.coldstart`` times them to a synchronise from
outside). Only the records with ``traced`` false are read: the window's
cold starts and the warm starts (4 of ~1,700). None outside a cold-start
run or where the program keeps no span log."""

import statistics


def read(ctx):
    if not ctx.get("cold"):
        return None
    try:
        from stm32f4_sdr_gps_torch.utils.profiling import spans
    except ImportError:
        return None
    v = [s.dur_s for s in spans if s.name == "condition" and not s.traced]
    return statistics.median(v) * 1e3 if v else None
