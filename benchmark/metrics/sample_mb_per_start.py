"""sample_mb_per_start: the bytes of the host window that cross to the
card a cold start, in MB (1e6 bytes): the ``samples.bytes`` counts
(``acquire.engine.epochs_on``'s numpy branch) in the program's spans,
over the ``acquire`` spans (one a start), as ``uploads_per_start`` reads
``upload``. None outside a cold-start run, where the program keeps no
span log, or where no span counted ``samples.bytes`` (a window handed
over on the device, or a program without the counter)."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "benchmark.metrics.readbacks_per_start",
    os.path.join(os.path.dirname(__file__), "readbacks_per_start.py"))
_rb = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_rb)


def read(ctx):
    try:
        from stm32f4_sdr_gps_torch.utils.profiling import spans
    except ImportError:
        return None
    if not any("samples.bytes" in s.counts for s in spans if not s.traced):
        return None
    v = _rb.per_start(ctx, "samples.bytes")
    return None if v is None else v / 1e6
