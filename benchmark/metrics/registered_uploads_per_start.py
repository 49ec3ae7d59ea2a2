"""registered_uploads_per_start: host-to-device copies a cold start made
by DMA from page-locked host memory: the ``upload.registered`` counts
(``utils.device.upload_window``: a window of a larger host buffer, its
owner registered once) in the program's spans, over the ``acquire``
spans (one a start), as ``uploads_per_start`` reads ``upload``.  None
outside a cold-start run, where the program keeps no span log, or where
it has no page-locked path (no ``upload_window``)."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "benchmark.metrics.readbacks_per_start",
    os.path.join(os.path.dirname(__file__), "readbacks_per_start.py"))
_rb = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_rb)


def read(ctx):
    try:
        from stm32f4_sdr_gps_torch.utils.device import upload_window  # noqa
    except ImportError:
        return None
    return _rb.per_start(ctx, "upload.registered")
