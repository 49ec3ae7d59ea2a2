"""uploads_per_start: host-to-device copies of host data a cold start: the
``upload`` counts (``utils.device.upload``) in the program's spans, over
the ``acquire`` spans (one a start). Only the records with ``traced``
false are read: the window's cold starts and the warm starts. None
outside a cold-start run or where the program keeps no span log."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "benchmark.metrics.readbacks_per_start",
    os.path.join(os.path.dirname(__file__), "readbacks_per_start.py"))
_rb = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_rb)


def read(ctx):
    return _rb.per_start(ctx, "upload")
