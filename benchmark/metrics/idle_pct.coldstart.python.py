"""idle_pct.coldstart.python: the share of the traced sub-window (a run
of cold starts) in which the card is idle while the program's own
Python is the innermost host activity: the idle gaps of the device trace
labelled with one of the program's spans (``gps.`` + the span's name,
``utils.profiling``) and no torch operation inside it.  None without a
trace or where the program keeps no span log."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "coldstart" or not tr or not tr.get("window_s"):
        return None
    try:
        from stm32f4_sdr_gps_torch.utils.profiling import spans  # noqa: F401
    except ImportError:
        return None
    gps = sum(s for label, s in tr["idle_gaps"] if label.startswith("gps."))
    return 100.0 * gps / tr["window_s"]
