"""launches_per_start: kernel launches a cold start in the traced
sub-window: the kernel events of the device trace (``ctx["trace"]
["kernels"]``), over the program's traced ``acquire`` spans (one a
start, ``utils.profiling``). None without a cold-start trace or where
the program keeps no span log."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "coldstart" or not tr or not tr.get("kernels"):
        return None
    try:
        from stm32f4_sdr_gps_torch.utils.profiling import spans
    except ImportError:
        return None
    starts = sum(s.traced and s.name == "acquire" for s in spans)
    if not starts:
        return None
    return sum(n for _, n in tr["kernels"].values()) / starts
