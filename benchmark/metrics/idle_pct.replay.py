"""idle_pct.replay: the share of the traced sub-window (a few whole replay jobs) in which
no kernel, copy or memset ran on the card."""

def idle(ctx, kind):
    tr = ctx.get("trace")
    if ctx.get("kind") != kind or not tr or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def read(ctx):
    return idle(ctx, "replay")
