"""h2d_ms: host-to-device copy time in the traced sub-window (the blocks' pageable
copies into the captured program's input), ms per 1000 traced epochs."""

def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr.get("epochs") or not tr.get("htod_s"):
        return None
    return tr["htod_s"] / tr["epochs"] * 1e6
