"""track_ms: the ``track`` stage of ``Receiver.process_block`` (the block's copy-in, the
replayed K1 + digest graph and the readback), host clock, ms per 1000
tracked epochs of the window."""

def read(ctx):
    st = ctx.get("stages_s", {}).get("track")
    if not st or not ctx.get("tracked_epochs"):
        return None
    return st / ctx["tracked_epochs"] * 1e6
