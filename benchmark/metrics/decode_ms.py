"""decode_ms: the ``decode`` stage (``Receiver._consume_digest``: the framers, the
ephemerides and the fixes of ``nav/`` and ``pvt/``), host clock, ms per
1000 tracked epochs of the window."""

def read(ctx):
    st = ctx.get("stages_s", {}).get("decode")
    if not st or not ctx.get("tracked_epochs"):
        return None
    return st / ctx["tracked_epochs"] * 1e6
