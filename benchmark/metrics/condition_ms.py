"""condition_ms: the wire ingest: uploading and conditioning the SPI words on the card
(``signal/capture.reference_to_baseband_device``), host clock around each
chunk ended by a synchronise, ms per 1000 tracked epochs of the window."""

def read(ctx):
    if not ctx.get("condition_s") or not ctx.get("tracked_epochs"):
        return None
    return ctx["condition_s"] / ctx["tracked_epochs"] * 1e6
