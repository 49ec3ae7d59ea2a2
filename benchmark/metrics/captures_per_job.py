"""captures_per_job: CUDA graphs captured in the window (``utils.graphs.stats["captures"]``)
per job started in it."""

def read(ctx):
    if not ctx.get("jobs_started"):
        return None
    return ctx["captures"] / ctx["jobs_started"]
