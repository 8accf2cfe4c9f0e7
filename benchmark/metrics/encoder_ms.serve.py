"""Device time a frame of every agent type's encoder (``branch_*
.encoder``: PointPillars with kernel 1, SECOND, Lift-Splat-Shoot),
CUDA events in hooks around their calls, mean over the window."""

SPANS = [("encoder", "branch_*.encoder", "__call__")]


def read(ctx):
    return (ctx.get("stages_ms") or {}).get("encoder")
