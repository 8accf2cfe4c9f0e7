"""Device time a frame of Pyramid Fusion (``pyramid_backbone
.forward_collab``: the pyramid's stages, occupancy heads, kernel 2's
warp, ``weighted_fuse`` and the deblocks), CUDA events around the call,
mean over the window."""

SPANS = [("fusion", "pyramid_backbone", "forward_collab")]


def read(ctx):
    return (ctx.get("stages_ms") or {}).get("fusion")
