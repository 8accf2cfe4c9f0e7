"""Kernel 1's share of its roofline: the least time the PointPillars
scatter of the profiled frames needs (benchmark/work/kernels.py, each
PointPillars branch's points of each frame) over the device time of the
kernels named below in the trace. Nothing is read unless the trace
holds one launch a branch a frame."""
from benchmark.work import kernels, peaks

NAMES = ("pillar_tables_kernel",)


def read(ctx):
    red = ctx.get("trace") or {}
    runs = [d for n, _, d in red.get("kernels", ())
            if any(k in n for k in NAMES)]
    hypes = ctx.get("hypes")
    if not runs or hypes is None:
        return None
    args = hypes["model"]["args"]
    branches = [m for m in ("m1", "m2", "m3", "m4")
                if m in args and args[m].get("core_method") == "point_pillar"]
    bound = 0.0
    for batch in ctx["traced_batches"]:
        for m in branches:
            enc = args[m]["encoder_args"]
            x = batch[f"inputs_{m}"]
            pts = x["points"].reshape((-1,) + x["points"].shape[2:])
            msk = x["point_mask"].reshape((-1,) + x["point_mask"].shape[2:])
            w = kernels.pillar_work(pts, msk, enc["lidar_range"],
                                    enc["voxel_size"],
                                    enc["pillar_vfe"]["num_filters"][-1])
            bound += peaks.bound_s(w["bytes"], w["flops"])
    if len(runs) != len(ctx["traced_batches"]) * len(branches):
        return None
    return 100.0 * bound / (sum(runs) / 1e6)
