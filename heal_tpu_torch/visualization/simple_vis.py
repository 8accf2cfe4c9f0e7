"""BEV frame rendering (the port's copy of heal_tpu/visualization/
simple_vis.py; reference visualization/simple_vis.py:13, matplotlib
backend, imported when a frame is drawn).

Draws the ego point cloud (intensity-colored), GT boxes (green) and
predicted boxes (red) in bird's-eye view and saves a PNG. Inputs are
numpy arrays on the host.
"""
from __future__ import annotations

import os

import numpy as np


def _draw_boxes(ax, corners, color, label):
    """corners: (N, 8, 3) or (N, 4, 2+) — draws the BEV face."""
    first = True
    for box in corners:
        pts = np.asarray(box)[:4, :2]
        loop = np.concatenate([pts, pts[:1]], axis=0)
        ax.plot(
            loop[:, 0],
            loop[:, 1],
            color=color,
            linewidth=0.9,
            label=label if first else None,
        )
        first = False


def visualize(
    pred_corners,
    gt_corners,
    points,
    pc_range,
    save_path: str,
    method: str = "bev",
    left_hand: bool = False,
):
    """Render one frame. pred/gt corners (N, 8, 3); points (P, 3+)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    w = pc_range[3] - pc_range[0]
    h = pc_range[4] - pc_range[1]
    fig, ax = plt.subplots(
        figsize=(max(6.0, 12.0 * w / max(w, h)), max(3.0, 12.0 * h / max(w, h)))
    )
    if points is not None and len(points):
        pts = np.asarray(points)
        m = (
            (pts[:, 0] >= pc_range[0])
            & (pts[:, 0] <= pc_range[3])
            & (pts[:, 1] >= pc_range[1])
            & (pts[:, 1] <= pc_range[4])
        )
        pts = pts[m]
        inten = pts[:, 3] if pts.shape[1] > 3 else np.ones(len(pts))
        ax.scatter(pts[:, 0], pts[:, 1], s=0.05, c=inten, cmap="viridis")
    if gt_corners is not None and len(gt_corners):
        _draw_boxes(ax, gt_corners, "lime", "GT")
    if pred_corners is not None and len(pred_corners):
        _draw_boxes(ax, pred_corners, "red", "pred")
    ax.set_xlim(pc_range[0], pc_range[3])
    ax.set_ylim(pc_range[1], pc_range[4])
    if left_hand:
        ax.invert_yaxis()
    ax.set_aspect("equal")
    ax.set_facecolor("black")
    ax.legend(loc="upper right", fontsize=6)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return save_path
