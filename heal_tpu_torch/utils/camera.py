"""Camera geometry (host side, numpy).

The port's copy of heal_tpu/utils/camera.py, trimmed to what the synthetic
camera path needs: the BEV grid (``gen_dx_bx``), depth discretisation and
its inverse, depth-bin targets and the depth RMSE, the synthetic rig and
its depth maps, and the host-presorted LSS splat plans. The disk-image
helpers (``load_camera_images``, ``sample_augmentation``,
``img_transform``, ``normalize_img``) wait for the disk dataset backends
and raise NotImplementedError naming their ROADMAP item.
"""
from __future__ import annotations

import numpy as np

_DISK = ("is not ported: ROADMAP queue 1, item 16 (disk dataset backends; "
         "the synthetic rig needs no image file)")


def load_camera_images(paths):
    raise NotImplementedError(f"load_camera_images {_DISK}")


def sample_augmentation(data_aug_conf: dict, is_train: bool, rng=None):
    raise NotImplementedError(f"sample_augmentation {_DISK}")


def img_transform(img, resize_dims, crop, flip, rotate):
    raise NotImplementedError(f"img_transform {_DISK}")


def normalize_img(img):
    raise NotImplementedError(f"normalize_img {_DISK}")


def gen_dx_bx(xbound, ybound, zbound):
    """-> (dx, bx, nx): cell size, first-cell center, cell counts."""
    dx = np.array([row[2] for row in (xbound, ybound, zbound)])
    bx = np.array([row[0] + row[2] / 2.0 for row in (xbound, ybound, zbound)])
    nx = np.array(
        [int(round((row[1] - row[0]) / row[2])) for row in (xbound, ybound, zbound)],
        dtype=np.int64,
    )
    return dx, bx, nx


def depth_discretization(d_min, d_max, num_bins, mode: str) -> np.ndarray:
    """Depth-bin start values. UD uniform; LID linear-increasing; SID
    log-spaced (spacing-increasing, CaDDN arXiv:2005.13423)."""
    if mode == "UD":
        size = (d_max - d_min) / num_bins
        return d_min + size * np.arange(num_bins)
    if mode == "LID":
        size = 2 * (d_max - d_min) / (num_bins * (1 + num_bins))
        return d_min + size * (np.arange(num_bins) * np.arange(1, 1 + num_bins)) / 2
    if mode == "SID":
        log_lo, log_hi = np.log(1 + d_min), np.log(1 + d_max)
        return np.exp(log_lo + (log_hi - log_lo) * np.arange(num_bins) / num_bins) - 1
    raise NotImplementedError(mode)


def indices_to_depth(indices, d_min, d_max, num_bins, mode: str):
    """Bin indices -> depth values (inverse of ``bin_depths`` bin starts)."""
    indices = np.asarray(indices, np.float64)
    if mode == "UD":
        size = (d_max - d_min) / num_bins
        return d_min + indices * size
    if mode == "LID":
        size = 2 * (d_max - d_min) / (num_bins * (1 + num_bins))
        return d_min + size * (indices * (indices + 1)) / 2
    if mode == "SID":
        log_lo, log_hi = np.log(1 + d_min), np.log(1 + d_max)
        return np.exp(log_lo + (log_hi - log_lo) * indices / num_bins) - 1
    raise NotImplementedError(mode)


def bin_depths(depth_map, mode, d_min, d_max, num_bins, target=True):
    """Depth map -> bin indices (+ validity mask when not target)."""
    with np.errstate(invalid="ignore", divide="ignore"):
        if mode == "UD":
            size = (d_max - d_min) / num_bins
            idx = (depth_map - d_min) / size
        elif mode == "LID":
            size = 2 * (d_max - d_min) / (num_bins * (1 + num_bins))
            idx = -0.5 + 0.5 * np.sqrt(1 + 8 * (depth_map - d_min) / size)
        elif mode == "SID":
            # idx = N*(log(1+d) - log(1+d_min))/(log(1+d_max) - log(1+d_min))
            # (ref camera_utils.bin_depths SID branch, :160-162)
            idx = (
                num_bins
                * (np.log1p(np.maximum(depth_map, -1.0)) - np.log1p(d_min))
                / (np.log1p(d_max) - np.log1p(d_min))
            )
        else:
            raise NotImplementedError(mode)
    finite = np.isfinite(idx)
    mask = finite & (idx >= 0) & (idx < num_bins)
    # non-finite (e.g. LID sqrt of negative below d_min) clamps to the last
    # bin, matching the reference's isfinite handling (:170-181)
    idx = np.where(finite, np.clip(idx, 0, num_bins - 1), num_bins - 1)
    if target:
        idx = np.where(mask, idx, num_bins)  # out-of-range -> ignore bin
    return np.floor(idx).astype(np.int64), mask


def depth_metric(depth_logits, gt_bins, ddiscr, mode: str):
    """Depth-estimation RMSE for the camera branch.

    Ref tools/inference_utils.py:190-198 (``depth_metric``): argmax the
    per-pixel depth-bin logits, map predicted and GT bin indices back to
    metric depth with ``indices_to_depth``, RMSE over pixels. Unlike the
    reference (whose GT indices are clamped into [0, num_bins-1] and all
    pixels counted), pixels without a lidar return — our GT convention
    marks them ``gt == num_bins`` (see bin_depths target mode) — are
    excluded: they carry no depth information.

    Returns ``(sse, n_valid)`` so callers can accumulate across frames;
    per-frame rmse = sqrt(sse / n_valid) when n_valid > 0.
    """
    d_min, d_max, n_bins = ddiscr
    logits = np.asarray(depth_logits)
    gt = np.asarray(gt_bins).reshape(-1)
    pred = np.argmax(logits.reshape(-1, logits.shape[-1]), axis=-1)
    if pred.shape != gt.shape:
        raise ValueError(f"{pred.shape[0]} depth logits for {gt.shape[0]} "
                         "target pixels")
    valid = gt < n_bins
    if not valid.any():
        return 0.0, 0
    pred_d = indices_to_depth(pred[valid], d_min, d_max, n_bins, mode)
    gt_d = indices_to_depth(gt[valid], d_min, d_max, n_bins, mode)
    return float(((pred_d - gt_d) ** 2).sum()), int(valid.sum())


def default_camera_rig(num_cams: int = 4, height: float = 1.9):
    """A simple 4-camera surround rig (synthetic data): yaw 0/90/180/270.

    Returns list of (rot 3x3 cam->agent, trans 3). Camera frame: +z
    forward (optical axis), +x right, +y down — matching the standard
    pinhole convention the intrinsics assume.
    """
    rigs = []
    for i in range(num_cams):
        yaw = np.radians(90.0 * i)
        c, s = np.cos(yaw), np.sin(yaw)
        # agent frame: x forward, y left(ish), z up. camera optical axis ->
        # agent direction (c, s, 0)
        rot = np.array(
            [
                [-s, 0.0, c],
                [c, 0.0, s],
                [0.0, -1.0, 0.0],
            ]
        )
        trans = np.array([0.0, 0.0, height])
        rigs.append((rot, trans))
    return rigs


def default_intrinsics(img_h: int, img_w: int, fov_deg: float = 100.0):
    f = img_w / (2 * np.tan(np.radians(fov_deg) / 2))
    return np.array(
        [[f, 0, img_w / 2], [0, f, img_h / 2], [0, 0, 1.0]]
    )


def render_depth_map(
    points_agent: np.ndarray,
    rot: np.ndarray,
    trans: np.ndarray,
    intrins: np.ndarray,
    img_h: int,
    img_w: int,
    downsample: int,
) -> np.ndarray:
    """Project agent-frame lidar points into a camera, keep nearest depth
    per feature-map pixel. Returns (img_h//ds, img_w//ds) with 0 = empty.

    Used for LSS depth supervision (reference renders full-res depth from
    the point cloud in the camera dataloader path).
    """
    cam_pts = (points_agent[:, :3] - trans) @ rot  # agent -> camera frame
    z = cam_pts[:, 2]
    keep = z > 0.1
    cam_pts = cam_pts[keep]
    z = z[keep]
    uv = cam_pts @ intrins.T
    u = uv[:, 0] / uv[:, 2]
    v = uv[:, 1] / uv[:, 2]
    fh, fw = img_h // downsample, img_w // downsample
    ui = np.floor(u / downsample).astype(np.int64)
    vi = np.floor(v / downsample).astype(np.int64)
    ok = (ui >= 0) & (ui < fw) & (vi >= 0) & (vi < fh)
    depth = np.full((fh, fw), np.inf)
    np.minimum.at(depth, (vi[ok], ui[ok]), z[ok])
    depth[~np.isfinite(depth)] = 0.0
    return depth.astype(np.float32)


def frustum_splat_plan(
    rots: np.ndarray,
    trans: np.ndarray,
    intrins: np.ndarray,
    post_rots: np.ndarray,
    post_trans: np.ndarray,
    depth_values: np.ndarray,
    img_h: int,
    img_w: int,
    downsample: int,
    grid_conf: dict,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side LSS splat plan: sorted (cell_ids, point_index) arrays.

    The frustum -> BEV-cell mapping depends only on calibration, which is
    known at batch-assembly time — so the splat's sort lives HERE, not on
    the device (same presort contract as the pillar path, scene.py
    ``_presort``: XLA's TPU segment ops are ~70x faster on sorted ids,
    and this removes a 147k-key device argsort per agent per frame).
    The reference's cumsum trick (camera_utils.py:209-246 analogue in
    lss_submodule QuickCumsum) is its GPU answer to the same problem.

    Returns
    -------
    ids : (Ncam*fH*fW*D,) int32 sorted BEV cell ids; out-of-range points
        hold the dump id ``ny*nx``.
    widx : (Ncam*fH*fW*D,) int32 per-agent point index in (cam, v, u, d)
        layout — ``widx // D`` is the flat pixel index into the feature
        map, ``widx`` itself indexes the flattened depth-prob volume.
    """
    rots = np.asarray(rots, np.float32)
    trans = np.asarray(trans, np.float32)
    intrins = np.asarray(intrins, np.float32)
    post_rots = np.asarray(post_rots, np.float32)
    post_trans = np.asarray(post_trans, np.float32)
    n = rots.shape[0]
    fh, fw = img_h // downsample, img_w // downsample
    d_vals = np.asarray(depth_values, np.float32)
    D = len(d_vals)

    # frustum in final-image pixels, (D, fh, fw, 3) of (u, v, depth) —
    # mirrors LiftSplatShootEncoder.frustum
    xs = np.linspace(0, fw * downsample - 1, fw, dtype=np.float32)
    ys = np.linspace(0, fh * downsample - 1, fh, dtype=np.float32)
    ds_, ys_, xs_ = np.broadcast_arrays(
        d_vals[:, None, None], ys[None, :, None], xs[None, None, :]
    )
    pts = np.stack([xs_, ys_, ds_], axis=-1)  # (D, fh, fw, 3)

    pts = pts[None] - post_trans[:, None, None, None, :]
    inv_post = np.linalg.inv(post_rots)
    pts = np.einsum("nij,ndhwj->ndhwi", inv_post, pts)
    pts = np.concatenate(
        [pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], axis=-1
    )
    combine = np.einsum("nij,njk->nik", rots, np.linalg.inv(intrins))
    pts = np.einsum("nij,ndhwj->ndhwi", combine, pts)
    pts = pts + trans[:, None, None, None, :]  # (N, D, fh, fw, 3)

    dx, bx, nx = gen_dx_bx(
        grid_conf["xbound"], grid_conf["ybound"], grid_conf["zbound"]
    )
    lo = (bx - dx / 2.0).astype(np.float32)
    xi = np.floor((pts[..., 0] - lo[0]) / np.float32(dx[0])).astype(np.int64)
    yi = np.floor((pts[..., 1] - lo[1]) / np.float32(dx[1])).astype(np.int64)
    zi = np.floor((pts[..., 2] - lo[2]) / np.float32(dx[2])).astype(np.int64)
    n_x, n_y, n_z = int(nx[0]), int(nx[1]), int(nx[2])
    ok = (
        (xi >= 0) & (xi < n_x) & (yi >= 0) & (yi < n_y)
        & (zi >= 0) & (zi < n_z)
    )
    cells = n_x * n_y
    ids = np.where(ok, yi * n_x + xi, cells)  # (N, D, fh, fw)

    # point index in (cam, v, u, d) layout
    cam = np.arange(n, dtype=np.int64)[:, None, None, None]
    d = np.arange(D, dtype=np.int64)[None, :, None, None]
    v = np.arange(fh, dtype=np.int64)[None, None, :, None]
    u = np.arange(fw, dtype=np.int64)[None, None, None, :]
    widx = np.broadcast_to(
        (((cam * fh + v) * fw + u) * D + d), ids.shape
    )

    flat_ids = ids.reshape(-1)
    order = np.argsort(flat_ids, kind="stable")
    return (
        flat_ids[order].astype(np.int32),
        widx.reshape(-1)[order].astype(np.int32),
    )


def frustum_splat_matrix_plan(
    rots, trans, intrins, post_rots, post_trans,
    depth_values, img_h, img_w, downsample, grid_conf,
    flat_plan: tuple | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Pixel-major LSS splat plan for the W-MATRIX splat form.

    The sum-pool splat factors exactly: BEV(cell, c) = sum_pix
    W[pix, cell] * F[pix, c] with W[pix, cell] = sum_d 1[cell(pix, d) =
    cell] * depth_prob[pix, d] — features are constant along a pixel's
    depth ray, so the (P, C)-row gather/scatter of the flat plan
    collapses to a SCALAR scatter building W plus one MXU matmul
    (measured 25 ms -> ~3 ms per frame at bench scale on v5e; the row
    gather was the whole cost). The reference's QuickCumsum
    (lss_submodule.py / camera_utils.py:209-246) is its GPU answer to
    the same reduction.

    Returns (both (Ncam*fH*fW, D) int32, pixel rows in (cam, v, u)
    order):
      cellmap : per-pixel BEV cell ids sorted ascending WITHIN the row
          (so flat keys pix*(ncells+1)+cell are globally sorted for the
          device's fast sorted scatter); dump id = ncells.
      dperm : the depth-bin index occupying each sorted slot (the
          device permutes depth_prob rows with it).
    """
    ids, widx = flat_plan if flat_plan is not None else frustum_splat_plan(
        rots, trans, intrins, post_rots, post_trans,
        depth_values, img_h, img_w, downsample, grid_conf,
    )
    D = len(depth_values)
    n_pix = rots.shape[0] * (img_h // downsample) * (img_w // downsample)
    # regroup the cell-sorted flat plan by pixel: the stable sort keeps
    # cells ascending within each pixel, and every pixel contributes
    # exactly D points, so a reshape lands each pixel's run on its row
    order = np.argsort(widx // D, kind="stable")
    cellmap = ids[order].reshape(n_pix, D).astype(np.int32)
    dperm = (widx[order] % D).reshape(n_pix, D).astype(np.int32)
    return cellmap, dperm
