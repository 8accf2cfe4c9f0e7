"""Camera geometry (host side, numpy).

The port's copy of heal_tpu/utils/camera.py: the BEV grid
(``gen_dx_bx``), depth discretisation and its inverse, depth-bin targets
and the depth RMSE, the synthetic rig and its depth maps, the
host-presorted LSS splat plans, and the camera images from disk: reading
them (``load_camera_images``), the calibration of an OPV2V frame
(``get_ext_int``), the resize / crop / flip / rotate augmentation with
its pixel homography (``sample_augmentation``, ``img_transform``) and
the normalisation.
"""
from __future__ import annotations

import numpy as np

IMG_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMG_STD = np.array([0.229, 0.224, 0.225], np.float32)

# UE4 camera frame (x fwd, y right, z up) -> opencv optical frame
# (z fwd, x right, y down)
UE4_TO_OPENCV = np.array(
    [[0, 0, 1, 0], [1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 0, 1]],
    dtype=np.float64,
)


def normalize_img(img: np.ndarray) -> np.ndarray:
    """uint8/float (H, W, 3) RGB -> normalized float32 (H, W, 3)."""
    img = np.asarray(img, np.float32)
    if img.max() > 1.5:  # uint8 range
        img = img / 255.0
    return (img - IMG_MEAN) / IMG_STD


def denormalize_img(img: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(img) * IMG_STD + IMG_MEAN, 0, 1)


def get_ext_int(frame_meta: dict, camera_id: int):
    """Frame yaml camera block -> (camera_to_lidar 4x4, intrinsic 3x3).

    The camera's world cords into the lidar frame, then the UE4 -> opencv
    axis correction, so that the rotation and translation map
    optical-frame camera points into the agent (lidar) frame.
    """
    from . import transform_np

    cam = frame_meta[f"camera{camera_id}"]
    cam_coords = np.asarray(cam["cords"], dtype=np.float64)
    lidar_pose = np.asarray(
        frame_meta.get("lidar_pose_clean", frame_meta["lidar_pose"]),
        dtype=np.float64,
    )
    camera_to_lidar = transform_np.x1_to_x2(cam_coords, lidar_pose)
    camera_to_lidar = camera_to_lidar @ UE4_TO_OPENCV
    intrinsic = np.asarray(cam["intrinsic"], dtype=np.float64)
    return camera_to_lidar, intrinsic


def load_camera_images(paths):
    """PNG/JPG paths -> list of (H, W, 3) uint8 RGB arrays."""
    from PIL import Image

    out = []
    for p in paths:
        with Image.open(p) as im:
            out.append(np.asarray(im.convert("RGB")))
    return out


def sample_augmentation(data_aug_conf: dict, is_train: bool, rng=None):
    """A resize / crop / flip / rotate policy for one camera.

    Lift-Splat-Shoot's: in training the resize scale, the bottom crop and
    the flip are drawn from the conf (from OS entropy when ``rng`` is
    None, as the JAX package's); in evaluation the deterministic centre
    policy. Returns (resize, resize_dims (W, H), crop (x0, y0, x1, y1),
    flip, rotate_deg).
    """
    rng = rng or np.random.default_rng()
    H, W = data_aug_conf["H"], data_aug_conf["W"]
    fH, fW = data_aug_conf["final_dim"]
    if is_train:
        resize = float(rng.uniform(*data_aug_conf["resize_lim"]))
        new_w, new_h = int(W * resize), int(H * resize)
        crop_h = (
            int((1 - rng.uniform(*data_aug_conf["bot_pct_lim"])) * new_h)
            - fH
        )
        crop_w = int(rng.uniform(0, max(0, new_w - fW)))
        flip = bool(data_aug_conf.get("rand_flip") and rng.integers(2))
        rotate = float(rng.uniform(*data_aug_conf.get("rot_lim", (0, 0))))
    else:
        resize = max(fH / H, fW / W)
        new_w, new_h = int(W * resize), int(H * resize)
        crop_h = (
            int((1 - np.mean(data_aug_conf["bot_pct_lim"])) * new_h) - fH
        )
        crop_w = int(max(0, new_w - fW) / 2)
        flip = False
        rotate = 0.0
    crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
    return resize, (new_w, new_h), crop, flip, rotate


def _rot2(deg: float) -> np.ndarray:
    h = np.radians(deg)
    return np.array(
        [[np.cos(h), np.sin(h)], [-np.sin(h), np.cos(h)]], np.float64
    )


def img_transform(img, resize_dims, crop, flip, rotate):
    """Apply the policy to one image, tracking the pixel homography.

    img: (H, W, 3) array. Returns (transformed (fH, fW, 3) uint8 array,
    post_rot (3, 3), post_tran (3,)) such that
    ``px_final[:2] = post_rot[:2, :2] @ px_orig + post_tran[:2]``.
    """
    from PIL import Image

    pil = Image.fromarray(np.asarray(img).astype(np.uint8))
    pil = pil.resize(resize_dims)
    pil = pil.crop(crop)
    if flip:
        pil = pil.transpose(method=Image.FLIP_LEFT_RIGHT)
    if rotate:
        pil = pil.rotate(rotate)

    # the actual per-axis scale of the int-rounded resize_dims
    ih, iw = np.asarray(img).shape[:2]
    post_rot = np.diag([resize_dims[0] / iw, resize_dims[1] / ih])
    post_tran = -np.asarray(crop[:2], np.float64)
    if flip:
        A = np.array([[-1.0, 0.0], [0.0, 1.0]])
        b = np.array([crop[2] - crop[0], 0.0])
        post_rot = A @ post_rot
        post_tran = A @ post_tran + b
    A = _rot2(rotate)
    b = np.array([crop[2] - crop[0], crop[3] - crop[1]]) / 2.0
    b = A @ (-b) + b
    post_rot3 = np.eye(3)
    post_tran3 = np.zeros(3)
    post_rot3[:2, :2] = A @ post_rot
    post_tran3[:2] = A @ post_tran + b
    return np.asarray(pil), post_rot3, post_tran3


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
