"""The camera agent type's modules, port vs JAX, on the CPU.

The same seeded numpy inputs go through heal_tpu and heal_tpu_torch:

  * the numpy camera helpers and the splat plans (utils/camera.py), the
    camera-visibility label filter and raster: exact (the same numpy
    arithmetic);
  * ``Up`` at a size that is not an exact 2x (a 5x7 map up to 9x13),
    ``CameraEncoder`` (a 144x208 image: 9x13 at /16, 5x7 at /32) and
    ``LiftSplatShootEncoder``: the sum pool against JAX's W-matrix form
    (``_splat_matrix``), the max pool against its flat-plan form, and both
    pools without a plan (the device-sort fallback): 1e-5 of 1 + max |JAX|
    (max |d| / (1 + max |ref|): f32 convolutions and segment sums in
    another order), eval mode with randomised running statistics, and
    train mode with the running statistics' update;
  * ``depth_focal_loss``: 1e-6 relative;
  * ``center_crop_or_pad`` and ``camera_fov_mask``: exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_tpu.data import synthetic as jax_synthetic
from heal_tpu.losses.point_pillar_loss import depth_focal_loss as jax_dfl
from heal_tpu.models import heter_pyramid as jax_hp
from heal_tpu.models import lift_splat_shoot as jax_lss
from heal_tpu.utils import box_np as jax_box_np
from heal_tpu.utils import camera as jax_cam
from heal_tpu_torch.data import synthetic
from heal_tpu_torch.losses.point_pillar_loss import depth_focal_loss
from heal_tpu_torch.models import heter_pyramid as hp
from heal_tpu_torch.models import lift_splat_shoot as lss
from heal_tpu_torch.utils import box_np
from heal_tpu_torch.utils import camera as cam
from heal_tpu_torch.utils.bridge import load_flax, to_flax

torch.set_num_threads(1)
GRID = {"xbound": [-24.0, 24.0, 1.5], "ybound": [-24.0, 24.0, 1.5],
        "zbound": [-10.0, 10.0, 20.0], "ddiscr": [2, 30, 8], "mode": "LID"}
IMG = (144, 208)  # 9x13 at /16, 5x7 at /32
ENC = {"grid_conf": GRID, "img_downsample": 16, "img_features": 16}


def _rel(a, b) -> float:
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / (1.0 + np.abs(b).max()))


def _random_stats(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: (rng.uniform(0.5, 1.5, s.shape) if p[-1].key == "var"
                      else rng.uniform(-0.3, 0.3, s.shape)).astype(np.float32),
        jax.device_get(tree))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rig(n_agents=2, ncam=4):
    """Calibration of the synthetic rig and the plans, per agent."""
    ih, iw = IMG
    depth = jax_cam.depth_discretization(*GRID["ddiscr"], GRID["mode"])
    rig = jax_cam.default_camera_rig(ncam)
    K = jax_cam.default_intrinsics(ih, iw)
    one = {
        "intrins": np.stack([K] * ncam).astype(np.float32),
        "rots": np.stack([r for r, _ in rig]).astype(np.float32),
        "trans": np.stack([t for _, t in rig]).astype(np.float32),
        "post_rots": np.tile(np.eye(3, dtype=np.float32), (ncam, 1, 1)),
        "post_trans": np.zeros((ncam, 3), np.float32),
    }
    plan = jax_cam.frustum_splat_plan(
        one["rots"], one["trans"], one["intrins"], one["post_rots"],
        one["post_trans"], depth, ih, iw, 16, GRID)
    mplan = jax_cam.frustum_splat_matrix_plan(
        one["rots"], one["trans"], one["intrins"], one["post_rots"],
        one["post_trans"], depth, ih, iw, 16, GRID, flat_plan=plan)
    out = {k: np.stack([v] * n_agents) for k, v in one.items()}
    for name, arr in zip(("splat_ids", "splat_widx", "splat_cell",
                          "splat_dperm"), (*plan, *mplan)):
        out[name] = np.stack([arr] * n_agents)
    return out, depth


# ---------------------------------------------------------------- host side
def test_camera_helpers_equal_heal_tpu():
    ih, iw = IMG
    for mode in ("UD", "LID", "SID"):
        d = cam.depth_discretization(2, 30, 8, mode)
        np.testing.assert_array_equal(
            d, jax_cam.depth_discretization(2, 30, 8, mode))
        idx = np.arange(8)
        np.testing.assert_array_equal(
            cam.indices_to_depth(idx, 2, 30, 8, mode),
            jax_cam.indices_to_depth(idx, 2, 30, 8, mode))
        depth = np.random.default_rng(0).uniform(-5, 40, (9, 13))
        depth[0, :3] = np.nan
        for target in (True, False):
            for got, want in zip(
                    cam.bin_depths(depth, mode, 2, 30, 8, target),
                    jax_cam.bin_depths(depth, mode, 2, 30, 8, target)):
                np.testing.assert_array_equal(got, want)
    for got, want in zip(cam.gen_dx_bx(GRID["xbound"], GRID["ybound"],
                                       GRID["zbound"]),
                         jax_cam.gen_dx_bx(GRID["xbound"], GRID["ybound"],
                                           GRID["zbound"])):
        np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(4, 9, 13, 8)).astype(np.float32)
    gt = rng.integers(0, 9, (4, 9, 13))
    assert cam.depth_metric(logits, gt, (2, 30, 8), "LID") == \
        jax_cam.depth_metric(logits, gt, (2, 30, 8), "LID")
    for (r, t), (jr, jt) in zip(cam.default_camera_rig(4),
                                jax_cam.default_camera_rig(4)):
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(t, jt)
    K = cam.default_intrinsics(ih, iw)
    np.testing.assert_array_equal(K, jax_cam.default_intrinsics(ih, iw))
    pts = rng.uniform(-30, 30, (5000, 4)).astype(np.float32)
    rot, tr = cam.default_camera_rig(4)[1]
    np.testing.assert_array_equal(
        cam.render_depth_map(pts, rot, tr, K, ih, iw, 16),
        jax_cam.render_depth_map(pts, rot, tr, K, ih, iw, 16))


def test_splat_plans_equal_heal_tpu():
    want, depth = _rig(n_agents=1)
    ih, iw = IMG
    calib = [want[k][0] for k in ("rots", "trans", "intrins", "post_rots",
                                  "post_trans")]
    plan = cam.frustum_splat_plan(*calib, depth, ih, iw, 16, GRID)
    mplan = cam.frustum_splat_matrix_plan(*calib, depth, ih, iw, 16, GRID)
    for name, got in zip(("splat_ids", "splat_widx", "splat_cell",
                          "splat_dperm"), (*plan, *mplan)):
        assert got.dtype == want[name].dtype, name
        np.testing.assert_array_equal(got, want[name][0], err_msg=name)
    cells = 32 * 32
    assert 0 < (plan[0] < cells).sum() < len(plan[0])  # some land, some not


def test_camera_labels_equal_heal_tpu():
    rng = np.random.default_rng(2)
    objects = np.zeros((12, 7))
    objects[:, :2] = rng.uniform(-45, 45, (12, 2))
    objects[:, 3:6] = (4.0, 1.8, 1.5)
    pose = [3.0, -2.0, 1.9, 0.0, 30.0, 0.0]
    vis = synthetic.bev_visibility_map(objects, pose)
    np.testing.assert_array_equal(
        vis, jax_synthetic.bev_visibility_map(objects, pose))
    boxes = rng.uniform(-50, 50, (30, 7))
    got = box_np.camera_visible_mask(boxes, vis)
    np.testing.assert_array_equal(
        got, jax_box_np.camera_visible_mask(boxes, vis))
    assert (vis > 0).sum() > 25  # objects seen beside the rig's own cells


def test_disk_image_helpers_name_their_item():
    for fn, args in ((cam.load_camera_images, ([],)),
                     (cam.sample_augmentation, ({}, True)),
                     (cam.img_transform, (None, (1, 1), (0, 0, 1, 1), False,
                                          0.0)),
                     (cam.normalize_img, (np.zeros((2, 2, 3)),))):
        with pytest.raises(NotImplementedError, match="item 16"):
            fn(*args)


# ------------------------------------------------------------------ modules
def _bridged(jm, port, inputs, seed, **kw):
    """A JAX init (running statistics randomised) loaded into ``port``."""
    v = jax.device_get(jm.init(jax.random.PRNGKey(seed), *inputs, **kw))
    stats = _random_stats(v["batch_stats"], seed)
    load_flax(port, v["params"], stats).eval()
    return {"params": v["params"], "batch_stats": stats}


def _nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_up_matches_jax_at_a_non_2x_size(train):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 7, 12)).astype(np.float32)
    skip = rng.normal(size=(2, 9, 13, 6)).astype(np.float32)
    jm = jax_lss.Up(features=10)
    port = lss.Up(18, 10)
    variables = _bridged(jm, port, (x, skip), 0)
    if train:
        want, upd = jm.apply(variables, x, skip, True,
                             mutable=["batch_stats"])
        port.train()
    else:
        want = jm.apply(variables, x, skip, False)
    got = port(_nchw(x), _nchw(skip)).permute(0, 2, 3, 1)
    assert tuple(got.shape) == (2, 9, 13, 10)
    assert _rel(got.detach().numpy(), want) <= 1e-5
    if train:
        got_s = _leaves(to_flax(port.state_dict())[1])
        for k, v in _leaves(upd["batch_stats"]).items():
            assert _rel(got_s[k], v) <= 1e-5, k


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_camera_encoder_matches_jax(train):
    imgs = np.random.default_rng(4).normal(
        0.45, 0.2, (2,) + IMG + (3,)).astype(np.float32)
    jm = jax_lss.CameraEncoder(depth_bins=8, features=16)
    port = lss.CameraEncoder(8, 16)
    variables = _bridged(jm, port, (imgs,), 1)
    if train:
        (want_d, want_f), upd = jm.apply(variables, imgs, True,
                                         mutable=["batch_stats"])
        port.train()
    else:
        want_d, want_f = jm.apply(variables, imgs, False)
    got_d, got_f = (t.permute(0, 2, 3, 1).detach().numpy()
                    for t in port(_nchw(imgs)))
    assert got_d.shape == (2, 9, 13, 8) and got_f.shape == (2, 9, 13, 16)
    assert _rel(got_d, want_d) <= 1e-5 and _rel(got_f, want_f) <= 1e-5
    if train:
        got_s = _leaves(to_flax(port.state_dict())[1])
        want_s = _leaves(upd["batch_stats"])
        assert got_s.keys() == want_s.keys() and len(got_s) == 2 * 11
        for k, v in want_s.items():
            assert _rel(got_s[k], v) <= 1e-5, k


@pytest.mark.parametrize("plan", [True, False], ids=["plan", "no_plan"])
@pytest.mark.parametrize("pool", ["sum", "max"])
def test_lss_encoder_matches_jax(pool, plan):
    """The BEV and depth logits: sum + plan is JAX's W-matrix splat (the
    port reduces the flat plan), max + plan its flat-plan splat, no plan
    its device-sort fallback."""
    calib, _ = _rig()
    inputs = dict(calib, imgs=np.random.default_rng(5).normal(
        0.45, 0.2, (2, 4) + IMG + (3,)).astype(np.float32))
    if not plan:
        inputs = {k: v for k, v in inputs.items()
                  if not k.startswith("splat_")}
    args = dict(ENC, pool=pool)
    jm = jax_lss.LiftSplatShootEncoder(args=args)
    port = lss.LiftSplatShootEncoder(args)
    variables = _bridged(jm, port, (inputs,), 2)
    want_bev, want_d = jm.apply(variables, inputs, False)
    with torch.no_grad():
        got_bev, got_d = port({k: torch.from_numpy(v)
                               for k, v in inputs.items()})
    assert tuple(got_bev.shape) == (2, 32, 32, 16)
    assert tuple(got_d.shape) == (8, 9, 13, 8)
    assert float(np.abs(np.asarray(want_bev)).max()) > 0
    assert _rel(got_bev.numpy(), want_bev) <= 1e-5
    assert _rel(got_d.numpy(), want_d) <= 1e-5


def test_depth_focal_loss_matches_jax():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(6, 9, 13, 8)).astype(np.float32) * 3
    gt = rng.integers(0, 9, (6, 9, 13)).astype(np.int32)  # 8: no return
    want = float(jax_dfl(jnp.asarray(logits), jnp.asarray(gt)))
    got = depth_focal_loss(torch.from_numpy(logits),
                           torch.from_numpy(gt)).item()
    assert got == pytest.approx(want, rel=1e-6)
    none = np.full_like(gt, 8)
    assert depth_focal_loss(torch.from_numpy(logits),
                            torch.from_numpy(none)).item() == 0.0


@pytest.mark.parametrize("th,tw", [(5, 12), (9, 6), (7, 10), (10, 11),
                                   (4, 3)])
def test_center_crop_or_pad_equals_heal_tpu(th, tw):
    feat = np.random.default_rng(7).normal(size=(2, 7, 10, 3)).astype(
        np.float32)
    want = np.asarray(jax_hp.center_crop_or_pad(jnp.asarray(feat), th, tw))
    got = hp.center_crop_or_pad(torch.from_numpy(feat), th, tw).numpy()
    assert got.shape == want.shape == (2, th, tw, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,rh,rw", [(64, 128, 1.0, 2.0), (32, 64, 1, 2),
                                       (33, 17, 1.3, 1.7), (16, 16, 1, 1)])
def test_camera_fov_mask_equals_heal_tpu(h, w, rh, rw):
    np.testing.assert_array_equal(
        hp.camera_fov_mask(h, w, rh, rw).numpy(),
        np.asarray(jax_hp.camera_fov_mask(h, w, rh, rw)))
