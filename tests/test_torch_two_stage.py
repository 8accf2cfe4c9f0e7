"""FPV-RCNN, the two-stage detector, port vs JAX, on the CPU: the
PointNet++ operators, the matcher, the RoI head, the stage-2 decode, the
loss, one train step and serving.

tests/configs/tiny_intermediate.yaml with ``fusion.core_method:
intermediate2stage`` and the model switched to ``fpvrcnn`` in code
(``fpv_cfg``), at the widths of JAX's tests/test_two_stage.py: SECOND at
0.6 x 0.6 x 0.5 m, channels 8 / 16 / 16 / 16, SSFA 32, 2000 points an
agent, anchors at stride 8 (16 x 16); stage 2 with 8 proposals an agent,
128 keypoints, a 3^3 RoI grid; the loss ``fpvrcnn_loss`` (stage 1 with
its IoU term). One numpy batch of heal_tpu's host side goes to both
packages, one set of flax variables (the port's seeded init, running
statistics randomised) is bridged strictly. Stated tolerances, as
max |d| / (1 + max |JAX|) unless said otherwise:

  * integer outputs exact: FPS's and the ball query's indices (padded
    points, fewer valid points than samples, duplicated points for
    ties), the matcher's leaders and kept RoIs, the stage-2 decode's
    kept set and order;
  * ``group_and_pool``, ``transform_boxes``, the matcher's fused boxes,
    the stage-2 decode's boxes and scores: 1e-5;
  * eval outputs (the stage-1 heads, ``boxes_fused``, ``scores_fused``,
    ``rcnn_cls``, ``rcnn_reg``): 1e-4;
  * ``fpvrcnn_loss``: 1e-6 relative;
  * one train step against JAX's f64 step: loss terms 1e-5 relative,
    every gradient leaf of the port's f64 step within 1e-5 and of its
    f32 step within 1e-4;
  * serving (``run_inference``): each frame's kept detections (through
    ``decode_stage2``) against heal_tpu's ``decode_stage2`` of its model's
    outputs, scores 1e-5 and corners 1e-4 absolute.

Jitted on the CPU, heal_tpu's ``rotated_iou_matrix`` gives identical
boxes an IoU of 3, 1/3 or 0 instead of 1 (the clipper's collinear
edges, fused by XLA), and the matcher reads each leader's own IoU, so
JAX's jitted FPV-RCNN fuses far-apart proposals (ROADMAP §3). Eagerly,
JAX computes 1, as the port does (``test_jax_jit_self_iou_fault_is_
pinned``). Running the whole model eagerly is minutes, so the matcher
of heal_tpu.models.fpvrcnn reads here the IoU matrix with its diagonal
set to 1, its eager value (``_jax_matcher_self_iou``); nothing else of
JAX changes.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heal_tpu.native
from heal_tpu.data import build_dataset as jax_build_dataset
from heal_tpu.losses import build_loss as build_jax_loss
from heal_tpu.models import build_model as build_flax
from heal_tpu.models import fpvrcnn as jax_fpv
from heal_tpu.ops import pointnet as jax_pointnet
from heal_tpu.parallel import Trainer as JaxTrainer
from heal_tpu.postprocess.decode import decode_stage2 as jax_decode_stage2
from heal_tpu_torch.models import build_loss
from heal_tpu_torch.models import fpvrcnn
from heal_tpu_torch.ops import pointnet
from heal_tpu_torch.postprocess import decode
from heal_tpu_torch.postprocess.decode import decode_stage2
from heal_tpu_torch.tools.inference import run_inference
from heal_tpu_torch.utils import eval_np
from test_torch_legacy_models import (SECOND_ARGS, STAGE1_LOSS,
                                      assert_bridges_strictly,
                                      assert_outputs_match, legacy_cfg,
                                      port_model, port_variables)
from test_torch_legacy_models import _port_step
from test_torch_point_pillar import _model_batch
from test_torch_train import _jax_f64_step, _leaves, _rel

torch.set_num_threads(1)
STAGE2 = ("boxes_fused", "scores_fused", "valid_fused", "rcnn_cls",
          "rcnn_reg")


@pytest.fixture(autouse=True)
def _numpy_host(monkeypatch):
    # heal_tpu on its numpy host path, built library or not
    monkeypatch.setattr(heal_tpu.native, "load", lambda: None)


@pytest.fixture(autouse=True)
def _jax_matcher_self_iou(monkeypatch):
    """The matcher's IoU matrix (of the proposals with themselves) with
    the diagonal at 1, its eager value (module docstring)."""
    real = jax_fpv.rotated_iou_matrix

    def iou(a, b, xp=None):
        m = real(a, b, xp=xp)
        return jnp.where(jnp.eye(m.shape[0], dtype=bool), 1.0, m)

    monkeypatch.setattr(jax_fpv, "rotated_iou_matrix", iou)


def fpv_cfg() -> dict:
    cfg = legacy_cfg("ciassd")
    cfg["fusion"]["core_method"] = "intermediate2stage"
    cfg["preprocess"]["args"]["max_points"] = 2000
    a = cfg["model"]["args"]
    cfg["model"]["core_method"] = "fpvrcnn"
    a.update(copy.deepcopy(SECOND_ARGS))
    a["anchor_args"] = copy.deepcopy(cfg["postprocess"]["anchor_args"])
    a["stage2"] = {"proposals_per_agent": 8, "num_keypoints": 128,
                   "grid_size": 3}
    cfg["loss"] = {"core_method": "fpvrcnn_loss",
                   "args": {"stage1": copy.deepcopy(STAGE1_LOSS),
                            "stage2": {"cls_weight": 1.0,
                                       "reg_weight": 1.0}}}
    return cfg


def _jax_outputs(cfg, params, stats, batch, keys=None):
    """JAX's eval outputs, jitted."""
    jm = build_flax(cfg["model"])
    return jax.device_get(jax.jit(lambda v, b: {
        k: x for k, x in jm.apply(v, b, train=False).items()
        if keys is None or k in keys})(
            {"params": params, "batch_stats": stats},
            jax.tree.map(jnp.asarray, batch)))


def _batch(cfg, train=False, size=1):
    np.random.seed(0)
    return next(jax_build_dataset(cfg, train=train).batches(
        size, shuffle=False, process_split=False))


def _points(seed, b=3, n=300, valid=(300, 40, 5)):
    """(b, n, 4) points with padding rows, a duplicated point (ties) and
    a row with fewer valid points than the samples asked."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-10, 10, (b, n, 4)).astype(np.float32)
    pts[:, 7] = pts[:, 3]  # a duplicate
    mask = np.zeros((b, n), bool)
    for i, v in enumerate(valid):
        mask[i, :v] = True
        pts[i, v:] = 777.0
    return pts, mask


def test_farthest_point_sample_matches_jax():
    pts, mask = _points(0)
    want = np.stack([np.asarray(jax_pointnet.farthest_point_sample(
        jnp.asarray(p[:, :3]), jnp.asarray(m), 32)) for p, m in
        zip(pts, mask)])
    got = pointnet.farthest_point_sample(torch.from_numpy(pts[..., :3]),
                                         torch.from_numpy(mask), 32)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert (want[0] < 300).all() and len(set(want[0])) == 32
    assert set(want[2]) <= set(range(5))  # 5 valid points: repeats


def test_ball_query_and_group_and_pool_match_jax():
    pts, mask = _points(1)
    rng = np.random.RandomState(2)
    queries = rng.uniform(-10, 10, (3, 70, 3)).astype(np.float32)
    queries[:, 0] = pts[:, 3, :3]  # on the duplicated point
    w = rng.randn(4, 16).astype(np.float32)
    jidx, jvalid, jpool = [], [], []
    for q, p, m in zip(queries, pts, mask):
        i, v = jax_pointnet.ball_query(jnp.asarray(q), jnp.asarray(p[:, :3]),
                                       jnp.asarray(m), 2.5, 8, chunk=32)
        jidx.append(np.asarray(i))
        jvalid.append(np.asarray(v))
        jpool.append(np.asarray(jax_pointnet.group_and_pool(
            jnp.asarray(q), jnp.asarray(p[:, :3]), jnp.asarray(p[:, 3:]),
            i, v, lambda x: jax.nn.relu(x @ jnp.asarray(w)))))
    tq, tp = torch.from_numpy(queries), torch.from_numpy(pts)
    idx, valid = pointnet.ball_query(tq, tp[..., :3], torch.from_numpy(mask),
                                     2.5, 8, chunk=32)
    assert np.array_equal(idx.numpy(), np.stack(jidx))
    assert np.array_equal(valid.numpy(), np.stack(jvalid))
    assert 0 < valid.sum() < valid.numel()
    pooled = pointnet.group_and_pool(
        tq, tp[..., :3], tp[..., 3:], idx, valid,
        lambda x: torch.relu(x @ torch.from_numpy(w)))
    assert _rel(pooled.numpy(), np.stack(jpool)) <= 1e-5


def test_matcher_and_transform_match_jax():
    """Two agents' proposals, one box seen by both with jitter and one
    with its yaw turned by pi, moved to the ego frame and fused."""
    rng = np.random.RandomState(3)
    boxes = np.zeros((16, 7), np.float32)
    boxes[:, :2] = rng.uniform(-30, 30, (16, 2))
    boxes[:, 2] = rng.uniform(-1.5, -0.5, 16)
    boxes[:, 3:6] = [1.5, 1.6, 3.9]
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, 16)
    boxes[8] = boxes[0] + [0.3, -0.2, 0, 0, 0, 0, 0.05]
    boxes[9] = boxes[1] + [0.1, 0.1, 0, 0, 0, 0, np.pi]
    scores = rng.uniform(0, 1, 16).astype(np.float32)
    scores[12:] = 0
    valid = scores > 0.1
    tfm = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.3), np.sin(0.3)
    tfm[:2, :2] = [[c, -s], [s, c]]
    tfm[:3, 3] = [5.0, -2.0, 0.1]
    want_t = np.asarray(jax_fpv.transform_boxes(jnp.asarray(boxes),
                                                jnp.asarray(tfm)))
    got_t = fpvrcnn.transform_boxes(torch.from_numpy(boxes)[None],
                                    torch.from_numpy(tfm)[None])[0]
    assert _rel(got_t.numpy(), want_t) <= 1e-5
    want = [np.asarray(x) for x in jax_fpv.fuse_proposals(
        jnp.asarray(want_t), jnp.asarray(scores), jnp.asarray(valid))]
    got = [x.numpy() for x in fpvrcnn.fuse_proposals(
        torch.from_numpy(want_t), torch.from_numpy(scores),
        torch.from_numpy(valid))]
    assert np.array_equal(got[2], want[2])
    assert 0 < want[2].sum() < valid.sum()  # clusters merged
    assert _rel(got[0], want[0]) <= 1e-5
    assert _rel(got[1], want[1]) <= 1e-5


def test_decode_stage2_matches_jax():
    rng = np.random.RandomState(4)
    r = 24
    rois = np.column_stack([
        rng.uniform(-30, 30, (r, 2)), rng.uniform(-1.5, -0.5, (r, 1)),
        rng.uniform(1.3, 1.8, (r, 1)), rng.uniform(1.4, 1.9, (r, 1)),
        rng.uniform(3.5, 4.5, (r, 1)), rng.uniform(-1, 1, (r, 1)),
    ]).astype(np.float32)
    rois[5] = rois[4] + 0.05  # overlapping: one suppressed
    reg = (rng.randn(r, 7) * 0.1).astype(np.float32)
    cls = rng.randn(r).astype(np.float32) * 2
    valid = rng.uniform(0, 1, r) > 0.2
    rng_box = np.array([-38.4, -38.4, -3, 38.4, 38.4, 1], np.float32)
    want = jax.device_get(jax_decode_stage2(
        jnp.asarray(rois), jnp.asarray(valid), jnp.asarray(cls),
        jnp.asarray(reg), jnp.asarray(rng_box)))
    got = decode_stage2(torch.from_numpy(rois), torch.from_numpy(valid),
                        torch.from_numpy(cls), torch.from_numpy(reg),
                        torch.from_numpy(rng_box))
    assert np.array_equal(got["valid"].numpy(), want["valid"])
    assert 0 < want["valid"].sum() < valid.sum()
    for k in ("scores", "boxes", "corners"):
        assert _rel(got[k].numpy(), want[k]) <= 1e-5, k


def test_fpvrcnn_outputs_and_loss_match_jax():
    """Eval outputs of one frame (two agents and a padded slot), the
    variables bridged strictly, then ``fpvrcnn_loss`` on JAX's outputs
    against the frame's labels (both stages)."""
    cfg = fpv_cfg()
    batch = _batch(cfg)
    assert "pos_equal_one_single" in batch  # the two-stage contract
    top = assert_bridges_strictly(cfg, batch)
    assert {"kp_encoder", "roi_head", "ssfa", "input_proj", "heads",
            "encoder"} == set(top)
    params, stats = port_variables(cfg, seed=0)
    keys = ("cls_preds", "reg_preds", "dir_preds", "iou_preds",
            "spatial_features_2d") + STAGE2
    want = _jax_outputs(cfg, params, stats, batch, keys)
    with torch.no_grad():
        got = port_model(cfg, params, stats)(_model_batch(batch))
    valid = want.pop("valid_fused")
    assert np.array_equal(got["valid_fused"].numpy(), valid)
    assert valid.sum() > 0
    assert want["rcnn_reg"].shape == (1, 24, 7)
    assert got["cls_preds_single"] is not None
    assert_outputs_match(got, want)

    anchors = jax_build_dataset(cfg, train=False).anchors
    tgt = {k: batch[k] for k in ("pos_equal_one", "neg_equal_one",
                                 "targets", "pos_equal_one_single",
                                 "neg_equal_one_single", "targets_single",
                                 "gt_boxes", "gt_mask")}
    out = dict(want, valid_fused=valid)
    out.update({f"{k}_single": want[k] for k in ("cls_preds", "reg_preds",
                                                 "dir_preds", "iou_preds")})
    jcrit, crit = build_jax_loss(cfg["loss"]), build_loss(cfg["loss"])
    jcrit.set_anchors(anchors)
    crit.set_anchors(anchors)
    want_total, want_aux = jcrit(jax.tree.map(jnp.asarray, out),
                                 jax.tree.map(jnp.asarray, tgt))
    total, aux = crit({k: torch.from_numpy(np.asarray(v))
                       for k, v in out.items()},
                      {k: torch.from_numpy(v) for k, v in tgt.items()})
    assert sorted(aux) == sorted(want_aux)
    assert float(want_aux["rcnn_cls_loss"]) > 0
    for k, v in want_aux.items():
        np.testing.assert_allclose(aux[k].item(), float(v), rtol=1e-6,
                                   err_msg=k)


def test_train_step_matches_jax_f64():
    """One step at batch 2: stage 1 through its per-agent labels, stage
    2 through the keypoint features only (the proposals carry no
    gradient, as JAX's ``stop_gradient``)."""
    cfg = fpv_cfg()
    batch = _batch(cfg, train=True, size=2)
    params, stats = port_variables(cfg, seed=1)
    anchors = jax_build_dataset(cfg, train=False).anchors
    jcrit, crit = build_jax_loss(cfg["loss"]), build_loss(cfg["loss"])
    jcrit.set_anchors(anchors)
    crit.set_anchors(anchors)
    jt = JaxTrainer(model=build_flax(cfg["model"]), criterion=jcrit, tx=None)
    want_aux, _, grads = _jax_f64_step(jt, params, stats, batch)
    want = _leaves(grads)
    assert float(want_aux["rcnn_cls_loss"]) > 0
    for dtype, tol in ((torch.float64, 1e-5), (torch.float32, 1e-4)):
        aux, got = _port_step(cfg, params, stats, crit, batch, dtype)
        assert sorted(aux) == sorted(want_aux)
        for k, w in want_aux.items():
            np.testing.assert_allclose(aux[k].item(), w, rtol=1e-5,
                                       err_msg=(dtype, k))
        assert got.keys() == want.keys()
        errs = {k: _rel(g, want[k]) for k, g in got.items()}
        assert max(errs.values()) <= tol, (dtype, max(errs.items(),
                                                      key=lambda x: x[1]))


def test_run_inference_serves_the_refined_detections(monkeypatch):
    """Two test frames served by ``run_inference`` (the RoI quality bias
    raised so that RoIs pass the threshold): each frame's kept
    detections are ``decode_stage2`` of the model's outputs, equal to
    heal_tpu's decode of its own outputs of that frame."""
    cfg = fpv_cfg()
    params, stats = port_variables(cfg, seed=2)
    params["roi_head"]["cls"]["bias"][:] = 2.0
    seen = []
    real = eval_np.calculate_tp_fp

    def spy(corners, scores, gt, stat, thr):
        if thr == 0.3:
            seen.append((np.asarray(corners), np.asarray(scores)))
        return real(corners, scores, gt, stat, thr)

    monkeypatch.setattr(eval_np, "calculate_tp_fp", spy)
    calls = []
    real_decode = decode.decode_stage2

    def decode_spy(*a, **k):
        calls.append(1)
        return real_decode(*a, **k)

    monkeypatch.setattr("heal_tpu_torch.tools.inference.decode_stage2",
                        decode_spy)
    got = run_inference(cfg=cfg, model=port_model(cfg, params, stats),
                        device="cpu", max_batches=2)
    assert got["frames"] == 2 and len(calls) == 2
    np.random.seed(0)
    frames = jax_build_dataset(cfg, train=False).batches(
        1, shuffle=False, process_split=False)
    post = cfg["postprocess"]
    for (tc, ts), batch in zip(seen, frames):
        out = _jax_outputs(cfg, params, stats, batch, STAGE2)
        det = jax.device_get(jax_decode_stage2(
            out["boxes_fused"][0], out["valid_fused"][0],
            out["rcnn_cls"][0], out["rcnn_reg"][0],
            jnp.asarray(post["gt_range"], jnp.float32),
            score_threshold=post["target_args"]["score_threshold"],
            nms_threshold=post["nms_thresh"]))
        keep = det["valid"]
        order = np.argsort(-det["scores"][keep], kind="stable")
        js, jc = det["scores"][keep][order], det["corners"][keep][order]
        assert 0 < len(js) == len(ts)
        np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)
        np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-4)


def test_jax_jit_self_iou_fault_is_pinned():
    """heal_tpu's rotated IoU of a box with itself: 1 eagerly, not 1
    under ``jax.jit`` on the CPU (the fault the tests above step around);
    the port's is 1."""
    from heal_tpu.utils.rotated_iou import box2d_to_corners as jax_corners
    from heal_tpu.utils.rotated_iou import rotated_iou_matrix as jax_iou
    from heal_tpu_torch.utils.rotated_iou import (box2d_to_corners,
                                                  rotated_iou_matrix)

    cfg = fpv_cfg()
    params, stats = port_variables(cfg, seed=0)
    boxes = _jax_outputs(cfg, params, stats, _batch(cfg),
                         ("boxes_fused",))["boxes_fused"][0][:16]

    def self_iou(b):
        c = jax_corners(b[:, jnp.array([0, 1, 5, 4, 6])], xp=jnp)
        return jnp.diag(jax_iou(c, c, xp=jnp))

    eager = np.asarray(self_iou(jnp.asarray(boxes)))
    jitted = np.asarray(jax.jit(self_iou)(jnp.asarray(boxes)))
    c = box2d_to_corners(torch.from_numpy(boxes)[:, [0, 1, 5, 4, 6]])
    port = torch.diag(rotated_iou_matrix(c, c)).numpy()
    np.testing.assert_allclose(eager, 1.0, atol=1e-6)
    np.testing.assert_allclose(port, 1.0, atol=1e-6)
    assert np.abs(jitted - 1.0).max() > 0.5
