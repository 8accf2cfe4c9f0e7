"""The tiny HEAL protocol end to end through the port's CLIs, on the CPU.

Stage 1 trains tests/configs/entry_tiny.yaml (m1 base); stage 2 trains
entry_m4_single.yaml with ``--init_from`` the stage-1 ``.pth`` and, in a
second run, a heal_tpu ``.ckpt`` of the same weights (written by
``heal_tpu.tools.checkpoint.save_checkpoint``); ``merge_final`` merges
them; the alliance (entry_m1m2m3m4_final.yaml cut to m1 and m4) is served
by ``run_inference``, ``run_in_order`` (m1, then m1m4), the noise
sweep, and CoAlign's box-aligned sweep on the stage-1 base's detections
(``pose_graph_pre_calc``); ``run_demo_full`` drives the same phases from
a config dir.
The camera agent type m2 goes the same way: ``_camera_configs`` makes
entry_m4_single.yaml a Lift-Splat-Shoot m2 on the same grid (with
``cache_device_batches``, as heal_tpu's demo configs set it) and the
alliance m1 + m2 + m4, and run_demo_full's m2 leg trains it. So does
the SECOND type m3 (entry_m3_single.yaml): its stage 2 from the
``.pth``, the merge with m4, the m1 + m3 + m4 alliance and its in-order
table with ``--degrade m3:16``; run_demo_full trains m4, m2 and m3 and
serves all four types.
Checked: the frozen modules equal the stage-1 values bit for bit, no
frozen key is left out at load, the new branch moved, the depth loss
trained it, the merged checkpoint loads strictly into the alliance, and
the tools' outputs (the camera's depth RMSE among them).
"""
import json
import os

import numpy as np
import pytest
import torch

from heal_tpu.config import load_yaml as jax_load_yaml
from heal_tpu.config.loader import PARSER_REGISTRY as JAX_PARSERS
from heal_tpu.tools import checkpoint as jax_ckpt
from heal_tpu.tools.merge import rename_modules as jax_rename_modules
from heal_tpu.utils.common import update_dict as jax_update_dict
from heal_tpu_torch.config import keep_modalities, load_yaml, save_yaml
from heal_tpu_torch.models import build_model
from heal_tpu_torch.tools import checkpoint as ckpt_lib
from heal_tpu_torch.tools import pose_graph_pre_calc, run_demo_full
from heal_tpu_torch.tools import train as train_tool
from heal_tpu_torch.tools.inference import apply_overrides, run_inference
from heal_tpu_torch.tools.inference_heter_in_order import main as \
    in_order_main
from heal_tpu_torch.tools.inference_heter_in_order import run_in_order
from heal_tpu_torch.tools.inference_w_noise import run_noise_sweep
from heal_tpu_torch.tools.merge import main as merge_main
from heal_tpu_torch.tools.merge import rename_modules
from heal_tpu_torch.utils.bridge import from_flax, to_flax

torch.set_num_threads(1)
TINY = "tests/configs/entry_tiny.yaml"
M4 = "tests/configs/entry_m4_single.yaml"
M3 = "tests/configs/entry_m3_single.yaml"
FINAL = "tests/configs/entry_m1m2m3m4_final.yaml"
FROZEN = ("pyramid_backbone", "shrink", "heads")


def _camera_configs(tmp_path, keep=("m1", "m2", "m4")) -> tuple[str, str]:
    """-> (the m2 stage-2 yaml, the alliance yaml of the types ``keep``):
    a camera m2 (4 cameras at 64x96, 8 LID bins, 16 features; a 32x32
    grid of 1.2 m, the pyramid's input grid) in place of the lidar ones."""
    grid = {"xbound": [-19.2, 19.2, 1.2], "ybound": [-19.2, 19.2, 1.2],
            "zbound": [-10, 10, 20.0], "ddiscr": [2, 30, 8], "mode": "LID"}
    aug = {"final_dim": [64, 96], "Ncams": 4}
    setting = {"sensor_type": "camera", "core_method": "lift_splat_shoot",
               "grid_conf": grid, "data_aug_conf": aug, "img_downsample": 16}
    branch = {"core_method": "lift_splat_shoot", "sensor_type": "camera",
              "encoder_args": {"grid_conf": grid, "data_aug_conf": aug,
                               "img_downsample": 16, "img_features": 16,
                               "depth_supervision": True},
              "backbone_args": {"layer_nums": [1], "layer_strides": [1],
                                "num_filters": [16]},
              "aligner_args": {"core_method": "res1x1"}}
    single = load_yaml(M4)
    single["name"] = "entry_m2_camera_single"
    single["train_params"]["cache_device_batches"] = True
    single["heter"].update(ego_modality="m2", modality_setting={
        "m2": setting}, mapping_dict={m: "m2" for m in
                                     ("m1", "m2", "m3", "m4")})
    del single["model"]["args"]["m4"]
    single["model"]["args"]["m2"] = branch
    final = keep_modalities(load_yaml(FINAL), keep)
    final["heter"]["modality_setting"]["m2"] = setting
    final["model"]["args"]["m2"] = branch
    paths = (str(tmp_path / "m2_single.yaml"),
             str(tmp_path / f"{''.join(keep)}.yaml"))
    for cfg, path in zip((single, final), paths):
        save_yaml(cfg, path)
    return paths


def _stage2(run, init_from, capsys, cfg=M4, branch="m4"):
    train_tool.main(["-y", cfg, "--model_dir", run, "--epochs", "1",
                     "--device", "cpu", "--no_final_inference",
                     "--init_from", init_from])
    out = capsys.readouterr().out
    assert "[train] frozen modules: ('pyramid_backbone', 'shrink', 'heads')" \
        in out
    # the stage-1 branch is what is left out: printed 10 keys, no frozen one
    left = [line.strip() for line in out.splitlines()
            if line.startswith("    ")]
    assert len(left) == 10 and all(k.startswith("branch_m1.") for k in left)
    assert "20 source keys not loaded" in out
    sd = ckpt_lib.load_state_dict(ckpt_lib.find_checkpoint(run)[1])
    assert {k.split(".")[0] for k in sd} == {f"branch_{branch}", *FROZEN}
    return sd


def test_protocol_through_the_clis(tmp_path, capsys):
    s1 = str(tmp_path / "stage1")
    train_tool.main(["-y", TINY, "--model_dir", s1, "--epochs", "1",
                     "--device", "cpu", "--no_final_inference"])
    s1_path = ckpt_lib.find_checkpoint(s1)[1]
    base = ckpt_lib.load_state_dict(s1_path)
    # the same weights as a heal_tpu checkpoint
    params, stats = to_flax(base)
    jax_path = jax_ckpt.save_checkpoint(
        str(tmp_path / "jax_stage1"), {"params": params, "batch_stats": stats},
        1)
    capsys.readouterr()

    runs = {}
    for name, src in (("pth", s1_path), ("ckpt", jax_path)):
        runs[name] = _stage2(str(tmp_path / f"stage2_{name}"), src, capsys)
        s2 = runs[name]
        frozen = [k for k in s2 if k.split(".")[0] in FROZEN]
        assert len(frozen) > 30
        for k in frozen:
            assert torch.equal(s2[k], base[k]), (name, k)
    init = build_model(load_yaml(M4)["model"]).state_dict().keys()
    assert runs["pth"].keys() == init
    # from either format the stage-2 run is the same
    for k in runs["pth"]:
        assert torch.equal(runs["pth"][k], runs["ckpt"][k]), k

    merged = str(tmp_path / "merged")
    merge_main(["merge_final", str(tmp_path / "stage2_pth"), s1, merged])
    assert os.path.exists(os.path.join(merged, "config.yaml"))  # the base's
    final = keep_modalities(load_yaml(FINAL), ("m1", "m4"))
    save_yaml(final, os.path.join(merged, "config.yaml"))
    sd = ckpt_lib.load_state_dict(os.path.join(merged,
                                               "net_epoch_bestval_at0.pth"))
    build_model(final["model"]).load_state_dict(sd, strict=True)
    for k, v in sd.items():
        src = base if k.split(".")[0] in FROZEN + ("branch_m1",) \
            else runs["pth"]
        assert torch.equal(v, src[k]), k

    res = run_inference(merged, device="cpu", max_batches=2, note="merged")
    assert res["frames"] == 2 and 0.0 <= res["ap_50"] <= 1.0
    assert os.path.exists(os.path.join(merged, "eval_merged.yaml"))
    order = run_in_order(merged, device="cpu", max_batches=1)
    assert list(order) == ["m1", "m1m4"]
    with open(os.path.join(merged, "ap_in_order.json")) as f:
        assert json.load(f) == order
    noise = run_noise_sweep(merged, levels=(0.2,), device="cpu",
                            max_batches=1)
    assert list(noise) == [0.2] and set(noise[0.2]) == {
        "ap_30", "ap_50", "ap_70"}
    # CoAlign: the stage-1 base's detections, then the box-aligned sweep
    boxes = str(tmp_path / "stage1_boxes.json")
    dump = pose_graph_pre_calc.main(["--model_dir", s1, "--out", boxes,
                                     "--max_frames", "2", "--device", "cpu"])
    assert sorted(dump) == ["0", "1"]
    aligned = run_noise_sweep(merged, levels=(0.2,), device="cpu",
                              max_batches=1, box_align_precalc=boxes)
    assert list(aligned) == [0.2] and set(aligned[0.2]) == {
        "ap_30", "ap_50", "ap_70"}
    with open(os.path.join(merged, "ap_vs_noise_gauss_boxalign.json")) as f:
        assert json.load(f) == {"0.2": aligned[0.2]}


def test_camera_protocol_through_the_clis(tmp_path, capsys):
    """m2 (camera) against the m1 base: stage 2 from the device cache,
    the merge with the m4 run, the m1 + m2 + m4 alliance served with its
    depth RMSE, the in-order table."""
    m2_yaml, final_yaml = _camera_configs(tmp_path)
    s1 = str(tmp_path / "stage1")
    train_tool.main(["-y", TINY, "--model_dir", s1, "--epochs", "1",
                     "--device", "cpu", "--no_final_inference"])
    s1_path = ckpt_lib.find_checkpoint(s1)[1]
    base = ckpt_lib.load_state_dict(s1_path)
    capsys.readouterr()
    s2 = _stage2(str(tmp_path / "stage2_m2"), s1_path, capsys, m2_yaml, "m2")
    for k in s2:
        if k.split(".")[0] in FROZEN:
            assert torch.equal(s2[k], base[k]), k
    init = build_model(load_yaml(m2_yaml)["model"]).state_dict()
    assert s2.keys() == init.keys()
    with open(str(tmp_path / "stage2_m2" / "train_log.jsonl")) as f:
        log = json.loads(f.read().splitlines()[-1])
    assert log["depth_loss"] > 0 and np.isfinite(log["total_loss"])
    s2_m4 = _stage2(str(tmp_path / "stage2_m4"), s1_path, capsys)

    merged = str(tmp_path / "merged")
    merge_main(["merge_final", str(tmp_path / "stage2_m4"),
                str(tmp_path / "stage2_m2"), s1, merged])
    final = load_yaml(final_yaml)
    save_yaml(final, os.path.join(merged, "config.yaml"))
    sd = ckpt_lib.load_state_dict(os.path.join(merged,
                                               "net_epoch_bestval_at0.pth"))
    build_model(final["model"]).load_state_dict(sd, strict=True)
    for k, v in sd.items():
        top = k.split(".")[0]
        src = {"branch_m2": s2, "branch_m4": s2_m4}.get(top, base)
        assert torch.equal(v, src[k]), k
    res = run_inference(merged, device="cpu", max_batches=2, note="merged")
    assert res["frames"] == 2 and 0.0 <= res["ap_50"] <= 1.0
    assert 0.0 < res["depth_rmse_m2"] < 30.0
    order = run_in_order(merged, device="cpu", max_batches=1)
    assert list(order) == ["m1", "m1m2", "m1m2m4"]


def test_second_protocol_through_the_clis(tmp_path, capsys):
    """m3 (SECOND) against the m1 base: stage 2 through the CLI from the
    stage-1 ``.pth``, the merge with the m4 run, the m1 + m3 + m4
    alliance served, the in-order table (m1, m1m3, m1m3m4) with the m3
    lidar cut to 16 lines (``--degrade m3:16``)."""
    s1 = str(tmp_path / "stage1")
    train_tool.main(["-y", TINY, "--model_dir", s1, "--epochs", "1",
                     "--device", "cpu", "--no_final_inference"])
    s1_path = ckpt_lib.find_checkpoint(s1)[1]
    base = ckpt_lib.load_state_dict(s1_path)
    capsys.readouterr()
    s2 = _stage2(str(tmp_path / "stage2_m3"), s1_path, capsys, M3, "m3")
    init = build_model(load_yaml(M3)["model"]).state_dict()
    assert s2.keys() == init.keys()
    stack = "branch_m3.encoder.VmapSecondStack_0."
    assert sum(k.startswith(stack) for k in s2) == 30
    for k in s2:
        if k.split(".")[0] in FROZEN:
            assert torch.equal(s2[k], base[k]), k
    s2_m4 = _stage2(str(tmp_path / "stage2_m4"), s1_path, capsys)

    merged = str(tmp_path / "merged")
    merge_main(["merge_final", str(tmp_path / "stage2_m4"),
                str(tmp_path / "stage2_m3"), s1, merged])
    final = keep_modalities(load_yaml(FINAL), ("m1", "m3", "m4"))
    save_yaml(final, os.path.join(merged, "config.yaml"))
    sd = ckpt_lib.load_state_dict(os.path.join(merged,
                                               "net_epoch_bestval_at0.pth"))
    build_model(final["model"]).load_state_dict(sd, strict=True)
    for k, v in sd.items():
        top = k.split(".")[0]
        src = {"branch_m3": s2, "branch_m4": s2_m4}.get(top, base)
        assert torch.equal(v, src[k]), k
    res = run_inference(merged, device="cpu", max_batches=2, note="merged")
    assert res["frames"] == 2 and 0.0 <= res["ap_50"] <= 1.0
    order = in_order_main(["--model_dir", merged, "--degrade", "m3:16",
                           "--max_batches", "1", "--device", "cpu"])
    assert list(order) == ["m1", "m1m3", "m1m3m4"]


def test_run_demo_full_tiny(tmp_path, capsys):
    """``run_demo_full`` on a config dir of the tiny configs, with an m4,
    an m2 (camera) and an m3 (SECOND) leg: every phase, the box-align leg
    (the stage-1 dump, then the sweep) with its AP per level, and a second
    call that finds every artifact and trains nothing."""
    cfg_dir = tmp_path / "cfgs"
    cfg_dir.mkdir()
    m2_yaml, final_yaml = _camera_configs(tmp_path,
                                          ("m1", "m2", "m3", "m4"))
    for name, src in (("stage1_m1", TINY), ("stage2_m4", M4),
                      ("stage2_m2", m2_yaml), ("stage2_m3", M3)):
        cfg = load_yaml(src)
        cfg["train_params"]["epoches"] = 1
        save_yaml(cfg, str(cfg_dir / f"{name}.yaml"))
    argv = ["--out", str(tmp_path / "demo"), "--cfg_dir", str(cfg_dir),
            "--modalities", "m4,m2,m3", "--final_cfg", final_yaml,
            "--max_batches", "1", "--device", "cpu"]
    out = run_demo_full.main(argv)
    assert set(out) == {"merged", "in_order", "noise", "noise_boxalign"}
    assert list(out["in_order"]) == ["m1", "m1m2", "m1m2m3", "m1m2m3m4"]
    assert sorted(out["noise"]) == ["0.0", "0.2", "0.4", "0.6"]
    assert sorted(out["noise_boxalign"]) == ["0.0", "0.2", "0.4", "0.6"]
    for aps in out["noise_boxalign"].values():
        assert set(aps) == {"ap_30", "ap_50", "ap_70"}
    assert os.path.exists(str(tmp_path / "demo" / "stage1_m1" /
                              "stage1_boxes.json"))
    assert out["merged"]["depth_rmse_m2"] > 0
    merged = load_yaml("", model_dir=str(tmp_path / "demo" /
                                         "merged_alliance"))
    assert sorted(merged["heter"]["modality_setting"]) == ["m1", "m2", "m3",
                                                           "m4"]
    capsys.readouterr()
    again = run_demo_full.main(argv)
    printed = capsys.readouterr().out
    assert "[epoch" not in printed and "stage 1: training" not in printed
    assert again["in_order"] == out["in_order"]
    assert np.isfinite(again["merged"]["ap_30"])


@pytest.mark.parametrize("case", ["noise", "in_order", "range"])
def test_config_overrides_match_jax(case):
    """``run_inference``'s config changes (``apply_overrides``) give the
    dict JAX's run_inference builds (heal_tpu/tools/inference.py:45-65)
    from the same config."""
    kw = {
        "noise": {"noise_setting": {"add_noise": True, "args": {
            "pos_std": 0.2, "rot_std": 0.2, "pos_mean": 0, "rot_mean": 0,
            "laplace": False, "von_mises": False}}},
        "in_order": {"cfg_override": {"comm_range": 180.0, "heter": {
            "mapping_dict": {"m1": "m1", "m4": "m4"}, "use_cav": 1,
            "lidar_channels_dict": {"m1": 32}}}},
        "range": {"override_range": (12.0, 9.6)},
    }[case]
    want = keep_modalities(jax_load_yaml(FINAL), ("m1", "m4"))
    got = apply_overrides(keep_modalities(load_yaml(FINAL), ("m1", "m4")),
                          **kw)
    if "noise_setting" in kw:
        want["noise_setting"] = kw["noise_setting"]
    if "cfg_override" in kw:
        jax_update_dict(want, kw["cfg_override"])
    if "override_range" in kw:
        r = kw["override_range"]
        new_range = [-r[0], -r[1], -3, r[0], r[1], 1]
        jax_update_dict(want, {"preprocess": {"cav_lidar_range": new_range},
                               "postprocess": {"gt_range": new_range,
                                               "anchor_args": {
                                                   "cav_lidar_range":
                                                       new_range}}})
        want = JAX_PARSERS[want["yaml_parser"]](want)
        assert got["postprocess"]["anchor_args"]["W"] == 40
    assert got == want


def test_rename_modules_matches_jax(tmp_path):
    """``rename_modules`` renames top-level modules as JAX's does: of a
    heal_tpu ``.ckpt`` into a ``.pth`` beside it, the bridge of JAX's
    renamed file; of a ``.pth`` in place, keeping ``.oldversion``."""
    from heal_tpu_torch.models.layers import init_weights

    model = init_weights(build_model(load_yaml(M4)["model"]),
                         torch.Generator().manual_seed(0))
    params, stats = to_flax(model.state_dict())
    mapping = {"branch_m4": "branch_m2", "heads": "heads_old"}
    paths = [jax_ckpt.save_checkpoint(str(tmp_path / d),
                                      {"params": params, "batch_stats": stats},
                                      1) for d in ("jax", "port")]
    got = ckpt_lib.load_state_dict(rename_modules(paths[1], mapping))
    jax_rename_modules(paths[0], mapping)
    tree = jax_ckpt.load_checkpoint(paths[0])
    want = from_flax(tree["params"], tree["batch_stats"])
    assert got.keys() == want.keys()
    assert {k.split(".")[0] for k in got} == {
        "branch_m2", "pyramid_backbone", "shrink", "heads_old"}
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    pth = ckpt_lib.save_checkpoint(str(tmp_path / "pth"), model, 1)
    assert rename_modules(pth, mapping) == pth
    assert ckpt_lib.load_state_dict(pth).keys() == got.keys()
    assert ckpt_lib.load_state_dict(pth + ".oldversion").keys() == \
        model.state_dict().keys()
