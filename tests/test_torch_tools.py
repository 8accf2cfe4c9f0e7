"""The port's tools on the CPU: ap_curve, the profiler's FLOP count,
bench_matrix, inference --save_vis and baseline_ab's missing reference.

Tiny configs (tests/configs/), seeded weights, ``--device cpu``:
``ap_curve`` over a 2-epoch run of tiny_intermediate.yaml through
tools/train.py, one frame an epoch; the profiler's FlopCounterMode count
of an entry_tiny forward equal EXACTLY to a forward-hook count of 2 x
MACs over the convolutions and the PFN product (kernels 1 and 2 run
apart from the counter, their operations reported beside it); the bench
matrix's rows on entry_tiny; ``--save_vis`` writing ``vis/bev_00000.png``.
"""
import json
import math
import os

import pytest
import torch

from heal_tpu_torch.config import save_yaml
from heal_tpu_torch.tools import (ap_curve, baseline_ab, bench_matrix,
                                  inference, profiler)
from heal_tpu_torch.tools import train as train_tool

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "tests", "configs", "entry_tiny.yaml")
INTERMEDIATE = os.path.join(REPO, "tests", "configs", "tiny_intermediate.yaml")


def test_list_epoch_checkpoints_takes_pth_and_ckpt(tmp_path):
    for name in ("net_epoch1.ckpt", "net_epoch2.pth", "net_epoch2.ckpt",
                 "net_epoch10.pth", "net_epoch_bestval_at2.pth",
                 "net_epoch3.pth.tmp", "config.yaml"):
        (tmp_path / name).write_bytes(b"")
    got = ap_curve.list_epoch_checkpoints(str(tmp_path))
    assert got == [(1, str(tmp_path / "net_epoch1.ckpt")),
                   (2, str(tmp_path / "net_epoch2.pth")),
                   (10, str(tmp_path / "net_epoch10.pth"))]


def test_ap_curve_over_a_two_epoch_run(tmp_path):
    cfg = train_tool.load_config(INTERMEDIATE)
    cfg["fusion"]["args"].update(num_scenes_train=4, num_scenes_test=2)
    cfg["train_params"]["save_freq"] = 1
    yaml = str(tmp_path / "cfg.yaml")
    save_yaml(cfg, yaml)
    run_dir = str(tmp_path / "run")
    train_tool.main(["-y", yaml, "--model_dir", run_dir, "--epochs", "2",
                     "--no_final_inference", "--device", "cpu"])
    assert os.path.isdir(os.path.join(run_dir, "scripts", "heal_tpu_torch"))
    curve = ap_curve.main(["--model_dir", run_dir, "--max_batches", "1",
                           "--device", "cpu"])
    assert [r["epoch"] for r in curve] == [1, 2]
    for row in curve:
        assert row["frames"] == 1.0
        for k in ("ap_30", "ap_50", "ap_70"):
            assert 0.0 <= row[k] <= 1.0
    with open(os.path.join(run_dir, "ap_curve.json")) as f:
        assert json.load(f) == curve
    for epoch in (1, 2):
        assert os.path.exists(os.path.join(run_dir,
                                           f"eval_epoch{epoch}.yaml"))


def _hook_flops(model, inputs) -> int:
    """2 x MACs from forward hooks: every (O, I/g, kh, kw) convolution of
    the model, each transposed one (its input pixels x I x O x s x s /
    g), and the eval PointPillars encoder's per-point PFN product
    (points x 4 x F, models/encoders.py ``kernel_inputs``)."""
    from heal_tpu_torch.models.encoders import PointPillarEncoder

    macs = [0]

    def hook(mod, inp, out):
        k = getattr(mod, "kernel", None)
        if isinstance(mod, PointPillarEncoder):
            pts = inp[0]
            macs[0] += pts.shape[0] * pts.shape[1] * 4 * mod.out_channels
        elif k is None or k.dim() != 4:
            return
        elif type(mod).__name__ == "_PixelShuffleDeconv":
            x = inp[0]
            macs[0] += x.numel() // x.shape[1] * k.numel()
        else:
            macs[0] += out.numel() * k.shape[1] * k.shape[2] * k.shape[3]

    hooks = [m.register_forward_hook(hook) for m in model.modules()]
    try:
        with torch.inference_mode():
            profiler.forward(model, inputs)
    finally:
        for h in hooks:
            h.remove()
    return 2 * macs[0]


def test_profiler_flops_equal_the_hook_count():
    from heal_tpu_torch.data import build_dataset

    cfg = train_tool.load_config(TINY)
    batch = next(build_dataset(cfg, train=False).batches(1, shuffle=False))
    inputs = inference.frame_inputs(batch, inference.batch_keys(cfg),
                                    torch.device("cpu"), False)
    model = inference.build_weights(cfg, seed=0).eval()
    got = profiler.flop_count(model, inputs)
    assert got["counter_flops"] == _hook_flops(model, inputs) > 0
    assert got["counter_flops"] == sum(got["by_op"].values())
    # kernel 1's plain version ran apart from the counter: its operations
    # are reported from kernels/cases.pillar_work, kernel 2 not reached
    # (the CPU warps with grid_sample)
    assert got["kernel_ops"]["pillar_tables"] > 0
    assert got["kernel_ops"]["shift_rows"] == 0
    assert profiler.count_params(model) == sum(
        v.numel() for k, v in model.state_dict().items()
        if not k.endswith(("mean", "var")))


def test_profiler_main_reports(capsys):
    rep = profiler.main(["-y", TINY, "--device", "cpu", "--iters", "1",
                         "--train"])
    assert json.loads(capsys.readouterr().out) == rep
    assert rep["params"] > 0 and rep["memory"] == {}
    assert rep["inference"]["fps"] > 0 and rep["training"]["step_ms"] > 0
    assert rep["training"]["batch_size"] == 2


def test_bench_matrix_rows_on_a_tiny_config(tmp_path, monkeypatch):
    cfg = train_tool.load_config(TINY)
    monkeypatch.setattr(bench_matrix, "load_path_cfg",
                        lambda rel, frames, train=False: cfg)
    monkeypatch.setitem(bench_matrix.PATH_CONFIGS, "tiny",
                        {"cfg": "tiny", "desc": "entry_tiny",
                         "max_agents": 2})
    out = str(tmp_path / "rows.json")
    rows = bench_matrix.main(["--paths", "tiny,train_bf16", "--frames", "2",
                              "--device", "cpu", "--out", out])
    with open(out) as f:
        assert json.load(f) == rows
    path, train = rows
    assert path["path"] == "tiny" and path["frames"] == 2
    assert path["desc"] == "entry_tiny"
    assert math.isclose(path["fps"] * path["ms_per_frame"], 1e3)
    assert train["path"] == "train_pp_max_bf16" and train["fps"] > 0
    x = {"points": torch.ones(2, 4), "pairwise_affine": torch.ones(1),
         "inputs_m2": {"imgs": torch.ones(2), "intrins": torch.ones(2),
                       "depth": torch.ones(2, dtype=torch.int64)}}
    got = bench_matrix.cast16(x)
    assert got["points"].dtype == got["pairwise_affine"].dtype == \
        got["inputs_m2"]["intrins"].dtype == torch.float32
    assert got["inputs_m2"]["imgs"].dtype == torch.bfloat16
    assert got["inputs_m2"]["depth"].dtype == torch.int64


def test_inference_save_vis_writes_the_picture(tmp_path):
    cfg = train_tool.load_config(TINY)
    save_yaml(cfg, str(tmp_path / "config.yaml"))
    result = inference.main(["--model_dir", str(tmp_path), "--device", "cpu",
                             "--max_batches", "2", "--save_vis",
                             "--vis_interval", "2"])
    assert result["frames"] == 2
    assert (tmp_path / "vis" / "bev_00000.png").stat().st_size > 0
    assert not (tmp_path / "vis" / "bev_00001.png").exists()
    with pytest.raises(ValueError, match="model_dir"):
        inference.run_inference(cfg=cfg, device="cpu", save_vis=True)


def test_baseline_ab_names_the_missing_reference(tmp_path):
    missing = str(tmp_path / "no_opencood")
    with pytest.raises(FileNotFoundError, match="no_opencood"):
        baseline_ab.reference_flops_params(10, 2, missing)
    assert baseline_ab.reference_root(missing) == missing
