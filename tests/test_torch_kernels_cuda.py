"""The CUDA kernels of heal_tpu_torch against their plain versions, on
the card: kernel 1 on the edge cases the CPU tests share
(tests/torch_pillar_cases.py), one kernel and no host sync a call; kernel
2 in both directions; the gradient repairs; kernel 3 (one SECOND conv
layer) at each published width and the SECOND encoder; kernel 4 (V2X-ViT's
window attention) at every window and head width it is built for and in
the published fusion. Marked
``cuda``: they skip where torch sees no GPU (a CUDA
kernel has no CPU or interpret mode). On a machine with one card:

    HEAL_TPU_JIT_CACHE=off python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda

(the variable keeps tests/conftest.py from importing jax). Tolerances, as
in chip_smoke.py: f32 within a few ulps (kernel 1 sums in another order;
kernel 2 rounds as its plain version), bf16 within one bf16 ulp (both
sides compute in f32 and round once).
"""
import numpy as np
import pytest
import torch

from heal_tpu_torch import trace
from heal_tpu_torch.kernels.measure import device_kernels
from heal_tpu_torch.ops import pillar, shift_rows
from heal_tpu_torch.ops.warp import warp_agents_to_ego
from heal_tpu_torch.ops.window_attention import KERNEL4_SHAPES
from torch_pillar_cases import CASES, make_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launches(name: str) -> int:
    """The launches the tracer has counted under ``name``."""
    return trace.counters().get(name, 0)


def _close(got, want, dtype):
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    scale = 1.0 + want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pillar_tables_kernel_matches_plain(dev, dtype):
    rng = np.random.RandomState(0)
    nx, ny, b, f = 16, 8, 3, 64
    stride, cells = nx * ny, nx * ny + 1
    ids = np.sort(rng.randint(0, cells, (b, 900)), 1)  # with drop buckets
    fi = (ids + np.arange(b)[:, None] * cells).reshape(-1).astype(np.int32)
    fi = np.concatenate([fi, np.full(40, b * cells, np.int32)])  # sentinel
    n = len(fi)
    u = torch.from_numpy(rng.randn(n, f).astype(np.float32)).to(dev, dtype)
    g4 = torch.from_numpy(np.concatenate(
        [rng.randn(n, 3), rng.rand(n, 1) > 0.3], 1).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.randn(7, f).astype(np.float32)).to(dev)
    grid = pillar.PillarGrid(nx, stride, cells, 0.4, 0.4, 0.2, 0.2, -1.0)
    fi_t = torch.from_numpy(fi).to(dev)
    before = _launches("kernel1.launches")
    got = pillar.pillar_tables(u, g4, fi_t, w, grid, b)
    assert _launches("kernel1.launches") == before + 1
    want = pillar.pillar_tables_plain(u, g4, fi_t, w, grid, b)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b * stride, f) and got.dtype == dtype
    _close(got, want, dtype)


def _pillar_args(name, dev, dtype):
    """pillar_tables' arguments for a shared edge case, on the card."""
    c = make_case(name)
    stride = c["nx"] * c["ny"]
    grid = pillar.PillarGrid(c["nx"], stride, stride + 1, c["vx"], c["vy"],
                             *c["geom0"])
    w = np.concatenate([c["w1"], c["w2"], c["b_aff"][None]])
    return (torch.from_numpy(c["u"]).to(dev, dtype),
            torch.from_numpy(c["g4"]).to(dev),
            torch.from_numpy(c["fi"]).to(dev),
            torch.from_numpy(w).to(dev), grid, c["batch"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", CASES)
def test_pillar_tables_kernel_edge_cases(dev, name, dtype):
    """The edge cases the CPU tests hold against the Pallas kernel
    (tests/torch_pillar_cases.py): one launch per call, the plain version's
    canvas, and the same bits from two calls (each run reduced in one
    fixed order)."""
    args = _pillar_args(name, dev, dtype)
    before = _launches("kernel1.launches")
    got = pillar.pillar_tables(*args)
    assert _launches("kernel1.launches") == before + 1
    again = pillar.pillar_tables(*args)
    want = pillar.pillar_tables_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    _close(got, want, dtype)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pillar_tables_is_one_kernel_and_never_syncs(dev, dtype):
    """One call puts exactly one kernel on the card, and runs under
    torch.cuda.set_sync_debug_mode("error") (a host sync would raise)."""
    args = _pillar_args("sentinels", dev, dtype)
    pillar.pillar_tables(*args)  # built and loaded
    launched = device_kernels(lambda: pillar.pillar_tables(*args))
    assert len(launched) == 1 and "pillar_tables" in launched[0], launched


def test_pillar_tables_takes_misaligned_u_and_empty_batches(dev):
    """A u that is not 16-byte aligned takes the kernel's element-wise
    path at F = 64; a batch of 0 gives an empty canvas and launches
    nothing."""
    u, g4, fi, w, grid, batch = _pillar_args("straddle", dev, torch.float32)
    buf = torch.empty(u.numel() + 1, device=dev)
    shifted = buf[1:].view(u.shape)
    shifted.copy_(u)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    got = pillar.pillar_tables(shifted, g4, fi, w, grid, batch)
    want = pillar.pillar_tables_plain(u, g4, fi, w, grid, batch)
    torch.cuda.synchronize()
    _close(got, want, torch.float32)
    before = _launches("kernel1.launches")
    empty = pillar.pillar_tables(u[:0], g4[:0], fi[:0], w, grid, 0)
    assert empty.shape == (0, u.shape[1])
    assert _launches("kernel1.launches") == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 65, 257])
def test_shift_kernel_matches_plain(dev, dtype, c):
    gen = torch.Generator(device=dev).manual_seed(c)
    x = torch.randn((3, 37, 41, c), generator=gen, device=dev).to(dtype)
    for fn, plain, n_shift in (
        (shift_rows.shift_rows, shift_rows.shift_rows_plain, 37),
        (shift_rows.shift_cols, shift_rows.shift_cols_plain, 41),
    ):
        s = (torch.rand((3, n_shift), generator=gen, device=dev) * 2 - 1) * 9
        s[:, :3] = torch.tensor([7.0, -7.0, 30.0], device=dev)  # bound, past
        got = fn(x, s, 7)
        want = plain(x, s, 7)
        torch.cuda.synchronize()
        assert got.shape == x.shape and got.dtype == dtype
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 9, 12, 8),     # rows of 96: 16-byte accesses in f32 and bf16
    (2, 9, 10, 3),     # 30: 8-byte f32, 4-byte bf16
    (2, 9, 10, 2),     # 20: 16-byte f32, 8-byte bf16
    (2, 9, 11, 3),     # 33: 4-byte f32, 2-byte bf16, scalar row tails
    (2, 5, 300, 17),   # 5100: several tiles per row
    (1, 70, 33, 1),    # a column per position
])
def test_shift_kernel_matches_plain_at_every_access_width(dev, dtype, shape):
    """The kernel picks its access width from the row's size in bytes;
    every width, row tails and shifts past the window agree with the plain
    version exactly (the blend rounds as the plain version does)."""
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    for fn, plain, n_shift in (
        (shift_rows.shift_rows, shift_rows.shift_rows_plain, shape[1]),
        (shift_rows.shift_cols, shift_rows.shift_cols_plain, shape[2]),
    ):
        s = (torch.rand((shape[0], n_shift), generator=gen, device=dev) * 2
             - 1) * 9
        s[:, :4] = torch.tensor([6.0, -6.0, 40.0, -40.0], device=dev)
        got = fn(x, s, 6)
        want = plain(x, s, 6)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis", [0, 1])
def test_shift_backward_kernel_matches_plain_backward(dev, dtype, axis):
    """x.grad through the autograd.Function (the kernel run with -s)
    against the plain backward, shift_*_plain(g, -s, max_shift)."""
    gen = torch.Generator(device=dev).manual_seed(axis)
    x = torch.randn((3, 37, 41, 65), generator=gen, device=dev).to(dtype)
    g = torch.randn((3, 37, 41, 65), generator=gen, device=dev).to(dtype)
    fn, plain = ((shift_rows.shift_rows, shift_rows.shift_rows_plain)
                 if axis == 0 else
                 (shift_rows.shift_cols, shift_rows.shift_cols_plain))
    s = (torch.rand((3, x.shape[1 + axis]), generator=gen,
                    device=dev) * 2 - 1) * 7
    xr = x.clone().requires_grad_()
    before = _launches("kernel2.backward_launches")
    fn(xr, s, 7).backward(g)
    assert _launches("kernel2.backward_launches") == before + 1
    want = plain(g, -s, 7)
    torch.cuda.synchronize()
    assert xr.grad.dtype == dtype
    _close(xr.grad, want, dtype)


def _warp_case(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    b, l, h, w, c = 2, 3, 24, 40, 5
    feats = torch.randn((b, l, h, w, c), generator=gen, device=dev)
    aff = torch.eye(2, 3, device=dev).repeat(b, l, l, 1, 1)
    for bi in range(b):
        for j in range(1, l):
            t = 0.7 * j - 1.1 * bi
            ct, st = float(np.cos(t)), float(np.sin(t))
            aff[bi, 0, j] = torch.tensor(
                [[ct, -st * h / w, 0.1 * j], [st * w / h, ct, -0.05]],
                device=dev)
    return feats, aff


def test_shear_warp_input_gradient_goes_through_the_kernel(dev, monkeypatch):
    """The shear warp's gradient on the card equals the one through the
    plain versions, and reaches the non-ego agents (before the kernel had
    a backward it silently came back zero there)."""
    feats, aff = _warp_case(dev)
    cot = torch.randn(feats.shape, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(1))

    def grad():
        x = feats.clone().requires_grad_()
        (warp_agents_to_ego(x, aff) * cot).sum().backward()
        return x.grad

    before = _launches("kernel2.backward_launches")
    got = grad()
    assert _launches("kernel2.backward_launches") > before
    monkeypatch.setattr(shift_rows, "shift_rows", shift_rows.shift_rows_plain)
    monkeypatch.setattr(shift_rows, "shift_cols", shift_rows.shift_cols_plain)
    want = grad()
    torch.cuda.synchronize()
    assert want[:, 1:].abs().max() > 0
    _close(got, want, torch.float32)


@pytest.mark.parametrize("c", [1, 5])
def test_warp_pairwise_shear_on_the_card_matches_plain(dev, monkeypatch, c):
    """``warp_pairwise`` takes the shear on a CUDA tensor: 5 kernel-2
    launches a call (3 shears, 2 remainder shifts) for all B·I·J maps,
    forward and backward, equal to the same warp through the plain
    versions. c = 1 is V2VNet's field-of-view warp of ones."""
    from heal_tpu_torch.ops.warp import warp_pairwise

    feats, aff = _warp_case(dev)
    feats = feats[..., :c].contiguous()
    # every pair, not only the ego's row
    aff = aff[:, :1].expand(aff.shape).contiguous()
    aff = aff.transpose(1, 2).contiguous()
    cot = torch.randn(feats.shape[:1] + (3,) + feats.shape[1:], device=dev,
                      generator=torch.Generator(device=dev).manual_seed(2))

    def run():
        x = feats.clone().requires_grad_()
        out = warp_pairwise(x, aff)
        (out * cot).sum().backward()
        return out.detach(), x.grad

    fwd = _launches("kernel2.launches")
    bwd = _launches("kernel2.backward_launches")
    got, got_g = run()
    assert _launches("kernel2.launches") == fwd + 5
    assert _launches("kernel2.backward_launches") == bwd + 5
    assert got.shape == (2, 3, 3, 24, 40, c)
    monkeypatch.setattr(shift_rows, "shift_rows", shift_rows.shift_rows_plain)
    monkeypatch.setattr(shift_rows, "shift_cols", shift_rows.shift_cols_plain)
    want, want_g = run()
    torch.cuda.synchronize()
    assert want.abs().max() > 0 and want_g.abs().max() > 0
    _close(got, want, torch.float32)
    _close(got_g, want_g, torch.float32)


def test_pillar_tables_raises_under_grad_on_the_card(dev):
    grid = pillar.PillarGrid(2, 4, 5, 1.0, 1.0, 0.5, 0.5, 0.0)
    u = torch.zeros((3, 8), device=dev, requires_grad=True)
    args = (torch.zeros((3, 4), device=dev),
            torch.zeros(3, dtype=torch.int32, device=dev),
            torch.zeros((7, 8), device=dev), grid, 1)
    before = _launches("kernel1.launches")
    with pytest.raises(RuntimeError, match="no backward"):
        pillar.pillar_tables(u, *args)
    assert _launches("kernel1.launches") == before


def test_kernels_raise_on_inputs_they_do_not_take(dev):
    x = torch.zeros((1, 4, 4, 2), dtype=torch.float16, device=dev)
    with pytest.raises(TypeError):
        shift_rows.shift_rows(x, torch.zeros((1, 4), device=dev), 2)
    x = torch.zeros((1, 4, 4, 2), device=dev)
    with pytest.raises(ValueError):
        shift_rows.shift_rows(x, torch.zeros((1, 5), device=dev), 2)
    grid = pillar.PillarGrid(2, 4, 5, 1.0, 1.0, 0.5, 0.5, 0.0)
    with pytest.raises(ValueError):
        pillar.pillar_tables(
            torch.zeros((3, 8), device=dev), torch.zeros((3, 4), device=dev),
            torch.zeros(3, dtype=torch.int64, device=dev),
            torch.zeros((7, 8), device=dev), grid, 1)


@pytest.mark.parametrize("method,per_frame", [("late", 2), ("early", 1)])
def test_late_and_early_frames_launch_kernel_1_once_per_forward(dev, method,
                                                                per_frame):
    """tests/configs/tiny_late.yaml served on the card: late fusion runs
    one forward per agent sample (the ego and one other agent a frame),
    each launching kernel 1 once; early fusion one a frame; kernel 2
    never (no warp). The f32 heads of every forward within 1e-4 of the
    same frames through kernel 1's plain version."""
    from heal_tpu_torch.config import load_yaml
    from heal_tpu_torch.tools.inference import (build_weights, device_frames,
                                                run_inference)

    cfg = load_yaml("tests/configs/tiny_late.yaml")
    cfg["fusion"]["core_method"] = method
    model = build_weights(cfg, seed=0).to(dev)
    frames = device_frames(cfg, dev, 2)
    k1, k2 = _launches("kernel1.launches"), _launches("kernel2.launches")
    got = run_inference(cfg=cfg, device=dev, model=model, frames=frames,
                        collect_heads=True)
    assert _launches("kernel1.launches") - k1 == 2 * per_frame
    assert _launches("kernel2.launches") == k2
    assert len(got["heads"]) == 2 * per_frame
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pillar, "pillar_tables", pillar.pillar_tables_plain)
        want = run_inference(cfg=cfg, device=dev, model=model, frames=frames,
                             collect_heads=True)
    for a, b in zip(got["heads"], want["heads"]):
        for k in a:
            scale = 1.0 + b[k].abs().max().item()
            assert (a[k] - b[k]).abs().max().item() <= 1e-4 * scale, k


def test_compressed_pyramid_frames_launch_both_kernels(dev):
    """tests/configs/tiny_heter_collab.yaml with HEAL's naive compressor
    served on the card: kernel 1 once a frame (the m1 branch) and kernel
    2 15 times (weighted_fuse: 3 levels x 5 launches); the f32 heads
    within 1e-4 of the same frames through both plain versions."""
    from heal_tpu_torch.config import load_yaml
    from heal_tpu_torch.tools.inference import (build_weights, device_frames,
                                                run_inference)

    cfg = load_yaml("tests/configs/tiny_heter_collab.yaml")
    cfg["model"]["args"]["compressor"] = {"core_method": "naive",
                                          "input_dim": 32,
                                          "compress_ratio": 4}
    model = build_weights(cfg, seed=0).to(dev)
    assert model.compressor is not None
    frames = device_frames(cfg, dev, 2)
    k1, k2 = _launches("kernel1.launches"), _launches("kernel2.launches")
    got = run_inference(cfg=cfg, device=dev, model=model, frames=frames,
                        collect_heads=True)
    assert _launches("kernel1.launches") - k1 == 2
    assert _launches("kernel2.launches") - k2 == 2 * 15
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pillar, "pillar_tables", pillar.pillar_tables_plain)
        mp.setattr(shift_rows, "_shift",
                   lambda x, s, m, axis, backward=False: (
                       shift_rows.shift_rows_plain if axis == 0
                       else shift_rows.shift_cols_plain)(x, s, m))
        want = run_inference(cfg=cfg, device=dev, model=model, frames=frames,
                             collect_heads=True)
    for a, b in zip(got["heads"], want["heads"]):
        for k in a:
            scale = 1.0 + b[k].abs().max().item()
            assert (a[k] - b[k]).abs().max().item() <= 1e-4 * scale, k


@pytest.mark.parametrize("core,launches", [
    ("center_point_where2comm", (1, 5, 0)),
    ("second_intermediate", (0, 5, 10))])
def test_center_point_and_second_frames_launch_the_kernels(dev, core,
                                                          launches):
    """tests/configs/tiny_intermediate.yaml as CenterPoint with Where2comm
    (kernel 1 once a frame, kernel 2 5 times: one warp) and as SECOND
    intermediate with att at the published SECOND widths (kernel 2 and
    kernel 3 at each of the 10 conv layers); the f32 heads within 1e-4 of
    the same frames through the kernels' plain versions, both
    runs with deterministic algorithms and TF32 off, as chip_smoke's
    heads check (without them the two SECOND runs' reg heads differed by
    1.06e-4 relative on an H100)."""
    from heal_tpu_torch.config import load_yaml
    from heal_tpu_torch.ops import column_conv as cc
    from heal_tpu_torch.tools.inference import (build_weights, device_frames,
                                                run_inference)

    cfg = load_yaml("tests/configs/tiny_intermediate.yaml")
    a = cfg["model"]["args"]
    cfg["model"]["core_method"] = core
    if core == "second_intermediate":
        a.update(voxel_size=[0.15, 0.15, 0.5], fusion_method="att",
                 second={"channels": [16, 32, 64, 64],
                         "max_voxels": [4096, 3072, 2048, 1536]})
        a["base_bev_backbone"].update(layer_strides=[1, 2],
                                      num_filters=[16, 32],
                                      num_upsample_filter=[16, 16])
        a["shrink_header"].update(dim=[32], input_dim=32)
    model = build_weights(cfg, seed=0).to(dev)
    frames = device_frames(cfg, dev, 2)
    k1, k2 = _launches("kernel1.launches"), _launches("kernel2.launches")
    k3 = _launches("kernel3.launches")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.backends.cudnn, "allow_tf32", False)
        mp.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            got = run_inference(cfg=cfg, device=dev, model=model,
                                frames=frames, collect_heads=True)
            assert _launches("kernel1.launches") - k1 == 2 * launches[0]
            assert _launches("kernel2.launches") - k2 == 2 * launches[1]
            assert _launches("kernel3.launches") - k3 == 2 * launches[2]
            mp.setattr(pillar, "pillar_tables", pillar.pillar_tables_plain)
            mp.setattr(shift_rows, "_shift",
                       lambda x, s, m, axis, backward=False: (
                           shift_rows.shift_rows_plain if axis == 0
                           else shift_rows.shift_cols_plain)(x, s, m))
            mp.setattr(cc, "column_conv_layer", cc.column_conv_layer_plain)
            want = run_inference(cfg=cfg, device=dev, model=model,
                                 frames=frames, collect_heads=True)
        finally:
            torch.use_deterministic_algorithms(False)
    assert _launches("kernel3.launches") - k3 == 2 * launches[2]
    assert got["heads"][0]["cls_preds"].shape[1:3] == (64, 64)
    for g, w in zip(got["heads"], want["heads"]):
        for k in g:
            scale = 1.0 + w[k].abs().max().item()
            assert (g[k] - w[k]).abs().max().item() <= 1e-4 * scale, k


@pytest.mark.parametrize("case,launches", [("group_late", (0, 0)),
                                           ("iou_att", (1, 5))])
def test_option_frames_launch_exactly_their_kernels(dev, case, launches):
    """Kernel 1 stays on JAX's fused-path condition: the late m1 + m2
    model on group norm (tests/configs/tiny_heter_m1m2.yaml as late
    fusion, ``norm`` removed) runs its PointPillars encoder on the
    general path and launches neither kernel; ``use_iou`` on the att
    baseline (tests/configs/tiny_late.yaml as intermediate fusion)
    launches kernel 1 once and kernel 2 five times a forward."""
    from heal_tpu_torch.config import load_yaml, reparse
    from heal_tpu_torch.tools.inference import (build_weights, device_frames,
                                                run_inference)

    if case == "group_late":
        cfg = load_yaml("tests/configs/tiny_heter_m1m2.yaml")
        cfg["fusion"]["core_method"] = "lateheter"
        cfg["model"]["core_method"] = "heter_model_late"
        a = cfg["model"]["args"]
        a.pop("fusion_backbone")
        a.pop("norm", None)
        a["shrink_header"].update(dim=[32], input_dim=32)
    else:
        cfg = load_yaml("tests/configs/tiny_late.yaml")
        cfg["fusion"]["core_method"] = "intermediate"
        cfg["model"]["core_method"] = "point_pillar_baseline"
        a = cfg["model"]["args"]
        a["base_bev_backbone"].update(num_filters=[16, 32],
                                      num_upsample_filter=[16, 16])
        a["shrink_header"].update(dim=[32], input_dim=32)
        a.update(fusion_method="att", att={"feat_dim": 32}, use_iou=True)
        cfg = reparse(cfg)
    model = build_weights(cfg, seed=0).to(dev)
    frames = device_frames(cfg, dev, 2)
    forwards = sum(len(f) if isinstance(f, list) else 1 for _, f in frames)
    k1, k2 = _launches("kernel1.launches"), _launches("kernel2.launches")
    got = run_inference(cfg=cfg, device=dev, model=model, frames=frames,
                        collect_heads=True)
    assert _launches("kernel1.launches") - k1 == forwards * launches[0]
    assert _launches("kernel2.launches") - k2 == forwards * launches[1]
    assert all(torch.isfinite(t).all() for h in got["heads"]
               for t in h.values())


def _legacy_tiny(core: str, **args) -> dict:
    """tests/configs/tiny_intermediate.yaml with its model switched to one
    of the last detectors (the CPU parity tests' sizes: VoxelNet on
    1.0 m z layers, PIXOR at 0.6 m over 8 slabs)."""
    from heal_tpu_torch.config import load_yaml

    cfg = load_yaml("tests/configs/tiny_intermediate.yaml")
    cfg["model"]["core_method"] = core
    cfg["model"]["args"].update(args)
    return cfg


@pytest.mark.parametrize("core,args,launches", [
    ("point_pillar_baseline_multiscale", {}, (1, 10)),
    ("point_pillar_disconet", {}, (1, 5)),
    ("voxel_net_intermediate", {"voxel_size": [0.6, 0.6, 1.0]}, (0, 5)),
    ("pixor_intermediate", {"bev_res": 0.6, "z_slabs": 8}, (0, 5)),
], ids=["multiscale", "disconet", "voxel_net_intermediate",
        "pixor_intermediate"])
def test_legacy_frames_launch_exactly_their_kernels(dev, core, args,
                                                    launches):
    """The multiscale baseline (kernel 1 once, kernel 2 5 times at each of
    its two levels), DiscoNet's student (one warp) and the intermediate
    VoxelNet and PIXOR (one warp, no pillar encoder), two frames f32 and
    bf16 each, none of them kernel 4; heads finite."""
    from heal_tpu_torch.tools.inference import (build_weights, device_frames,
                                                run_inference)

    cfg = _legacy_tiny(core, **args)
    model = build_weights(cfg, seed=0).to(dev)
    frames = device_frames(cfg, dev, 2)
    k1, k2 = _launches("kernel1.launches"), _launches("kernel2.launches")
    k4 = _launches("kernel4.launches")
    for dtype in (torch.float32, torch.bfloat16):
        got = run_inference(cfg=cfg, device=dev, dtype=dtype,
                            model=model.to(dtype), frames=frames,
                            collect_heads=True)
        assert all(torch.isfinite(t).all() for h in got["heads"]
                   for t in h.values())
    assert _launches("kernel1.launches") - k1 == 4 * launches[0]
    assert _launches("kernel2.launches") - k2 == 4 * launches[1]
    assert _launches("kernel4.launches") == k4


def test_kd_step_launches_the_teacher_once(dev, tmp_path):
    """One DiscoNet KD step on the card through tools/train_w_kd: kernel 1
    once (the frozen teacher's eval-mode encoder), kernel 2 5 times
    forward and 5 backward (the student's warp); the teacher bit-equal,
    kd_loss > 0."""
    from heal_tpu_torch.config import save_yaml
    from heal_tpu_torch.tools import checkpoint as ckpt_lib
    from heal_tpu_torch.tools import train_w_kd
    from heal_tpu_torch.tools.inference import build_weights
    from heal_tpu_torch.tools.train import build_trainer, device_batches

    cfg = _legacy_tiny("point_pillar_disconet")
    cfg["kd_flag"] = True
    cfg["loss"]["core_method"] = "point_pillar_disconet_loss"
    teacher_cfg = _legacy_tiny("point_pillar_disconet_teacher")
    teacher_cfg["fusion"]["core_method"] = "early"
    save_yaml(teacher_cfg, str(tmp_path / "config.yaml"))
    ckpt_lib.save_checkpoint(str(tmp_path),
                             build_weights(teacher_cfg, seed=1), 1)
    teacher = train_w_kd.load_teacher(str(tmp_path), dev)
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    tr = build_trainer(cfg, dev, 1, trainer_cls=train_w_kd.KDTrainer,
                       teacher=teacher)
    batch, _ = next(device_batches(cfg, 2, dev))
    k1, k2 = _launches("kernel1.launches"), _launches("kernel2.launches")
    kb = _launches("kernel2.backward_launches")
    aux = tr.train_step(batch)
    torch.cuda.synchronize()
    assert _launches("kernel1.launches") - k1 == 1
    assert _launches("kernel2.launches") - k2 == 5
    assert _launches("kernel2.backward_launches") - kb == 5
    assert aux["kd_loss"].item() > 0
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_point_ops_on_the_card_match_the_cpu(dev):
    """FPS and the ball query on the card against the same functions on
    the CPU, indices exact (padded points, a duplicate, a row with fewer
    valid points than samples); group_and_pool within 1e-5."""
    from heal_tpu_torch.ops import pointnet

    rng = np.random.RandomState(0)
    pts = rng.uniform(-20, 20, (3, 2000, 4)).astype(np.float32)
    pts[:, 7] = pts[:, 3]
    mask = np.ones((3, 2000), bool)
    mask[1, 500:] = False
    mask[2, 40:] = False
    q = rng.uniform(-20, 20, (3, 300, 3)).astype(np.float32)
    w = torch.from_numpy(rng.randn(4, 16).astype(np.float32))
    out = {}
    for d in ("cpu", dev):
        p, m = torch.from_numpy(pts).to(d), torch.from_numpy(mask).to(d)
        qq = torch.from_numpy(q).to(d)
        fps = pointnet.farthest_point_sample(p[..., :3], m, 128)
        idx, valid = pointnet.ball_query(qq, p[..., :3], m, 2.0, 16)
        pooled = pointnet.group_and_pool(
            qq, p[..., :3], p[..., 3:], idx, valid,
            lambda x: torch.relu(x @ w.to(d)))
        out[str(d)] = [t.cpu() for t in (fps, idx, valid, pooled)]
    cpu, card = out["cpu"], out[str(dev)]
    for a, b in zip(cpu[:3], card[:3]):
        assert torch.equal(a, b)
    assert cpu[2].any() and not cpu[2].all()
    scale = 1.0 + cpu[3].abs().max().item()
    assert (card[3] - cpu[3]).abs().max().item() <= 1e-5 * scale


def test_oracle_engine_on_the_card_matches_the_cpu_and_the_columns(dev):
    """The voxel oracle (ops/sparse_conv.py) on the card: its sites and
    tables equal the CPU's exactly, its subm and strided convs within
    1e-5 of the CPU's and of the column engine's on the card (TF32 off),
    and SecondRefEncoder's BEV within 1e-5 of the CPU's."""
    from heal_tpu_torch.models.layers import init_weights
    from heal_tpu_torch.models.second import SecondRefEncoder
    from heal_tpu_torch.ops import column_conv as cc
    from heal_tpu_torch.ops import sparse_conv as sc

    rng = np.random.RandomState(1)
    lr, vs = (0.0, 0.0, 0.0, 6.4, 6.4, 3.2), (0.2, 0.2, 0.2)
    pts = np.concatenate([rng.uniform(0, 6.4, (4000, 3)),
                          rng.uniform(0, 1, (4000, 1))], 1).astype(np.float32)
    mask = rng.uniform(size=4000) < 0.9
    gen = torch.Generator().manual_seed(0)
    w1 = 0.3 * torch.randn((27, 4, 8), generator=gen)
    w2 = 0.3 * torch.randn((27, 8, 6), generator=gen)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for d in ("cpu", dev):
            p, m = torch.from_numpy(pts).to(d), torch.from_numpy(mask).to(d)
            sp = sc.voxelize_points(p, m, lr, vs, 4000)
            sp = dict(sp, feats=sc.subm_conv(sp, w1.to(d)))
            sites = sc.downsample_sites(sp, 16000)
            o = sc.strided_conv(sp, sites, w2.to(d))
            out[str(d)] = (sp, sites, o, sc.neighbor_table(sp))
        (a, sa, oa, ta), (b, sb, ob, tb) = out["cpu"], out[str(dev)]
        for k in ("keys", "coords", "valid"):
            assert torch.equal(a[k], b[k].cpu()) and torch.equal(
                sa[k], sb[k].cpu())
        assert torch.equal(ta, tb.cpu())
        _close(b["feats"], a["feats"].to(dev), torch.float32)
        _close(ob, oa.to(dev), torch.float32)
        p, m = torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)
        cols = cc.voxelize_columns(p[None], m[None], lr, vs, 4000)
        cols = dict(cols, feats=cc.subm_conv(cols, w1.to(dev)))
        cols2 = cc.strided_conv(cols, cc.downsample_columns(cols, 16000),
                                w2.to(dev))
        assert int(cols2["occ"].sum()) == int(sb["valid"].sum())
        _close(cc.to_dense_bev(cols2)[0], sc.to_dense_bev(sb, ob),
               torch.float32)
        # the encoder on 40 z layers (its conv_out leaves 2 of them)
        lr3, vs3 = (0.0, 0.0, -3.0, 6.4, 6.4, 1.0), (0.2, 0.2, 0.1)
        enc = init_weights(SecondRefEncoder(vs3, lr3, (4000, 8000, 4000,
                                                       2000, 1000)),
                           torch.Generator().manual_seed(0)).eval()
        pts3 = pts - np.array([0.0, 0.0, 3.0, 0.0], np.float32)
        x = torch.from_numpy(pts3)[None], torch.from_numpy(mask)[None]
        with torch.no_grad():
            want = enc(*x)
            got = enc.to(dev)(x[0].to(dev), x[1].to(dev))
        assert want.shape == (1, 4, 4, 256) and want.abs().max() > 0
        _close(got, want.to(dev), torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def test_transplanted_flagship_launches_1_and_15(dev):
    """The flagship (heal_tpu/configs/opv2v_m1_pyramid.yaml) with a seeded
    synthetic opencood checkpoint transplanted in (utils/transplant.py),
    loaded strictly, one frame f32 and bf16: kernel 1 once and kernel 2
    15 times a frame, kernel 4 never; heads finite."""
    import os

    from heal_tpu_torch.tools.inference import (build_weights, device_frames,
                                                run_inference)
    from heal_tpu_torch.tools.train import load_config
    from heal_tpu_torch.utils.transplant import (
        synthetic_reference, transplant_heter_pyramid_collab)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(repo, "heal_tpu", "configs",
                                   "opv2v_m1_pyramid.yaml"))
    cfg["fusion"]["args"]["num_scenes_test"] = 1
    model = build_weights(cfg, seed=0)
    sd = model.state_dict()
    model.load_state_dict(transplant_heter_pyramid_collab(
        synthetic_reference(sd, seed=0), sd, cfg["model"]["args"]),
        strict=True)
    model = model.to(dev)
    frames = device_frames(cfg, dev, 1)
    k1, k2 = _launches("kernel1.launches"), _launches("kernel2.launches")
    k4 = _launches("kernel4.launches")
    for dtype in (torch.float32, torch.bfloat16):
        got = run_inference(cfg=cfg, device=dev, dtype=dtype,
                            model=model.to(dtype), frames=frames,
                            collect_heads=True)
        assert all(torch.isfinite(t).all() for h in got["heads"]
                   for t in h.values())
    assert _launches("kernel1.launches") - k1 == 2
    assert _launches("kernel2.launches") - k2 == 30
    assert _launches("kernel4.launches") == k4


# ----------------------------------------------------------- kernel 3
# kernel 3 against its plain version: 32 f32 ulps of the layer's largest
# output. Each conv output sums 27*Cin products in another order than the
# nine cuBLAS products and their adds (a few ulps of the sum), and
# LayerNorm scales those by 1/std, at most 1/sqrt(eps) = 31.6 (eps 1e-3);
# chip_smoke's alliance frame reads up to 5.5 ulps
K3_TOL = 32 * 2.0 ** -23
# each published (Cin, Cout, strided) at the z layers of its level(s)
K3_SHAPES = [(4, 16, False, 40), (16, 32, True, 40), (32, 32, False, 20),
             (32, 64, True, 20), (64, 64, False, 10), (64, 64, False, 5),
             (64, 64, True, 10)]
# active columns an agent offers (capacity 600 at the input, 400 out)
K3_CASES = {"four_empty_slots": [450, 0, 0, 0, 0],
            "agent_without_columns": [0, 300],
            "full_capacity": [1500, 900],
            "partly_filled": [100, 350, 599]}


def _k3_inputs(dev, cin, strided, z, actives, seed):
    """Column-engine inputs on a (z, 64, 64) grid: each agent's active
    cells drawn at random (its first ``vc`` kept, in key order, as the
    engine keeps them), random occupancy and features; the level's table
    and, for a strided layer, its output columns (``downsample_columns``,
    capacity 400)."""
    from heal_tpu_torch.ops import column_conv as cc

    rng = np.random.default_rng(seed)
    h = w = 64
    vc = 600
    ckeys = np.full((len(actives), vc), cc.INVALID, np.int32)
    for a, n in enumerate(actives):
        keys = np.sort(rng.choice(h * w, n, replace=False))[:vc]
        ckeys[a, :len(keys)] = keys
    ck = torch.from_numpy(ckeys).to(dev)
    valid = ck != cc.INVALID
    kk = torch.where(valid, ck, 0)
    coords2 = torch.where(valid[..., None],
                          torch.stack([kk // w, kk % w], -1), 0)
    occ = torch.from_numpy(rng.random((len(actives), vc, z)) < 0.25).to(
        dev) & valid[..., None]
    feats = torch.from_numpy(rng.normal(
        size=(len(actives), vc, z, cin)).astype(np.float32)).to(dev)
    cols = {"ckeys": ck, "coords2": coords2.int(), "cvalid": valid,
            "occ": occ, "feats": feats * occ[..., None], "grid": (z, h, w)}
    if not strided:
        return cols, cc.column_table(cols), None
    out = cc.downsample_columns(cols, 400)
    return cols, cc.strided_table(cols, out), out


def _k3_params(dev, cin, cout, seed):
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn((27, cin, cout), generator=gen) * (2.0 / (27 * cin)) ** .5
    scale = 0.5 + torch.rand(cout, generator=gen)
    bias = 0.3 * torch.randn(cout, generator=gen)
    return w.to(dev), scale.to(dev), bias.to(dev)


@pytest.mark.parametrize("case", K3_CASES)
@pytest.mark.parametrize("cin,cout,strided,z", K3_SHAPES,
                         ids=[f"{a}_{b}_{'s2' if s else 'subm'}_z{z}"
                              for a, b, s, z in K3_SHAPES])
def test_column_conv_kernel_matches_plain(dev, cin, cout, strided, z, case):
    """One launch of kernel 3 per call, the plain layer's values (K3_TOL),
    its output occupancy exactly, zeros at every unoccupied voxel and in
    the columns past an agent's valid prefix, and the same bits from two
    calls."""
    from heal_tpu_torch.ops import column_conv as cc

    cols, table, out = _k3_inputs(dev, cin, strided, z, K3_CASES[case],
                                  cin + cout + z)
    args = (cols, table, *_k3_params(dev, cin, cout, z), 1e-3)
    with torch.no_grad():
        before = _launches("kernel3.launches")
        got = cc.column_conv_layer(*args, out_cols=out)
        assert _launches("kernel3.launches") == before + 1
        again = cc.column_conv_layer(*args, out_cols=out)
        want = cc.column_conv_layer_plain(*args, out_cols=out)
    torch.cuda.synchronize()
    assert got["feats"].shape == want["feats"].shape
    assert torch.equal(got["occ"], want["occ"])
    scale = want["feats"].abs().max().item()
    err = (got["feats"] - want["feats"]).abs().max().item()
    assert err <= K3_TOL * scale, (err, scale)
    off = ~got["occ"]
    assert not got["feats"][off].any() and not want["feats"][off].any()
    assert torch.equal(got["feats"], again["feats"])
    if case != "agent_without_columns":
        assert scale > 0.5 and int(got["occ"].sum()) > 100


# one kernel-3 call traced in a process of its own (argv: the saved
# arguments)
_FRESH_TRACE = """
import json, sys, torch
from heal_tpu_torch.kernels.measure import device_kernels
from heal_tpu_torch.ops import column_conv as cc
args, kwargs = torch.load(sys.argv[1], weights_only=False)
with torch.no_grad():
    cc.column_conv_layer(*args, **kwargs)
    print(json.dumps(device_kernels(
        lambda: cc.column_conv_layer(*args, **kwargs))))
"""


def test_column_conv_kernel_is_one_kernel_and_never_syncs(dev, tmp_path):
    """One call puts exactly one kernel on the card, under sync debug
    mode "error". CUPTI now and then hands back empty traces for the rest
    of a process (as chip_smoke.py meets it): an empty trace is taken
    again in a fresh process, held to the same count."""
    import json
    import os
    import subprocess
    import sys

    from heal_tpu_torch.ops import column_conv as cc

    cols, table, out = _k3_inputs(dev, 32, True, 20, [450, 0, 0, 0, 0], 1)
    args = (cols, table, *_k3_params(dev, 32, 64, 1), 1e-3)
    with torch.no_grad():
        cc.column_conv_layer(*args, out_cols=out)  # built and loaded
        launched = device_kernels(
            lambda: cc.column_conv_layer(*args, out_cols=out))
    if not launched:
        path = tmp_path / "args.pt"
        torch.save((args, {"out_cols": out}), path)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        proc = subprocess.run(
            [sys.executable, "-c", _FRESH_TRACE, str(path)], cwd=root,
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=root))
        assert proc.returncode == 0, proc.stderr[-2000:]
        launched = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(launched) == 1 and "column_conv" in launched[0], launched


def test_column_conv_takes_the_plain_version_under_grad_and_in_bf16(dev):
    """Under a gradient or in bf16 ``column_conv_layer`` on the card
    returns the plain version's output and counts no launch; at a width
    kernel 3 is not built for, or with an int64 table, it raises."""
    from heal_tpu_torch.ops import column_conv as cc

    cols, table, _ = _k3_inputs(dev, 32, False, 20, [300, 40], 2)
    w, scale, bias = _k3_params(dev, 32, 32, 2)
    before = _launches("kernel3.launches")
    wg = w.clone().requires_grad_()
    got = cc.column_conv_layer(cols, table, wg, scale, bias, 1e-3)["feats"]
    assert got.requires_grad
    _close(got.detach(), cc.column_conv_layer_plain(
        cols, table, w, scale, bias, 1e-3)["feats"], torch.float32)
    with torch.no_grad():
        c16 = dict(cols, feats=cols["feats"].to(torch.bfloat16))
        _close(cc.column_conv_layer(c16, table, w, scale, bias, 1e-3)[
            "feats"], cc.column_conv_layer_plain(
            c16, table, w, scale, bias, 1e-3)["feats"], torch.bfloat16)
        with pytest.raises(ValueError, match="no kernel"):
            cc.column_conv_layer(cols, table, w[:, :, :16].contiguous(),
                                 scale[:16], bias[:16], 1e-3)
        with pytest.raises(ValueError):
            cc.column_conv_layer(cols, table.long(), w, scale, bias, 1e-3)
    assert _launches("kernel3.launches") == before


def test_layer_on_the_card_raises_at_unbuilt_widths(dev):
    """An f32 eval ColumnConvLayer on the card at a width kernel 3 is not
    built for reaches the wrapper and raises (no quiet plain path); under
    a gradient it takes the plain version, as training does."""
    from heal_tpu_torch.models.second import ColumnConvLayer

    cols, table, _ = _k3_inputs(dev, 8, False, 10, [300, 40], 4)
    layer = ColumnConvLayer(8, 16).to(dev)
    torch.nn.init.normal_(layer.kernel, 0, 0.3)
    before = _launches("kernel3.launches")
    with torch.no_grad(), pytest.raises(ValueError, match="no kernel"):
        layer(cols, table)
    got = layer(cols, table)
    assert got["feats"].shape == (2, 600, 10, 16) and got["feats"].any()
    assert _launches("kernel3.launches") == before


def test_second_encoder_on_the_card_matches_the_cpu(dev):
    """SECOND at the published channels (16/32/64/64) on a 40 z-layer
    grid, 5 slots with one real agent: the card's forward (kernel 3 at
    each of its 10 conv layers, none of which counts a host sync) within
    1e-5 of the CPU's, which takes the plain layers; under a gradient the
    card takes the layers' own path (no launch)."""
    from heal_tpu_torch.models.layers import init_weights
    from heal_tpu_torch.models.second import ColumnConvLayer, SecondEncoder

    rng = np.random.default_rng(3)
    lr, vs = (-6.4, -6.4, -3.0, 6.4, 6.4, 1.0), (0.1, 0.1, 0.1)
    pts = np.zeros((5, 8000, 4), np.float32)
    pts[0, :, :3] = rng.uniform(lr[:3], lr[3:], (8000, 3))
    pts[0, :, 2] = np.minimum(pts[0, :, 2], rng.uniform(-3, -1, 8000))
    pts[0, :, 3] = rng.uniform(0, 1, 8000)
    mask = np.zeros((5, 8000), bool)
    mask[0] = True
    enc = init_weights(SecondEncoder(vs, lr, max_voxels=(3000, 2000, 1500,
                                                         1000)),
                       torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(pts), torch.from_numpy(mask)
    with torch.no_grad():
        want = enc(*x)
    enc = enc.to(dev)
    xd = x[0].to(dev), x[1].to(dev)
    in_convs = []

    def watch(layer):
        def pre(*_):
            in_convs.append(dict(trace.counters()))

        def post(*_):
            now = trace.counters()
            in_convs[-1] = {k: now.get(k, 0) - v
                            for k, v in in_convs[-1].items()
                            if k.startswith("host_sync")}
        layer.register_forward_pre_hook(pre)
        layer.register_forward_hook(post)

    for m in enc.modules():
        if isinstance(m, ColumnConvLayer):
            watch(m)
    with torch.no_grad():
        before = _launches("kernel3.launches")
        got = enc(*xd)
        assert _launches("kernel3.launches") == before + 10
    torch.cuda.synchronize()
    assert len(in_convs) == 10 and not any(any(c.values()) for c in in_convs)
    assert want.shape == (5, 16, 16, 320) and want.abs().max() > 0.5
    assert not want[1:].any() and not got[1:].any()
    _close(got, want.to(dev), torch.float32)
    before = _launches("kernel3.launches")
    enc(*xd).sum().backward()
    assert _launches("kernel3.launches") == before
    assert enc.VmapSecondStack_0.conv_input.kernel.grad.abs().sum() > 0


# ----------------------------------------------------------- kernel 4
# every (window, head width) kernel 4 is built for: the published block's
# branches at the v2xvit.serve cell's map (5 slots of 128 x 256, heads x
# head width 256), the others at a (2, 32, 64) map with 8 heads; each
# also on one slot of one window row with 5 heads, so that the last block
# holds fewer (window, head) units than it takes
K4_CELL = {(4, 16): 16, (8, 32): 8, (16, 64): 4}
K4_PAIRS = sorted(KERNEL4_SHAPES)


def _k4_inputs(dev, n, h, w, heads, ws, dh, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((n, h, w, 3, heads, dh), generator=gen, device=dev)
    table = torch.randn(((2 * ws - 1) ** 2, heads), generator=gen,
                        device=dev)
    return qkv, table


@pytest.mark.parametrize("shape", ["main", "ragged"])
@pytest.mark.parametrize("ws,dh", K4_PAIRS,
                         ids=[f"w{ws}_dh{dh}" for ws, dh in K4_PAIRS])
def test_window_attention_kernel_matches_plain(dev, ws, dh, shape):
    """One launch of kernel 4 a call, the plain version's values (f32,
    within 1e-5 of 1 + the largest output: the same sums in another order
    and the softmax normalised once at the end), and the same bits from
    two calls."""
    from heal_tpu_torch.ops import window_attention as wa

    if shape == "ragged":
        n, h, w, heads = 1, ws, 3 * ws, 5
    elif (ws, dh) in K4_CELL:
        n, h, w, heads = 5, 128, 256, K4_CELL[ws, dh]
    else:
        n, h, w, heads = 2, 32, 64, 8
    qkv, table = _k4_inputs(dev, n, h, w, heads, ws, dh, ws + dh)
    with torch.inference_mode():
        before = _launches("kernel4.launches")
        got = wa.window_attention(qkv, table, ws, heads, dh)
        assert _launches("kernel4.launches") == before + 1
        again = wa.window_attention(qkv, table, ws, heads, dh)
        want = wa.window_attention_plain(qkv, table, ws, heads, dh)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n, h, w, heads * dh)
    _close(got, want, torch.float32)
    assert torch.equal(got, again)


def test_window_attention_takes_the_plain_version_under_grad_and_in_bf16(
        dev):
    """Another window or head width, or a map that is not whole windows:
    ``window_attention`` on the card raises. In bf16 or under a gradient
    it returns the plain version's output. No launch is counted."""
    from heal_tpu_torch.ops import window_attention as wa

    qkv, table = _k4_inputs(dev, 1, 24, 24, 4, 6, 16, 0)
    before = _launches("kernel4.launches")
    with torch.no_grad():
        with pytest.raises(ValueError, match="no kernel"):
            wa.window_attention(qkv, table, 6, 4, 16)
        qkv, table = _k4_inputs(dev, 1, 32, 32, 4, 16, 32, 0)
        with pytest.raises(ValueError, match="no kernel"):
            wa.window_attention(qkv, table, 16, 4, 32)
        qkv, table = _k4_inputs(dev, 1, 24, 24, 4, 4, 24, 0)
        with pytest.raises(ValueError, match="no kernel"):
            wa.window_attention(qkv, table, 4, 4, 24)
        qkv, table = _k4_inputs(dev, 1, 20, 24, 4, 8, 16, 0)
        with pytest.raises(ValueError, match="does not divide"):
            wa.window_attention(qkv, table, 8, 4, 16)
        qkv, table = _k4_inputs(dev, 1, 16, 16, 4, 4, 16, 0)
        q16 = qkv.to(torch.bfloat16)
        _close(wa.window_attention(q16, table, 4, 4, 16),
               wa.window_attention_plain(q16, table, 4, 4, 16),
               torch.bfloat16)
    tg = table.clone().requires_grad_()
    got = wa.window_attention(qkv, tg, 4, 4, 16)
    assert got.requires_grad
    _close(got.detach(), wa.window_attention_plain(qkv, table, 4, 4, 16),
           torch.float32)
    assert _launches("kernel4.launches") == before


def test_published_v2xvit_launches_kernel_4_nine_times(dev):
    """V2X-ViT's published fusion block (benchmark/configs/v2xvit.json: 3
    layers, windows 4 / 8 / 16) at C 256, seeded weights, one f32 eval
    forward on the card: kernel 4 once an MSwin branch of each layer (9),
    the output within 1e-4 of the same module's on the CPU (the plain
    version; the maps are not whole 16-windows, so MSwin pads); in
    training and in bf16 no launch. A flagship frame launches none
    (test_transplanted_flagship_launches_1_and_15)."""
    import json
    import os

    from heal_tpu_torch.models.fuse import build_fusion
    from heal_tpu_torch.models.layers import init_weights, rng_streams

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "benchmark", "configs", "v2xvit.json")) as f:
        args = json.load(f)["hypes"]["model"]["args"]["v2xvit"]
    fusion = init_weights(build_fusion("v2xvit", args, 256, 3),
                          torch.Generator().manual_seed(0)).eval()
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((1, 3, 24, 40, 256), generator=gen)
    aff = torch.eye(2, 3).expand(1, 3, 3, 2, 3).contiguous()
    mask = torch.tensor([[True, True, False]])
    types = torch.tensor([[0, 1, 0]])
    with torch.no_grad():
        want = fusion(x, aff, mask, types)
    fusion = fusion.to(dev)
    xd = (x.to(dev), aff.to(dev), mask.to(dev), types.to(dev))
    before = _launches("kernel4.launches")
    with torch.inference_mode():
        got = fusion(*xd)
    assert _launches("kernel4.launches") == before + 9
    err = (got.cpu() - want).abs().max() / (1 + want.abs().max())
    assert err <= 1e-4, err
    before = _launches("kernel4.launches")
    with rng_streams(fusion, dropout=torch.Generator(dev).manual_seed(0)):
        fusion.train()(*xd).sum().backward()
    with torch.inference_mode():
        fusion.eval().to(torch.bfloat16)(xd[0].to(torch.bfloat16), *xd[1:])
    assert _launches("kernel4.launches") == before
