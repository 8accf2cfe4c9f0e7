"""V2X-ViT's window attention (heal_tpu_torch/ops/window_attention.py,
models/fuse/v2xvit.py WindowAttention and MSwin) on the CPU.

The reference is WindowAttention's forward as it stood before the fused
projection and kernel 4, kept here: the map partitioned into windows, the
q, k and v projections of each window, the (heads, T, T) bias gathered
through ``rel_idx`` and ``MultiHeadDotProductAttention``, the windows
merged back. The new forward (one q / k / v product, then
``window_attention_plain``) is held to it at the published branches
(windows 4 / 8 / 16 with 16 x 16, 8 x 32, 4 x 64 heads) and at the flat
form (8 heads of C / 8), with gradients; MSwin on maps that are not a
whole number of windows, whose padded tokens take the projections' biases
as keys; and the op's choice: the CPU and a wanted gradient take the
plain version and launch nothing. Kernel 4 itself runs on the card only
(tests/test_torch_kernels_cuda.py).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from heal_tpu_torch import trace
from heal_tpu_torch.models.fuse import v2xvit
from heal_tpu_torch.models.fuse.v2xvit import MSwin, WindowAttention
from heal_tpu_torch.models.layers import init_weights
from heal_tpu_torch.ops import window_attention as wa

torch.set_num_threads(1)
_PLAIN = wa.window_attention_plain
_KERNEL = wa.window_attention
# the new forward against the old composition: the same products in
# another grouping (one (3 heads dh)-wide product for three), f32
TOL = 1e-6

# (dim, window, heads, dim_head): the published branches at C 256, the
# flat form's 8 heads of C / 8 at C 64 and 256
BRANCHES = [(256, 4, 16, 16), (256, 8, 8, 32), (256, 16, 4, 64),
            (64, 2, 8, 8), (256, 8, 8, 32)]
IDS = [f"c{c}_w{ws}_{m}x{dh}" for c, ws, m, dh in BRANCHES]
IDS[-1] += "_flat"


def old_window_attention(mod: WindowAttention, x):
    """WindowAttention's forward before kernel 4: partition, project each
    window, gather the bias, attend, merge."""
    n, h, w, c = x.shape
    ws = mod.window
    x = x.reshape(n, h // ws, ws, w // ws, ws, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)
    t = ws * ws
    bias = mod.rel_pos_bias[mod.rel_idx].reshape(t, t, mod.heads)
    bias = bias.permute(2, 0, 1)[None].to(x.dtype)
    attn = mod.Dropout_0(mod.MultiHeadDotProductAttention_0(x, bias=bias))
    attn = attn.reshape(n, h // ws, w // ws, ws, ws, c)
    return attn.permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, c)


def old_mswin(mod: MSwin, x):
    """MSwin's forward before kernel 4: every branch padded (a zero pad
    when the map is whole windows) and run by the old composition."""
    n, h, w, c = x.shape
    outs = []
    for ws in mod.windows:
        xp = F.pad(x, (0, 0, 0, (-w) % ws, 0, (-h) % ws))
        outs.append(old_window_attention(getattr(mod, f"win{ws}"), xp)
                    [:, :h, :w])
    return mod.split_attn(outs)


def seeded(module, seed: int):
    """``module`` with seeded weights; biases and the table at unit
    spread, so the bias terms move the softmax."""
    gen = torch.Generator().manual_seed(seed)
    module = init_weights(module, gen)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 1.0 if "rel_pos" in name else 0.3,
                          generator=gen)
    return module


def _map(n, h, w, c, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((n, h, w, c)).astype(
        np.float32))


def _rel(a, b):
    return ((a - b).abs().max() / (1.0 + b.abs().max())).item()


@pytest.mark.parametrize("c,ws,m,dh", BRANCHES, ids=IDS)
def test_window_attention_equals_the_old_composition(c, ws, m, dh):
    """The new forward (fused projection, window_attention_plain, out
    projection) against the old composition: eval outputs in f32; every
    parameter's gradient in f64 (in f32 both paths sum the value bias's
    gradient over the map's tokens with cancellation, each ~3e-5 from
    f64 in its own order)."""
    mod = seeded(WindowAttention(c, ws, heads=m, dim_head=dh), ws + m)
    x = _map(2, 2 * ws, 3 * ws, c, ws)
    with torch.no_grad():
        assert _rel(mod.eval()(x), old_window_attention(mod, x)) <= TOL
    mod.train().double()
    x = x.double()
    grads = []
    for fn in (mod, lambda y: old_window_attention(mod, y)):
        mod.zero_grad()
        out = fn(x)
        (out * torch.linspace(-1, 1, out.numel(), dtype=out.dtype)
         .reshape(out.shape)).sum().backward()
        grads.append({k: p.grad.clone() for k, p in mod.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for k in grads[0]:
        assert grads[0][k].abs().max() > 0, k
        assert _rel(grads[0][k], grads[1][k]) <= 1e-12, k


@pytest.mark.parametrize("c,ws,m,dh", BRANCHES, ids=IDS)
def test_window_attention_plain_is_the_attention_core(c, ws, m, dh):
    """window_attention_plain on the fused projection equals the old
    composition's attention before its out projection, its index made
    on the table's device when none is given."""
    mod = seeded(WindowAttention(c, ws, heads=m, dim_head=dh), 7 * ws)
    x = _map(3, ws, 2 * ws, c, 3)
    mha = mod.MultiHeadDotProductAttention_0
    with torch.no_grad():
        qkv = mod._qkv(x)
        assert qkv.shape == (3, ws, 2 * ws, 3, m, dh)
        for i, part in enumerate((mha.query, mha.key, mha.value)):
            assert _rel(qkv[..., i, :, :], part(x)) <= TOL
        got = wa.window_attention_plain(qkv, mod.rel_pos_bias, ws, m, dh)
        given = wa.window_attention_plain(qkv, mod.rel_pos_bias, ws, m, dh,
                                          mod.rel_idx)
        calls = []
        saved = mha.out.forward
        mha.out.forward = lambda y: calls.append(y) or saved(y)
        try:
            old_window_attention(mod, x)
        finally:
            del mha.out.forward
    want = calls[0].reshape(3, 1, 2, ws, ws, m * dh).permute(
        0, 1, 3, 2, 4, 5).reshape(3, ws, 2 * ws, m * dh)
    assert torch.equal(got, given)
    assert _rel(got, want) <= TOL


def test_window_rel_index_is_the_offset_table():
    """The (dy, dx) offset of token j from token i, as an index into the
    (2 ws - 1)^2 table."""
    for ws in (2, 4, 8, 16):
        idx = wa.window_rel_index(ws).numpy()
        coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                      indexing="ij"), -1).reshape(-1, 2)
        for i, j in ((0, 0), (0, ws * ws - 1), (ws * ws - 1, 0), (ws, 1)):
            dy, dx = coords[j] - coords[i] + ws - 1
            assert idx[i, j] == dy * (2 * ws - 1) + dx
        assert idx.min() == 0 and idx.max() == (2 * ws - 1) ** 2 - 1
        assert idx.dtype == np.int64


@pytest.mark.parametrize("hw", [(11, 20), (16, 13), (16, 16)],
                         ids=["both_ragged", "w_ragged", "whole"])
def test_mswin_pads_as_before(hw, monkeypatch):
    """MSwin on a map that is not a whole number of windows: the padded
    tokens (zeros, so the projections' biases) enter every window they
    fall in as keys and values, exactly as the always-padded forward had
    them; a branch whose window divides the map pads nothing."""
    c = 32
    mod = seeded(MSwin(c, windows=(2, 4, 8), heads=[4, 2, 1],
                       dim_head=[8, 16, 32]), sum(hw)).eval()
    x = _map(2, *hw, c, 5)
    with torch.no_grad():
        want = old_mswin(mod, x)
    pads = []
    saved = F.pad
    monkeypatch.setattr(v2xvit.F, "pad",
                        lambda *a, **k: pads.append(a[1]) or saved(*a, **k))
    with torch.no_grad():
        got = mod(x)
    monkeypatch.undo()
    assert _rel(got, want) <= TOL
    need = [(0, 0, 0, (-hw[1]) % ws, 0, (-hw[0]) % ws) for ws in (2, 4, 8)
            if hw[0] % ws or hw[1] % ws]
    assert pads == need


def test_the_cpu_and_a_gradient_take_the_plain_version(monkeypatch):
    """On the CPU, in eval and in training, WindowAttention makes one call
    of ``window_attention`` a forward, and the op takes
    window_attention_plain; kernel4.launches stays 0. Under a gradient the
    op returns the plain version's output, and its gradient is the plain
    version's."""
    mod = seeded(WindowAttention(64, 4, heads=16, dim_head=16), 1)
    x = _map(1, 8, 8, 64, 2)
    plain, op = [], []
    monkeypatch.setattr(wa, "window_attention_plain",
                        lambda *a, **k: plain.append(1) or _PLAIN(*a, **k))
    monkeypatch.setattr(wa, "window_attention",
                        lambda *a, **k: op.append(1) or _KERNEL(*a, **k))
    trace.clear()
    with torch.no_grad():
        mod.eval()(x)
    with torch.inference_mode():
        mod(x)
    mod.train()(x).sum().backward()
    assert len(plain) == len(op) == 3
    assert mod.rel_pos_bias.grad is not None and mod.rel_pos_bias.grad.any()
    monkeypatch.undo()
    qkv = mod._qkv(x)
    table = mod.rel_pos_bias
    assert qkv.requires_grad and table.requires_grad
    got = wa.window_attention(qkv, table, 4, 16, 16)
    want = wa.window_attention_plain(qkv, table, 4, 16, 16)
    assert torch.equal(got, want)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        tuple(got.shape)).astype(np.float32))
    for a, b in zip(torch.autograd.grad(got, (qkv, table), g),
                    torch.autograd.grad(want, (qkv, table), g)):
        assert torch.equal(a, b) and a.any()
    with torch.no_grad():
        assert torch.equal(
            wa.window_attention(qkv, table, 4, 16, 16),
            wa.window_attention_plain(qkv, table, 4, 16, 16))
    assert trace.counters().get("kernel4.launches", 0) == 0


def test_the_offset_index_is_read_on_the_plain_path():
    """The plain path reads the module's ``rel_idx``: the index
    transposed (every offset negated) moves the output."""
    mod = seeded(WindowAttention(32, 4, heads=4, dim_head=8), 3).eval()
    x = _map(1, 8, 8, 32, 4)
    with torch.no_grad():
        base = mod(x)
        mod.rel_idx = mod.rel_idx.reshape(16, 16).t().reshape(-1)
        assert _rel(mod(x), base) > 1e-3


@pytest.mark.parametrize("method", ["v2xvit", "cobevt"])
def test_seeded_init_keeps_the_offset_indices(method):
    """layers.init_weights resets the running statistics alone: the window
    attentions' offset indices (``rel_idx``, non-persistent, so no
    checkpoint restores them) stay as the modules built them."""
    from heal_tpu_torch.models.fuse import build_fusion

    args = {"depth": 1, "num_types": 2} if method == "v2xvit" else {}
    built = build_fusion(method, dict(args), 32, 3)
    want = {k: b.clone() for k, b in built.named_buffers()
            if k.endswith("rel_idx")}
    assert want
    seeded_ = init_weights(built, torch.Generator().manual_seed(0))
    for k, b in seeded_.named_buffers():
        if k.endswith("rel_idx"):
            assert torch.equal(b, want[k]) and b.max() > 0, k


@pytest.mark.parametrize("call", ["op", "module"])
def test_the_profiler_counts_kernel_4_apart(call):
    """tools/profiler.kernels_apart takes kernel 4's op out of the
    FlopCounterMode and counts its two products apart, as many as the
    counter finds in the plain version; through a V2X-ViT WindowAttention
    module's ``flop_count`` the counter's FLOPs and the kernels'
    operations add up to the counter's total without the split."""
    from torch.utils.flop_counter import FlopCounterMode

    from heal_tpu_torch.tools.profiler import flop_count, kernels_apart

    if call == "module":
        mod = seeded(WindowAttention(64, 4, heads=16, dim_head=16), 5)
        x = _map(1, 8, 8, 64, 6)
        with torch.no_grad(), FlopCounterMode(display=False) as whole:
            mod.eval()(x)
        got = flop_count(mod, x)
        assert got["kernel_ops"]["window_attention"] > 0
        assert got["counter_flops"] + sum(got["kernel_ops"].values()) == (
            whole.get_total_flops())
        assert wa.window_attention.__name__ == "window_attention"
        return
    qkv, table = torch.randn(2, 8, 16, 3, 4, 8), torch.randn(49, 4)
    with torch.no_grad(), FlopCounterMode(display=False) as plain:
        wa.window_attention_plain(qkv, table, 4, 4, 8)
    ops = dict.fromkeys(("pillar_tables", "shift_rows", "column_conv",
                         "window_attention"), 0)
    with torch.no_grad(), kernels_apart(ops), \
            FlopCounterMode(display=False) as apart:
        wa.window_attention(qkv, table, 4, 4, 8)
    assert apart.get_total_flops() == 0
    assert ops["window_attention"] == plain.get_total_flops() > 0
    assert wa.window_attention.__name__ == "window_attention"
