"""Shared building blocks (torch, NCHW; ``channels_last`` memory is fine).

Counterparts of heal_tpu/models/layers.py. Modules, parameters and
buffers carry the flax module paths and leaf names (``ConvNormAct_0``,
``kernel``, ``Norm_0.scale``, ``Norm_0.mean`` ...), so the bridge
(utils/bridge.py) maps a flax variables tree onto them key by key.
Unlike flax, a torch module needs its input width when it is built, so
every constructor takes ``cin``.

``Norm`` follows ``module.train()``: batch statistics (and the flax
running-average update) in train mode, running statistics in eval mode.
The fusion zoo's flax primitives live here too: ``LayerNorm``, ``gelu``,
``Dropout`` with its random stream (``rng_streams``), and
``MultiHeadDotProductAttention`` with flax's projection layouts.
The TPU-only s2d width pack of heal_tpu (layers.py:380-393) is not
ported; the reference for it is the dense path JAX takes off the TPU.
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

# flax-style BatchNorm momentum, heal_tpu/models/layers.py:30
DEFAULT_BN_MOMENTUM = 0.9


def parse_norm(kind: str) -> tuple[str, float | None]:
    """"batch" -> ("batch", None); "batch@0.99" -> ("batch", 0.99)."""
    if "@" in kind:
        base, mom = kind.split("@", 1)
        return base, float(mom)
    return kind, None


def _kernel_param(cout: int, cin: int, k: int) -> nn.Parameter:
    # values come from init_weights or the bridge
    return nn.Parameter(torch.empty(cout, cin, k, k))


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups, epsilon)`` over the channel axis 1
    of an NCHW (or (N, C, ...)) input: per sample and group, the moments
    over the group's channels and every spatial position, in f32 (f64 for
    f64 inputs), the variance E[x^2] - E[x]^2 clamped at 0, as flax's
    fast variance; then the per-channel ``scale`` and ``bias``."""

    def __init__(self, channels: int, num_groups: int, epsilon: float):
        super().__init__()
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        g = xf.reshape(n, self.num_groups, -1)
        m = g.mean(-1)
        v = torch.clamp((g * g).mean(-1) - m * m, min=0.0)
        per = c // self.num_groups
        shape = (n, c) + (1,) * (x.dim() - 2)
        mean = m.repeat_interleave(per, 1).reshape(shape)
        # flax's order: mul = rsqrt(var + eps) * scale, then (x - mean) * mul
        mul = (torch.rsqrt(v + self.epsilon).repeat_interleave(per, 1)
               * self.scale.to(xf.dtype)).reshape(shape)
        y = (xf - mean) * mul + self.bias.to(xf.dtype).reshape(
            (1, c) + (1,) * (x.dim() - 2))
        return y.to(x.dtype)


def group_count(channels: int) -> int:
    """heal_tpu's group count: min(32, C), halved until it divides C."""
    groups = min(32, channels)
    while channels % groups:
        groups //= 2
    return groups


class Norm(nn.Module):
    """BatchNorm (heal_tpu/models/layers.py ``Norm``), group norm or
    "none".

    Train mode normalises with the batch moments over N, H and W, taken
    in f32 (f64 for f64 inputs) and kept in the graph (JAX differentiates through them):
    m = mean(x), v = mean(x^2) - m^2, the biased variance. Padded agent
    slots count, as in JAX. The running buffers (f32 whatever the weights'
    dtype) then move as flax moves them, running = mom*running +
    (1-mom)*batch, with mom from the "batch@m" suffix, else
    DEFAULT_BN_MOMENTUM. Eval mode uses the running statistics. eps
    differs by call site, as in JAX: 1e-5 inside the resblocks, 1e-3 in
    the deblocks. "group" is flax's ``GroupNorm`` under ``GroupNorm_0``
    (``group_count`` groups, eps 1e-3 at every call site, layers.py
    :91-97): per sample, no running statistics, the same in both modes.

    The moments come from Σx, Σx² and the element count. Under a device
    mesh (``mesh``, set by parallel/sharding.shard_state) those sums are
    all-reduced over every rank inside the graph (:func:`world_sum`), so
    the moments are the global batch's, as GSPMD takes them, padded agent
    slots included; ranks holding the same input (agent or model
    replicas) add equal numerators and counts, which leaves the ratios
    unchanged. With no mesh no collective runs.
    """

    mesh = None

    def __init__(self, channels: int, kind: str = "batch",
                 epsilon: float = 1e-3):
        super().__init__()
        self.kind, mom = parse_norm(kind)
        self.momentum = DEFAULT_BN_MOMENTUM if mom is None else mom
        self.epsilon = epsilon
        if self.kind == "batch":
            self.scale = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
            self.register_buffer("mean", torch.zeros(channels))
            self.register_buffer("var", torch.ones(channels))
        elif self.kind == "group":
            self.GroupNorm_0 = GroupNorm(channels, group_count(channels),
                                         1e-3)
        elif self.kind != "none":
            raise ValueError(f"unknown norm kind {kind!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "none":
            return x
        if self.kind == "group":
            return self.GroupNorm_0(x)
        if self.training:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            axes = [0] + list(range(2, x.dim()))
            c = xf.shape[1]
            s = world_sum(self.mesh, torch.cat([
                xf.sum(axes), (xf * xf).sum(axes),
                xf.new_full((1,), xf.numel() // c)]))
            m = s[:c] / s[-1]
            v = s[c:2 * c] / s[-1] - m * m
            update_running(self.mean, m, self.momentum)
            update_running(self.var, v, self.momentum)
        else:
            m, v = self.mean, self.var
        mul = self.scale * torch.rsqrt(v.to(self.scale.dtype) + self.epsilon)
        add = self.bias - m.to(self.scale.dtype) * mul
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return (x * mul.reshape(shape) + add.reshape(shape)).to(x.dtype)


def channels_last(model: nn.Module) -> nn.Module:
    """``model.to(memory_format=torch.channels_last)`` for its 4-D
    parameters and buffers (the convolution kernels), in place. torch's
    own conversion refuses V2X-ViT's 5-D relation matrices."""
    for t in (*model.parameters(), *model.buffers()):
        if t.dim() == 4:
            t.data = t.data.contiguous(memory_format=torch.channels_last)
    return model


def world_sum(mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over every rank of ``mesh`` inside the graph
    (parallel/sharding.Mesh.world_sum); ``x`` itself with no mesh."""
    return x if mesh is None else mesh.world_sum(x)


def update_running(buf: torch.Tensor, batch: torch.Tensor, mom: float):
    """buf <- mom*buf + (1-mom)*batch, in place, outside the graph."""
    with torch.no_grad():
        buf.mul_(mom).add_(batch.to(buf.dtype), alpha=1.0 - mom)


class Conv(nn.Module):
    """flax ``nn.Conv`` counterpart: biased conv, symmetric padding;
    ``groups`` is flax's ``feature_group_count`` (the HWIO kernel
    (k, k, cin/groups, features) bridges to (features, cin/groups, k, k)).

    Column-parallel layers (``column_dims``: the kernel's out-channel dim,
    the output's channel dim): under a model axis ``tp`` is the mesh, the
    kernel and bias hold this rank's out channels and the output is
    gathered over the model group (parallel/sharding.shard_state)."""

    column_dims = (0, 1)
    tp = None

    def __init__(self, cin: int, features: int, kernel: int = 1,
                 stride: int = 1, padding: int | None = None,
                 groups: int = 1):
        super().__init__()
        self.stride = stride
        self.padding = (kernel - 1) // 2 if padding is None else padding
        self.groups = groups
        self.kernel = _kernel_param(features, cin // groups, kernel)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.kernel, self.bias, self.stride, self.padding,
                     groups=self.groups)
        return y if self.tp is None else self.tp.gather(y, 1, "model")


class Dense(nn.Module):
    """flax ``nn.Dense`` over the last axis; the kernel keeps flax's
    (in, out) layout, so the bridge copies it as it is. Column-parallel
    as ``Conv``."""

    column_dims = (-1, -1)
    tp = None

    def __init__(self, cin: int, features: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cin, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        y = y if self.bias is None else y + self.bias
        return y if self.tp is None else self.tp.gather(y, -1, "model")


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


@contextlib.contextmanager
def rng_streams(model: nn.Module, **generators: torch.Generator):
    """flax's ``rngs``: while the block runs, each module of ``model``
    that draws from a named stream (its ``stream`` attribute: "dropout",
    "comm") takes the generator of that name as its ``generator``; the
    others, and all of them after the block, have none."""
    takers = [m for m in model.modules()
              if getattr(m, "stream", None) in generators]
    for m in takers:
        m.generator = generators[m.stream]
    try:
        yield
    finally:
        for m in takers:
            m.generator = None


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate, deterministic=not train)``: in train mode
    it zeroes with probability ``rate`` and scales by 1/(1-rate), the keep
    mask drawn from the ``dropout`` stream (:func:`rng_streams`); like
    flax, it raises in train mode without one. The masks are not JAX's
    bits. It draws the mask of the global input (the data ranks' dim-0
    rows stacked: the input itself with no mesh) and, under a device mesh
    (``mesh``), keeps this rank's rows, so the ranks together draw what
    one process draws (the input's dim 0 is the batch, outermost)."""

    stream = "dropout"
    mesh = None

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        gen = self.generator
        if gen is None:
            raise RuntimeError("Dropout in train mode needs a 'dropout' "
                               "stream (layers.rng_streams)")
        keep = 1.0 - self.rate
        data = 1 if self.mesh is None else self.mesh.shape["data"]
        mask = torch.rand((x.shape[0] * data,) + x.shape[1:], generator=gen,
                          device=x.device) < keep
        if self.mesh is not None:
            mask = self.mesh.take(mask, 0, "data")
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


class DenseGeneral(nn.Module):
    """The query / key / value / out projections of flax's
    ``MultiHeadDotProductAttention``, in flax's layouts: with ``cin`` it
    maps (..., cin) -> (..., heads, dh), kernel (cin, heads, dh) and bias
    (heads, dh); with ``cout`` it maps (..., heads, dh) -> (..., cout),
    kernel (heads, dh, cout) and bias (cout,). Column-parallel as
    ``Conv`` over the kernel's last dim."""

    column_dims = (-1, -1)
    tp = None

    def __init__(self, heads: int, dh: int, *, cin: int | None = None,
                 cout: int | None = None):
        super().__init__()
        if (cin is None) == (cout is None):
            raise ValueError("give exactly one of cin and cout")
        self.split = cin is not None
        if self.split:
            self.kernel = nn.Parameter(torch.empty(cin, heads, dh))
            self.bias = nn.Parameter(torch.zeros(heads, dh))
            self.flax_init = {"kernel": ("lecun", cin)}
        else:
            self.kernel = nn.Parameter(torch.empty(heads, dh, cout))
            self.bias = nn.Parameter(torch.zeros(cout))
            self.flax_init = {"kernel": ("lecun", heads * dh)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.split:
            c, m, d = self.kernel.shape
            y = (x @ self.kernel.reshape(c, m * d)).unflatten(
                -1, (m, d)) + self.bias
        else:
            m, d, c = self.kernel.shape
            y = x.flatten(-2) @ self.kernel.reshape(m * d, c) + self.bias
        return y if self.tp is None else self.tp.gather(y, -1, "model")


# logits of one chunk of _BiasedAttention: ~256 MB
_ATTN_CHUNK_BYTES = 1 << 28


class _BiasedAttention(torch.autograd.Function):
    """softmax(q k^T + bias) v over chunks of the batch, keeping only its
    inputs for the backward, which recomputes each chunk's probabilities
    (the plain autograd graph keeps every pass's (N, M, T, T)
    probabilities: CoBEVT's six window passes over a batch of 2 at the
    published width would hold ~40 GB). q (N, M, Tq, dh), already scaled;
    k, v (N, M, Tk, dh); bias (1 or N, M, Tq, Tk)."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        n, m, tq, _ = q.shape
        per = m * tq * k.shape[2] * q.element_size()
        chunk = max(1, _ATTN_CHUNK_BYTES // per)
        out = q.new_empty(q.shape[:3] + v.shape[3:])
        for s in range(0, n, chunk):
            sl = slice(s, s + chunk)
            b = bias if bias.shape[0] == 1 else bias[sl]
            attn = torch.softmax(q[sl] @ k[sl].transpose(-1, -2) + b, dim=-1)
            out[sl] = attn @ v[sl]
        ctx.save_for_backward(q, k, v, bias)
        ctx.chunk = chunk
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        dbias = torch.zeros(bias.shape, dtype=torch.float32,
                            device=bias.device)
        for s in range(0, q.shape[0], ctx.chunk):
            sl = slice(s, s + ctx.chunk)
            b = bias if bias.shape[0] == 1 else bias[sl]
            attn = torch.softmax(q[sl] @ k[sl].transpose(-1, -2) + b, dim=-1)
            dv[sl] = attn.transpose(-1, -2) @ g[sl]
            da = g[sl] @ v[sl].transpose(-1, -2)
            dl = attn * (da - (da * attn).sum(-1, keepdim=True))
            dq[sl] = dl @ k[sl]
            dk[sl] = dl.transpose(-1, -2) @ q[sl]
            if bias.shape[0] == 1:
                dbias += dl.sum(0, keepdim=True, dtype=torch.float32)
            else:
                dbias[sl] = dl
        return dq, dk, dv, dbias.to(bias.dtype)


def dot_product_attention(q, k, v, bias=None, mask=None):
    """flax ``nn.dot_product_attention``: q (..., Tq, M, dh), k and v
    (..., Tk, M, dh); q is scaled by 1/sqrt(dh) before the product, the
    float ``bias`` (broadcast to (..., M, Tq, Tk)) added, logits where the
    boolean ``mask`` is False set to the dtype's most negative value, a
    softmax over Tk -> (..., Tq, M, dh). With a bias and no mask (the
    window attentions of CoBEVT and V2X-ViT) it runs in chunks that keep
    no probabilities for the backward (:class:`_BiasedAttention`)."""
    q = q / math.sqrt(q.shape[-1])
    if bias is not None and mask is None:
        lead = q.shape[:-3]
        qh, kh, vh = (t.reshape((-1,) + t.shape[-3:]).transpose(1, 2)
                      for t in (q, k, v))
        b = bias.reshape((-1,) + bias.shape[-3:]) if bias.dim() > 3 \
            else bias[None]
        out = _BiasedAttention.apply(qh, kh, vh, b.to(q.dtype))
        return out.transpose(1, 2).reshape(lead + out.shape[2:3]
                                           + out.shape[1:2] + out.shape[3:])
    logits = torch.einsum("...qhd,...khd->...hqk", q, k)
    if bias is not None:
        logits = logits + bias
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    attn = torch.softmax(logits, dim=-1)
    return torch.einsum("...hqk,...khd->...qhd", attn, v)


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention(num_heads, qkv_features=dim)``
    with the output width of the input: inputs (..., T, C), ``mask``
    boolean broadcast to (..., M, Tq, Tk), ``bias`` float likewise (the
    ``attention_fn`` with a bias of CoBEVT and V2X-ViT)."""

    def __init__(self, cin: int, heads: int, dim: int | None = None):
        super().__init__()
        dim = cin if dim is None else dim
        if dim % heads:
            raise ValueError(f"qkv width {dim} is not a multiple of {heads} "
                             "heads")
        dh = dim // heads
        self.query = DenseGeneral(heads, dh, cin=cin)
        self.key = DenseGeneral(heads, dh, cin=cin)
        self.value = DenseGeneral(heads, dh, cin=cin)
        self.out = DenseGeneral(heads, dh, cout=cin)

    def forward(self, inputs_q, inputs_k=None, inputs_v=None, mask=None,
                bias=None):
        inputs_k = inputs_q if inputs_k is None else inputs_k
        inputs_v = inputs_k if inputs_v is None else inputs_v
        x = dot_product_attention(self.query(inputs_q), self.key(inputs_k),
                                  self.value(inputs_v), bias=bias, mask=mask)
        return self.out(x)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: eps 1e-6 (torch's
    default is 1e-5), statistics in f32 with the variance as
    E[x^2] - E[x]^2, as flax takes them."""

    def __init__(self, channels: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.epsilon)


def layer_norm(x: torch.Tensor, scale, bias, epsilon: float) -> torch.Tensor:
    """:class:`LayerNorm`'s forward on given parameters."""
    xf = x.float()
    m = xf.mean(-1, keepdim=True)
    v = torch.clamp((xf * xf).mean(-1, keepdim=True) - m * m, min=0.0)
    mul = torch.rsqrt(v + epsilon) * scale.float()
    return ((xf - m) * mul + bias.float()).to(x.dtype)


class ConvNormAct(nn.Module):
    """Bias-free conv (torch-style symmetric padding (k-1)//2) -> Norm ->
    ReLU. The grouped and biased variants of the flax module have no caller
    on the ported path. Column-parallel as ``Conv``."""

    column_dims = (0, 1)
    tp = None

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, norm: str = "batch", act: bool = True,
                 norm_eps: float = 1e-3):
        super().__init__()
        self.stride = stride
        self.padding = (kernel - 1) // 2
        self.act = act
        self.kernel = _kernel_param(features, cin, kernel)
        self.Norm_0 = Norm(features, norm, epsilon=norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.kernel, None, self.stride, self.padding)
        if self.tp is not None:
            y = self.tp.gather(y, 1, "model")
        x = self.Norm_0(y)
        return F.relu(x) if self.act else x


class _PixelShuffleDeconv(nn.Module):
    """kernel == stride transposed conv (flax ``ConvTranspose_0``).

    The parameter is kept in torch's ConvTranspose2d layout
    (I, O, s, s); the bridge flips flax's (s, s, I, O) kernel spatially
    (flax's tap at output (i*s+di, j*s+dj) is kern[s-1-di, s-1-dj]).
    Column-parallel as ``Conv`` (the out channels are dim 1).
    """

    column_dims = (1, 1)
    tp = None

    def __init__(self, cin: int, features: int, stride: int):
        super().__init__()
        self.stride = stride
        self.kernel = nn.Parameter(torch.empty(cin, features, stride, stride))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x, self.kernel, stride=self.stride)
        return y if self.tp is None else self.tp.gather(y, 1, "model")


class SameConv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides=(s, s), use_bias=False)``
    under its SAME padding: ceil(H / s) outputs, the missing
    (ceil(H / s) - 1) * s + k - H rows (and columns) padded total // 2
    before and the rest after, so a stride that does not divide H pads
    at the end first. Column-parallel as ``Conv``."""

    column_dims = (0, 1)
    tp = None

    def __init__(self, cin: int, features: int, kernel: int,
                 stride: int = 1):
        super().__init__()
        self.stride = stride
        self.kernel = _kernel_param(features, cin, kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, k = self.stride, self.kernel.shape[-1]
        pads = []
        for size in (x.shape[-1], x.shape[-2]):  # F.pad's order: W, H
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        y = F.conv2d(F.pad(x, pads), self.kernel, None, s)
        return y if self.tp is None else self.tp.gather(y, 1, "model")


class DeconvNormAct(nn.Module):
    """Transposed-conv upsample + norm + relu (the deblocks). A stride
    below 1 is a strided-down deblock (heal_tpu layers.py:239-245): a
    bias-free s x s conv of stride s = round(1 / stride), ``Conv_0``."""

    def __init__(self, cin: int, features: int, stride: float,
                 norm: str = "batch"):
        super().__init__()
        if stride >= 1:
            self.ConvTranspose_0 = _PixelShuffleDeconv(cin, features,
                                                       int(stride))
        else:
            s = int(round(1 / stride))
            self.Conv_0 = SameConv(cin, features, s, s)
        self.Norm_0 = Norm(features, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = getattr(self, "ConvTranspose_0", None)
        x = up(x) if up is not None else self.Conv_0(x)
        return F.relu(self.Norm_0(x))


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1,
                 norm: str = "batch"):
        super().__init__()
        # eps 1e-5: the reference resblocks use bare nn.BatchNorm2d
        self.ConvNormAct_0 = ConvNormAct(cin, planes, 3, stride, norm=norm,
                                         norm_eps=1e-5)
        self.ConvNormAct_1 = ConvNormAct(planes, planes, 3, 1, norm=norm,
                                         act=False, norm_eps=1e-5)
        self.ConvNormAct_2 = None
        if stride != 1 or cin != planes:
            self.ConvNormAct_2 = ConvNormAct(cin, planes, 1, stride,
                                             norm=norm, act=False,
                                             norm_eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.ConvNormAct_1(self.ConvNormAct_0(x))
        identity = x if self.ConvNormAct_2 is None else self.ConvNormAct_2(x)
        return F.relu(out + identity)


class BottleneckX(nn.Module):
    """Bottleneck with expansion 1 whose 3x3 is DENSE at width
    ``int(planes * wpg / 64) * 32`` (heal_tpu layers.py:339), not grouped."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 width_per_group: int = 4, norm: str = "batch"):
        super().__init__()
        width = int(planes * (width_per_group / 64.0)) * 32
        self.ConvNormAct_0 = ConvNormAct(cin, width, 1, 1, norm=norm,
                                         norm_eps=1e-5)
        self.ConvNormAct_1 = ConvNormAct(width, width, 3, stride, norm=norm,
                                         norm_eps=1e-5)
        self.ConvNormAct_2 = ConvNormAct(width, planes, 1, 1, norm=norm,
                                         act=False, norm_eps=1e-5)
        self.ConvNormAct_3 = None
        if stride != 1 or cin != planes:
            self.ConvNormAct_3 = ConvNormAct(cin, planes, 1, stride,
                                             norm=norm, act=False,
                                             norm_eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.ConvNormAct_2(self.ConvNormAct_1(self.ConvNormAct_0(x)))
        identity = x if self.ConvNormAct_3 is None else self.ConvNormAct_3(x)
        return F.relu(out + identity)


class ResNetStage(nn.Module):
    """``blocks`` BasicBlocks (or BottleneckX), stride on the first."""

    def __init__(self, cin: int, planes: int, blocks: int, stride: int = 1,
                 norm: str = "batch", bottleneck_x: bool = False,
                 width_per_group: int = 4):
        super().__init__()
        for i in range(blocks):
            s = stride if i == 0 else 1
            c = cin if i == 0 else planes
            if bottleneck_x:
                block = BottleneckX(c, planes, stride=s,
                                    width_per_group=width_per_group,
                                    norm=norm)
            else:
                block = BasicBlock(c, planes, stride=s, norm=norm)
            name = "BottleneckX" if bottleneck_x else "BasicBlock"
            self.add_module(f"{name}_{i}", block)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.children():
            x = block(x)
        return x


class DownsampleConv(nn.Module):
    """Shrink header: per stage Conv(k, s, biased) -> ReLU -> Conv(3x3,
    biased) -> ReLU, no normalization (ref downsample_conv.DoubleConv)."""

    def __init__(self, cin: int, dims: Sequence[int], kernels: Sequence[int],
                 strides: Sequence[int], paddings: Sequence[int] = ()):
        super().__init__()
        pads = tuple(paddings) or tuple((k - 1) // 2 for k in kernels)
        self.n_stages = len(dims)
        for i, (dim, k, s, p) in enumerate(zip(dims, kernels, strides, pads)):
            self.add_module(f"conv_{i}a", Conv(cin, dim, k, s, p))
            self.add_module(f"conv_{i}b", Conv(dim, dim, 3, 1, 1))
            cin = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_stages):
            x = F.relu(getattr(self, f"conv_{i}a")(x))
            x = F.relu(getattr(self, f"conv_{i}b")(x))
        return x


class NaiveCompressor(nn.Module):
    """Channel autoencoder for bandwidth compression (ref
    sub_modules/naive_compress.py): three 3x3 ``ConvNormAct``, to
    ``input_dim // compress_ratio`` channels and back to ``input_dim``."""

    def __init__(self, input_dim: int, compress_ratio: int,
                 norm: str = "batch"):
        super().__init__()
        hidden = input_dim // compress_ratio
        self.ConvNormAct_0 = ConvNormAct(input_dim, hidden, 3, 1, norm=norm)
        self.ConvNormAct_1 = ConvNormAct(hidden, input_dim, 3, 1, norm=norm)
        self.ConvNormAct_2 = ConvNormAct(input_dim, input_dim, 3, 1,
                                         norm=norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ConvNormAct_2(self.ConvNormAct_1(self.ConvNormAct_0(x)))


class AutoEncoder(nn.Module):
    """Spatial and channel autoencoder compressor (ref
    sub_modules/auto_encoder.py): ``layer_num`` encoder stages, each
    halving H, W (a stride-2 conv) and the channels (``enc_{i}a``,
    ``enc_{i}b``), then mirrored transposed-conv stages restoring both
    (``dec_{i}a``, ``dec_{i}b``, i counting down)."""

    def __init__(self, feature_num: int, layer_num: int = 1,
                 norm: str = "batch"):
        super().__init__()
        self.layer_num = layer_num
        c = feature_num
        for i in range(layer_num):
            self.add_module(f"enc_{i}a", ConvNormAct(c, c, 3, 2, norm=norm))
            self.add_module(f"enc_{i}b", ConvNormAct(c, c // 2, 3, 1,
                                                     norm=norm))
            c //= 2
        for i in range(layer_num - 1, -1, -1):
            self.add_module(f"dec_{i}a", DeconvNormAct(c, 2 * c, 2,
                                                       norm=norm))
            self.add_module(f"dec_{i}b", ConvNormAct(2 * c, 2 * c, 3, 1,
                                                     norm=norm))
            c *= 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.layer_num):
            x = getattr(self, f"enc_{i}b")(getattr(self, f"enc_{i}a")(x))
        for i in range(self.layer_num - 1, -1, -1):
            x = getattr(self, f"dec_{i}b")(getattr(self, f"dec_{i}a")(x))
        return x


def _init_rule(p: torch.Tensor, rule: tuple, generator: torch.Generator):
    """A module's own flax initializer for one parameter: ("lecun",
    fan_in), ("xavier", fan_in, fan_out), ("normal", std) or
    ("constant", value)."""
    kind = rule[0]
    if kind == "constant":
        p.fill_(rule[1])
    elif kind == "lecun":
        std = (1.0 / rule[1]) ** 0.5 / 0.87962566103423978
        nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
    elif kind == "xavier":
        limit = (6.0 / (rule[1] + rule[2])) ** 0.5
        nn.init.uniform_(p, -limit, limit, generator=generator)
    elif kind == "normal":
        nn.init.normal_(p, 0.0, rule[1], generator=generator)
    else:
        raise ValueError(f"unknown init rule {rule!r}")


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init in flax's defaults: lecun-normal kernels
    (truncated at 2 std; SECOND's (27, Cin, Cout) kernels he-normal, as
    heal_tpu second.py:49), zero biases, unit BN and LayerNorm scales,
    ConvNeXt's layer scale ``gamma`` 1e-6 (heal_tpu aligner.py:52-54; zero
    would make each block the identity and stop its gradient); running
    mean 0 and variance 1. Every kernel is a parameter named ``*kernel``.
    A module's ``flax_init`` (leaf -> rule of :func:`_init_rule`) takes
    precedence: the attention projections, typed denses, relation
    matrices and relative-position tables of the fusion zoo, and
    CenterPoint's heatmap bias."""
    with torch.no_grad():
        for mname, module in model.named_modules():
            rules = getattr(module, "flax_init", {})
            for leaf, p in module.named_parameters(recurse=False):
                name = f"{mname}.{leaf}" if mname else leaf
                if leaf in rules:
                    _init_rule(p, rules[leaf], generator)
                elif leaf.endswith("kernel"):
                    gain = 1.0
                    if p.dim() == 2:  # (in, out) dense kernel
                        fan_in = p.shape[0]
                    elif p.dim() == 3:  # SECOND's (27, Cin, Cout): he-normal
                        fan_in, gain = p.shape[0] * p.shape[1], 2.0
                    elif name.endswith("ConvTranspose_0.kernel"):
                        # (I, O, s, s)
                        fan_in = p.shape[0] * p.shape[2] * p.shape[3]
                    else:  # (O, I, kh, kw) or VoxelNet's (O, I, kd, kh, kw)
                        fan_in = math.prod(p.shape[1:])
                    std = (gain / fan_in) ** 0.5 / 0.87962566103423978
                    nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                          generator=generator)
                elif leaf in ("scale", "bn_scale"):
                    p.fill_(1.0)
                elif leaf == "gamma":
                    p.fill_(1e-6)
                else:
                    p.zero_()
        for name, buf in model.named_buffers():
            leaf = name.rsplit(".", 1)[-1]
            buf.fill_(1.0 if leaf in ("var", "bn_var") else 0.0)
    return model
