"""Shared building blocks (torch, NCHW; ``channels_last`` memory is fine).

Counterparts of heal_tpu/models/layers.py. Modules, parameters and
buffers carry the flax module paths and leaf names (``ConvNormAct_0``,
``kernel``, ``Norm_0.scale``, ``Norm_0.mean`` ...), so the bridge
(utils/bridge.py) maps a flax variables tree onto them key by key.
Unlike flax, a torch module needs its input width when it is built, so
every constructor takes ``cin``.

``Norm`` follows ``module.train()``: batch statistics (and the flax
running-average update) in train mode, running statistics in eval mode.
The TPU-only s2d width pack of heal_tpu (layers.py:380-393) is not
ported; the reference for it is the dense path JAX takes off the TPU.
"""
from __future__ import annotations

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


class Norm(nn.Module):
    """BatchNorm (heal_tpu/models/layers.py ``Norm``), or "none".

    Train mode normalises with the batch moments over N, H and W, taken
    in f32 (f64 for f64 inputs) and kept in the graph (JAX differentiates through them):
    m = mean(x), v = mean(x^2) - m^2, the biased variance. Padded agent
    slots count, as in JAX. The running buffers (f32 whatever the weights'
    dtype) then move as flax moves them, running = mom*running +
    (1-mom)*batch, with mom from the "batch@m" suffix, else
    DEFAULT_BN_MOMENTUM. Eval mode uses the running statistics. eps
    differs by call site, as in JAX: 1e-5 inside the resblocks, 1e-3 in
    the deblocks.
    """

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
        elif self.kind != "none":
            raise NotImplementedError(
                f"norm kind {kind!r} is not ported (batch, none)"
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "none":
            return x
        if self.training:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            axes = [0] + list(range(2, x.dim()))
            m = xf.mean(axes)
            v = (xf * xf).mean(axes) - m * m
            update_running(self.mean, m, self.momentum)
            update_running(self.var, v, self.momentum)
        else:
            m, v = self.mean, self.var
        mul = self.scale * torch.rsqrt(v.to(self.scale.dtype) + self.epsilon)
        add = self.bias - m.to(self.scale.dtype) * mul
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return (x * mul.reshape(shape) + add.reshape(shape)).to(x.dtype)


def update_running(buf: torch.Tensor, batch: torch.Tensor, mom: float):
    """buf <- mom*buf + (1-mom)*batch, in place, outside the graph."""
    with torch.no_grad():
        buf.mul_(mom).add_(batch.to(buf.dtype), alpha=1.0 - mom)


class Conv(nn.Module):
    """flax ``nn.Conv`` counterpart: biased conv, symmetric padding;
    ``groups`` is flax's ``feature_group_count`` (the HWIO kernel
    (k, k, cin/groups, features) bridges to (features, cin/groups, k, k))."""

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
        return F.conv2d(x, self.kernel, self.bias, self.stride, self.padding,
                        groups=self.groups)


class Dense(nn.Module):
    """flax ``nn.Dense`` over the last axis; the kernel keeps flax's
    (in, out) layout, so the bridge copies it as it is."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cin, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


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
        xf = x.float()
        m = xf.mean(-1, keepdim=True)
        v = torch.clamp((xf * xf).mean(-1, keepdim=True) - m * m, min=0.0)
        mul = torch.rsqrt(v + self.epsilon) * self.scale.float()
        return ((xf - m) * mul + self.bias.float()).to(x.dtype)


class ConvNormAct(nn.Module):
    """Bias-free conv (torch-style symmetric padding (k-1)//2) -> Norm ->
    ReLU. The grouped and biased variants of the flax module have no caller
    on the ported path."""

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
        x = self.Norm_0(F.conv2d(x, self.kernel, None, self.stride,
                                 self.padding))
        return F.relu(x) if self.act else x


class _PixelShuffleDeconv(nn.Module):
    """kernel == stride transposed conv (flax ``ConvTranspose_0``).

    The parameter is kept in torch's ConvTranspose2d layout
    (I, O, s, s); the bridge flips flax's (s, s, I, O) kernel spatially
    (flax's tap at output (i*s+di, j*s+dj) is kern[s-1-di, s-1-dj]).
    """

    def __init__(self, cin: int, features: int, stride: int):
        super().__init__()
        self.stride = stride
        self.kernel = nn.Parameter(torch.empty(cin, features, stride, stride))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.kernel, stride=self.stride)


class DeconvNormAct(nn.Module):
    """Transposed-conv upsample + norm + relu (the deblocks)."""

    def __init__(self, cin: int, features: int, stride: int,
                 norm: str = "batch"):
        super().__init__()
        if stride < 1:
            raise NotImplementedError("strided-down deblocks are not ported")
        self.ConvTranspose_0 = _PixelShuffleDeconv(cin, features, int(stride))
        self.Norm_0 = Norm(features, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.Norm_0(self.ConvTranspose_0(x)))


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


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init in flax's defaults: lecun-normal kernels
    (truncated at 2 std; SECOND's (27, Cin, Cout) kernels he-normal, as
    heal_tpu second.py:49), zero biases, unit BN and LayerNorm scales,
    ConvNeXt's layer scale ``gamma`` 1e-6 (heal_tpu aligner.py:52-54; zero
    would make each block the identity and stop its gradient); running
    mean 0 and variance 1. Every kernel is a parameter named ``*kernel``."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("kernel"):
                gain = 1.0
                if p.dim() == 2:  # (in, out) dense kernel
                    fan_in = p.shape[0]
                elif p.dim() == 3:  # SECOND's (27, Cin, Cout): he-normal
                    fan_in, gain = p.shape[0] * p.shape[1], 2.0
                elif name.endswith("ConvTranspose_0.kernel"):  # (I, O, s, s)
                    fan_in = p.shape[0] * p.shape[2] * p.shape[3]
                else:  # (O, I, kh, kw)
                    fan_in = p.shape[1] * p.shape[2] * p.shape[3]
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
