"""Building blocks of the detector, NHWC in and out.

Port of ``yoloret_tpu/nn/layers.py`` for inference. Every module takes
and returns NHWC tensors, as the JAX package does; a kxk convolution
runs ``F.conv2d`` on the NCHW view of the same storage (channels-last
strides, so no copy is made), and a 1x1 convolution is ``F.linear`` over
the channel axis. Parameters stay float32 and are cast to the input's
dtype at use, as Flax does with ``dtype=bfloat16`` modules.

Inference only: BatchNorm runs folded into the conv before it, with
running statistics. Parameter names follow the Flax tree (``conv``,
``bn``, ``dwconv``, ``depthwise``, ``pointwise``, ``expand``, ``se``,
``project``), so that ``yoloret_tpu_torch.weights.from_flax`` maps one
onto the other.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Act = Optional[Callable[[torch.Tensor], torch.Tensor]]


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def make_divisible(v: float, divisor: int = 8, min_value: Optional[int] = None) -> int:
    """Channel rounding of the MobileNetV2 width multiplier."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of TF/Flax ``"SAME"`` along one axis.

    The total is what makes the output ``ceil(size / stride)`` long, and
    the odd pixel goes to the high side: a 3x3 stride-2 conv on an even
    input pads (0, 1), not PyTorch's symmetric 1."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d_same(
    x: torch.Tensor,  # [B, H, W, Cin]
    weight: torch.Tensor,  # [Cout, Cin / groups, kh, kw]
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """NHWC convolution with ``"SAME"`` padding; returns NHWC."""
    weight = weight.to(x.dtype)
    bias = None if bias is None else bias.to(x.dtype)
    cout, _, kh, kw = weight.shape
    if kh == kw == 1 and stride == 1 and groups == 1:
        return F.linear(x, weight.reshape(cout, -1), bias)
    ph = same_padding(x.shape[1], kh, stride)
    pw = same_padding(x.shape[2], kw, stride)
    xc = x.permute(0, 3, 1, 2)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        y = F.conv2d(xc, weight, bias, stride, (ph[0], pw[0]), 1, groups)
    else:
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
        y = F.conv2d(xc, weight, bias, stride, 0, 1, groups)
    return y.permute(0, 2, 3, 1)


def conv_kernel_init(weight: torch.Tensor, generator: torch.Generator) -> None:
    """Fan-out normal init, ``sqrt(2 / (kh * kw * out))`` (the JAX
    package's ``conv_kernel_init``), in place."""
    out_ch, _, kh, kw = weight.shape
    std = (2.0 / (kh * kw * out_ch)) ** 0.5
    with torch.no_grad():
        weight.copy_(torch.randn(weight.shape, generator=generator) * std)


class Conv2dSame(nn.Module):
    """Bias-optional NHWC conv with ``"SAME"`` padding (Flax ``nn.Conv``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1,
                 stride: int = 1, groups: int = 1, bias: bool = False):
        super().__init__()
        self.stride = stride
        self.groups = groups
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_same(x, self.weight, self.bias, self.stride, self.groups)


class BatchNorm(nn.Module):
    """Inference BatchNorm statistics and affine over the channel axis,
    eps 1e-3. It is not called on activations: the conv before it takes
    it folded in (``fold_bn``)."""

    def __init__(self, ch: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))


def fold_bn(weight: torch.Tensor, bn: BatchNorm) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold inference BatchNorm into a conv: (weight * s, t) with
    s = gamma / sqrt(var + eps), t = beta - mean * s, per output channel
    (dim 0 of ``weight``), float32."""
    s = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return weight * s.reshape(-1, *([1] * (weight.dim() - 1))), bn.bias - bn.running_mean * s


def conv_bn(x: torch.Tensor, conv: Conv2dSame, bn: BatchNorm) -> torch.Tensor:
    """bn(conv(x)) as one conv with the BN folded into kernel and bias:
    the activation is read and written once instead of three more times
    for the normalisation (equal up to float rounding)."""
    w, t = fold_bn(conv.weight, bn)
    return conv2d_same(x, w, t, conv.stride, conv.groups)


class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm + optional activation."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 1,
                 stride: int = 1, act: Act = relu6):
        super().__init__()
        self.act = act
        self.conv = Conv2dSame(in_ch, features, kernel_size, stride)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_bn(x, self.conv, self.bn)
        return x if self.act is None else self.act(x)


class DepthwiseConvBN(nn.Module):
    """Depthwise kxk conv (no bias) + BatchNorm + optional activation."""

    def __init__(self, ch: int, kernel_size: int, stride: int = 1, act: Act = relu6):
        super().__init__()
        self.act = act
        self.dwconv = Conv2dSame(ch, ch, kernel_size, stride, groups=ch)
        self.bn = BatchNorm(ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_bn(x, self.dwconv, self.bn)
        return x if self.act is None else self.act(x)


class SeparableConvBN(nn.Module):
    """Depthwise kxk + BN + ReLU6, then pointwise 1x1 + BN + ReLU6."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 5, stride: int = 1):
        super().__init__()
        self.depthwise = DepthwiseConvBN(in_ch, kernel_size, stride, act=relu6)
        self.pointwise = ConvBN(in_ch, features, 1, act=relu6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


class WeightedSum(nn.Module):
    """Learned scalar-weighted sum of N same-shape tensors (the RFCR
    fusion weights, initialised to ones)."""

    def __init__(self, num_inputs: int = 4):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(num_inputs))

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(xs) != self.alpha.numel():
            raise ValueError(f"expected {self.alpha.numel()} inputs, got {len(xs)}")
        alpha = self.alpha.to(xs[0].dtype)
        out = alpha[0] * xs[0]
        for i in range(1, len(xs)):
            out = out + alpha[i] * xs[i]
        return out


class SqueezeExcite(nn.Module):
    """Global mean -> reduce 1x1 (swish) -> excite 1x1 (sigmoid) ->
    scale. ``reduced`` comes from the block-args input filters."""

    def __init__(self, reduced: int, features: int):
        super().__init__()
        self.reduce = Conv2dSame(features, reduced, bias=True)
        self.excite = Conv2dSame(reduced, features, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(-3, -2), keepdim=True)
        s = torch.sigmoid(self.excite(swish(self.reduce(s))))
        return x * s


class MBConv(nn.Module):
    """EfficientNet mobile inverted bottleneck with SE, inference only:
    expand 1x1 (skipped at expand_ratio 1) -> depthwise kxk (swish) ->
    SE -> project 1x1; residual when stride 1 and in == out filters."""

    def __init__(self, input_filters: int, output_filters: int, kernel_size: int = 3,
                 stride: int = 1, expand_ratio: int = 6, se_ratio: Optional[float] = 0.25,
                 id_skip: bool = True):
        super().__init__()
        filters = input_filters * expand_ratio
        self.residual = id_skip and stride == 1 and input_filters == output_filters
        self.expand = (ConvBN(input_filters, filters, 1, act=swish)
                       if expand_ratio != 1 else None)
        self.depthwise = DepthwiseConvBN(filters, kernel_size, stride, act=swish)
        self.se = (SqueezeExcite(max(1, int(input_filters * se_ratio)), filters)
                   if se_ratio is not None and 0.0 < se_ratio <= 1.0 else None)
        self.project = ConvBN(filters, output_filters, 1, act=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x if self.expand is None else self.expand(x)
        y = self.depthwise(y)
        if self.se is not None:
            y = self.se(y)
        y = self.project(y)
        return y + x if self.residual else y


def maxpool_downsample(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """Max pool with window = stride, VALID padding, NHWC."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), stride, stride)
    return y.permute(0, 2, 3, 1)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample, NHWC."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of every conv kernel with ``conv_kernel_init``; biases,
    BatchNorm and fusion weights keep their constructor values (zeros,
    identity statistics and ones), as the Flax initialisers give."""
    for m in module.modules():
        if isinstance(m, Conv2dSame):
            conv_kernel_init(m.weight, generator)
