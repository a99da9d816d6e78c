"""Legacy detector bodies, NHWC, inference. Port of
``yoloret_tpu/nn/legacy.py``.

* ``YoloNano`` (EP/PEP/FCA modules) and ``YoloFastest`` (``xl`` for
  Yolo-Fastest-XL) are complete 3-scale bodies: backbone, neck and bias
  heads in one module, returning the standard coarsest-first
  [B, gh, gw, A, 5+C] pyramid in float32, as the JAX bodies do.
* ``SkyNet`` is the single-scale body with the space-to-depth bypass; it
  is not in the detector registry (its one /8 map does not fit the
  3-scale pipeline), as in the JAX package.

Every module takes its input channels, where Flax infers them.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from yoloret_tpu_torch.nn.layers import (
    Conv2dSame,
    ConvBN,
    DepthwiseConvBN,
    SeparableConvBN,
    leaky,
    maxpool_downsample,
    relu6,
    upsample2x,
)


def _split(y: torch.Tensor, num_anchors: int, num_classes: int) -> torch.Tensor:
    b, gh, gw, _ = y.shape
    return y.reshape(b, gh, gw, num_anchors, 5 + num_classes).float()


class _SepConv(nn.Module):
    """3x3 depthwise + BN + ReLU6, then 1x1 + BN + ReLU6, optional stride."""

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.sep = SeparableConvBN(in_ch, features, 3, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.sep(x)


class EP(nn.Module):
    """Expansion-projection block; residual at stride 1 and equal channels."""

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.residual = stride == 1 and in_ch == features
        self.conv = _SepConv(in_ch, features, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv(x)
        return x + out if self.residual else out


class PEP(nn.Module):
    """Projection-expansion-projection block; residual at equal channels."""

    def __init__(self, in_ch: int, features: int, mid: int):
        super().__init__()
        self.residual = in_ch == features
        self.proj = ConvBN(in_ch, mid, 1, act=relu6)
        self.conv = _SepConv(mid, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv(self.proj(x))
        return x + out if self.residual else out


class FCA(nn.Module):
    """Fully-connected channel attention: global mean, dense to C/r
    (ReLU6), dense back to C (sigmoid), scale. The two bias-free dense
    layers are ``nn.Linear``."""

    def __init__(self, ch: int, reduction: int = 8):
        super().__init__()
        self.reduce = nn.Linear(ch, ch // reduction, bias=False)
        self.expand = nn.Linear(ch // reduction, ch, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(-3, -2))
        s = relu6(nn.functional.linear(s, self.reduce.weight.to(x.dtype)))
        s = torch.sigmoid(nn.functional.linear(s, self.expand.weight.to(x.dtype)))
        return x * s[:, None, None, :]


class YoloNano(nn.Module):
    """YOLO-Nano: backbone taps at /8 (150 ch), /16 (325), /32 (469), a
    top-down neck of PEP/EP blocks and bias-free 1x1 heads."""

    def __init__(self, num_classes: int = 20, num_anchors: int = 3):
        super().__init__()
        self.num_classes, self.num_anchors = num_classes, num_anchors
        pred = num_anchors * (5 + num_classes)
        self.stem_a = ConvBN(3, 12, 3, act=relu6)
        self.stem_b = ConvBN(12, 24, 3, stride=2, act=relu6)
        self.p1 = PEP(24, 24, 7)
        self.e1 = EP(24, 70, 2)
        self.p2 = PEP(70, 70, 25)
        self.p3 = PEP(70, 70, 24)
        self.e2 = EP(70, 150, 2)
        self.p4 = PEP(150, 150, 56)
        self.c_mid = ConvBN(150, 150, 1, act=relu6)
        self.fca = FCA(150, 8)
        self.p5 = PEP(150, 150, 73)
        self.p6 = PEP(150, 150, 71)
        self.p7 = PEP(150, 150, 75)
        self.e3 = EP(150, 325, 2)
        self.p8_mids = (132, 124, 141, 140, 137, 135, 133)
        for i, mid in enumerate(self.p8_mids):
            self.add_module(f"p8_{i}", PEP(325, 325, mid))
        self.p9 = PEP(325, 325, 140)
        self.e4 = EP(325, 545, 2)
        self.p10 = PEP(545, 545, 276)
        self.c_down = ConvBN(545, 230, 1, act=relu6)
        self.e5 = EP(230, 489)
        self.p11 = PEP(489, 469, 213)
        # neck (top-down)
        self.n13_a = ConvBN(469, 189, 1, act=relu6)
        self.n13_b = ConvBN(189, 105, 1, act=relu6)
        self.n26_a = PEP(105 + 325, 325, 113)
        self.n26_b = PEP(325, 207, 99)
        self.n26_c = ConvBN(207, 98, 1, act=relu6)
        self.n26_d = ConvBN(98, 47, 1, act=relu6)
        self.n52_a = PEP(47 + 150, 122, 58)
        self.n52_b = PEP(122, 87, 52)
        self.n52_c = PEP(87, 93, 47)
        self.head_52 = Conv2dSame(93, pred)
        self.n26_e = EP(98, 183)
        self.head_26 = Conv2dSame(183, pred)
        self.n13_e = EP(189, 462)
        self.head_13 = Conv2dSame(462, pred)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = self.stem_b(self.stem_a(x))
        x = self.p3(self.p2(self.e1(self.p1(x))))
        x = self.c_mid(self.p4(self.e2(x)))
        x = self.fca(x)
        out52 = self.p7(self.p6(self.p5(x)))  # /8
        x = self.e3(out52)
        for i in range(len(self.p8_mids)):
            x = getattr(self, f"p8_{i}")(x)
        out26 = self.p9(x)  # /16
        x = self.c_down(self.p10(self.e4(out26)))
        out13 = self.p11(self.e5(x))  # /32
        # neck (top-down)
        x1 = self.n13_a(out13)
        x = self.n13_b(x1)
        x = self.n26_b(self.n26_a(torch.cat([upsample2x(x), out26], dim=-1)))
        x2 = self.n26_c(x)
        x = self.n26_d(x2)
        x = torch.cat([upsample2x(x), out52], dim=-1)
        x = self.n52_c(self.n52_b(self.n52_a(x)))
        y3 = self.head_52(x)
        y2 = self.head_26(self.n26_e(x2))
        y1 = self.head_13(self.n13_e(x1))
        return tuple(_split(y, self.num_anchors, self.num_classes) for y in (y1, y2, y3))


class _FastestBlock(nn.Module):
    """Yolo-Fastest inverted bottleneck: expand 1x1 -> depthwise 3x3 ->
    project 1x1, each BN + LeakyReLU(0.1), residual at stride 1 and equal
    channels."""

    def __init__(self, in_ch: int, features: int, exp_features: int, stride: int = 1):
        super().__init__()
        self.residual = stride == 1 and in_ch == features
        self.expand = ConvBN(in_ch, exp_features, 1, act=leaky)
        self.depthwise = DepthwiseConvBN(exp_features, 3, stride, act=leaky)
        self.project = ConvBN(exp_features, features, 1, act=leaky)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.project(self.depthwise(self.expand(x)))
        return x + out if self.residual else out


# (features, expanded features, stride) per block, or a route marker.
_FASTEST_PLANS = {
    False: ((8, 8, 4), [
        (4, 8, 1), (8, 24, 2),
        (8, 32, 1), (8, 32, 1), (8, 32, 2),
        (8, 48, 1), (8, 48, 1), (16, 48, 2),
        (16, 96, 1), (16, 96, 1), (16, 96, 1), (16, 96, 1),
        ("route2",), (24, 96, 2),
        (24, 136, 1), (24, 136, 1), (24, 136, 1), (24, 136, 1),
        ("route1",), (48, 136, 2),
        (48, 224, 1), (48, 224, 1), (48, 224, 1), (48, 224, 1),
        (48, 224, 1),
    ]),
    True: ((16, 16, 8), [
        (8, 16, 1), (16, 48, 2),
        (16, 64, 1), (16, 64, 1), (16, 64, 2),
        (16, 96, 1), (16, 96, 1), (32, 96, 2),
        (32, 192, 1), (32, 192, 1), (32, 192, 1), (32, 192, 1),
        ("route2",), (48, 192, 2),
        (48, 272, 1), (48, 272, 1), (48, 272, 1), (48, 272, 1),
        ("route1",), (96, 272, 2),
        (96, 448, 1), (96, 448, 1), (96, 448, 1), (96, 448, 1),
        (96, 448, 1),
    ]),
}


class YoloFastest(nn.Module):
    """Yolo-Fastest (``xl=True``: Yolo-Fastest-XL): a stride-1 stem and
    bottleneck, then stride-2 stages with routes at /8 and /16; heads: the
    /16 route with the upsampled bridge through 1x1 + 5x5-depthwise
    refinement, a 5x5-depthwise tower on the /32 bridge, a bare 1x1 on the
    /8 route. The head convs carry biases."""

    def __init__(self, num_classes: int = 20, num_anchors: int = 3, xl: bool = False):
        super().__init__()
        self.num_classes, self.num_anchors = num_classes, num_anchors
        pred = num_anchors * (5 + num_classes)
        stem, plan = _FASTEST_PLANS[bool(xl)]
        self.stem_conv = ConvBN(3, stem[0], 3, act=leaky)
        self.stem_pw = ConvBN(stem[0], stem[1], 1, act=leaky)
        self.stem_dw = DepthwiseConvBN(stem[1], 3, act=leaky)
        self.stem_proj = ConvBN(stem[1], stem[2], 1, act=leaky)
        self.steps = []  # block names and route markers, in order
        ch, routes, bi = stem[2], {}, 0
        for item in plan:
            if len(item) == 1:
                routes[item[0]] = ch
                self.steps.append(item[0])
                continue
            f, e, s = item
            self.add_module(f"block_{bi}", _FastestBlock(ch, f, e, s))
            self.steps.append(f"block_{bi}")
            ch, bi = f, bi + 1
        self.bridge = ConvBN(ch, 96, 1, act=leaky)
        self.h16_a = ConvBN(routes["route1"] + 96, 96, 1, act=leaky)
        self.h16_dw1 = DepthwiseConvBN(96, 5, act=leaky)
        self.h16_b = ConvBN(96, 96, 1, act=leaky)
        self.h16_dw2 = DepthwiseConvBN(96, 5, act=leaky)
        self.h16_c = ConvBN(96, 96, 1, act=leaky)
        self.head_16 = Conv2dSame(96, pred, bias=True)
        self.h32_dw1 = DepthwiseConvBN(96, 5, act=leaky)
        self.h32_a = ConvBN(96, 128, 1, act=leaky)
        self.h32_dw2 = DepthwiseConvBN(128, 5, act=leaky)
        self.h32_b = ConvBN(128, 128, 1, act=leaky)
        self.head_32 = Conv2dSame(128, pred, bias=True)
        self.head_8 = Conv2dSame(routes["route2"], pred, bias=True)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = self.stem_proj(self.stem_dw(self.stem_pw(self.stem_conv(x))))
        routes = {}
        for step in self.steps:
            if step.startswith("route"):
                routes[step] = x
            else:
                x = getattr(self, step)(x)
        x = self.bridge(x)
        b1 = torch.cat([routes["route1"], upsample2x(x)], dim=-1)
        b1 = self.h16_c(self.h16_dw2(self.h16_b(self.h16_dw1(self.h16_a(b1)))))
        y2 = self.head_16(b1)
        b2 = self.h32_b(self.h32_dw2(self.h32_a(self.h32_dw1(x))))
        y1 = self.head_32(b2)
        y3 = self.head_8(routes["route2"])
        return tuple(_split(y, self.num_anchors, self.num_classes) for y in (y1, y2, y3))


def space_to_depth(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """SkyNet's reorg layer, NHWC: [B, H, W, C] -> [B, H/s, W/s, s*s*C]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // stride, stride, w // stride, stride, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // stride, w // stride, stride * stride * c)


class SkyNet(nn.Module):
    """SkyNet: five separable-conv stages with a reorg bypass, one /8
    prediction map [B, gh, gw, A, 5+C] in float32."""

    def __init__(self, num_classes: int = 20, num_anchors: int = 3):
        super().__init__()
        self.num_classes, self.num_anchors = num_classes, num_anchors
        self.s1 = SeparableConvBN(3, 48, 3)
        self.s2 = SeparableConvBN(48, 96, 3)
        self.s3 = SeparableConvBN(96, 192, 3)
        self.s4 = SeparableConvBN(192, 384, 3)
        self.s5 = SeparableConvBN(384, 512, 3)
        self.s6 = SeparableConvBN(4 * 192 + 512, 96, 3)
        self.head = Conv2dSame(96, num_anchors * (5 + num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = maxpool_downsample(self.s1(x))
        x = maxpool_downsample(self.s2(x))
        x = self.s3(x)
        short = space_to_depth(x)  # /8, 768 channels
        x = self.s5(self.s4(maxpool_downsample(x)))
        x = self.s6(torch.cat([short, x], dim=-1))
        return _split(self.head(x), self.num_anchors, self.num_classes)
