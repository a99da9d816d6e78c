"""Detection neck: EfficientNet-lite head blocks chained FPN (top-down)
then PANet (bottom-up). Port of ``yoloret_tpu/nn/heads.py``."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from yoloret_tpu_torch.nn.layers import (
    ConvBN,
    Conv2dSame,
    MBConv,
    maxpool_downsample,
    relu6,
    upsample2x,
)


class LiteHeadBlock(nn.Module):
    """x -> 1x1 ConvBN(filters, ReLU6) -> MBConv(expand 1, k3, SE 0.25,
    project to pred_channels) = trunk; pred = bias-free 1x1 conv on the
    trunk, built only when ``with_pred``. The trunk carries
    ``pred_channels`` channels into the rest of the neck. BatchNorm
    momentum 0.99 (the EfficientNet head's)."""

    def __init__(self, in_ch: int, filters: int, pred_channels: int, with_pred: bool = True):
        super().__init__()
        self.expand = ConvBN(in_ch, filters, 1, act=relu6, momentum=0.99)
        self.mbconv = MBConv(filters, pred_channels, 3, 1, expand_ratio=1, se_ratio=0.25)
        self.pred = Conv2dSame(pred_channels, pred_channels) if with_pred else None

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        x = self.mbconv(self.expand(x, train), train)
        return x, (None if self.pred is None else self.pred(x))


class DetectionNeck(nn.Module):
    """FPN + PANet over the three RFCR outputs; returns raw per-scale
    prediction maps [B, gh, gw, A*(5+C)], coarsest (/32) first. The
    squeeze 1x1 stacks keep BatchNorm momentum 0.9."""

    def __init__(self, in_channels: Tuple[int, int, int], num_anchors: int = 3,
                 num_classes: int = 20):
        super().__init__()
        b1, b2, b3 = in_channels
        p = num_anchors * (5 + num_classes)
        self.fpn_head_32 = LiteHeadBlock(b1, 512, p, with_pred=False)
        self.fpn_squeeze_32 = ConvBN(p, 256)
        self.fpn_head_16 = LiteHeadBlock(256 + b2, 256, p, with_pred=False)
        self.fpn_squeeze_16 = ConvBN(p, 128)
        self.fpn_head_8 = LiteHeadBlock(128 + b3, 128, p, with_pred=False)
        self.pan_head_8 = LiteHeadBlock(p, 128, p)
        self.pan_squeeze_8 = ConvBN(p, 128)
        self.pan_head_16 = LiteHeadBlock(128 + p, 256, p)
        self.pan_squeeze_16 = ConvBN(p, 256)
        self.pan_head_32 = LiteHeadBlock(256 + p, 512, p)

    def forward(self, b1, b2, b3, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        # FPN top-down
        c1, _ = self.fpn_head_32(b1, train)
        x = self.fpn_squeeze_32(c1, train)
        c2, _ = self.fpn_head_16(torch.cat([upsample2x(x), b2], dim=-1), train)
        x = self.fpn_squeeze_16(c2, train)
        c3, _ = self.fpn_head_8(torch.cat([upsample2x(x), b3], dim=-1), train)
        # PANet bottom-up
        x, y3 = self.pan_head_8(c3, train)
        x = self.pan_squeeze_8(x, train)
        x, y2 = self.pan_head_16(torch.cat([maxpool_downsample(x), c2], dim=-1), train)
        x = self.pan_squeeze_16(x, train)
        _, y1 = self.pan_head_32(torch.cat([maxpool_downsample(x), c1], dim=-1), train)
        return y1, y2, y3
