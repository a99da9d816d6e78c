"""RFCR — Raw Feature Collection and Redistribution. Port of
``yoloret_tpu/nn/rfcr.py``.

Collect: the three detection-scale taps plus the shallow tap (already
pooled x4 by the caller) are each projected to 48 channels by a
bias-free 1x1 conv, resampled to the /16 scale and merged, then one 5x5
depthwise-separable conv to 96 channels. ``fusion="weighted_sum"`` (the
paper's RFCR) merges by a learned 4-way scalar sum; ``"concat"`` (the
legacy proto-RFCR) concatenates the four maps, so the fuse conv takes
4 x 48 channels.
Redistribute: the fused map is concatenated back onto each detection
scale (pooled for /32, as-is for /16, upsampled for /8).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from yoloret_tpu_torch.nn.layers import (
    Conv2dSame,
    SeparableConvBN,
    WeightedSum,
    maxpool_downsample,
    upsample2x,
)


FUSIONS = ("weighted_sum", "concat")


class RFCR(nn.Module):
    def __init__(self, in_channels: Tuple[int, int, int, int],
                 collect_channels: int = 48, fuse_channels: int = 96,
                 fusion: str = "weighted_sum"):
        """``in_channels``: channels of (b1 /32, b2 /16, b3 /8, b4 shallow)."""
        super().__init__()
        if fusion not in FUSIONS:
            raise ValueError(f"unknown rfcr fusion {fusion!r}; options: {', '.join(FUSIONS)}")
        self.fusion = fusion
        for i, ch in enumerate(in_channels, start=1):
            self.add_module(f"collect_{i}", Conv2dSame(ch, collect_channels))
        if fusion == "concat":
            fused_in = collect_channels * len(in_channels)
        else:
            self.fuse_weights = WeightedSum(len(in_channels))
            fused_in = collect_channels
        self.fuse_conv = SeparableConvBN(fused_in, fuse_channels, 5)

    def forward(self, b1, b2, b3, b4, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        collected = [
            upsample2x(self.collect_1(b1)),
            self.collect_2(b2),
            maxpool_downsample(self.collect_3(b3)),
            self.collect_4(b4),
        ]
        if self.fusion == "concat":
            bc = self.fuse_conv(torch.cat(collected, dim=-1), train)
        else:
            bc = self.fuse_conv(self.fuse_weights(collected), train)
        out1 = torch.cat([b1, maxpool_downsample(bc)], dim=-1)
        out2 = torch.cat([b2, bc], dim=-1)
        out3 = torch.cat([b3, upsample2x(bc)], dim=-1)
        return out1, out2, out3
