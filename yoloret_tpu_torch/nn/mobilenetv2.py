"""MobileNetV2 backbone (width multiplier alpha), NHWC.

Port of ``yoloret_tpu/nn/mobilenetv2.py``: the stock, unfused network.
The detector taps the four stage ends c2/c3/c4/c5 at Keras blocks
2/5/12/15; blocks past the last tap are not built. Every BatchNorm has
Flax's momentum 0.9. The serving path runs
the same weights through ``nn/fused_infer.py`` instead, one fused kernel
per block.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from yoloret_tpu_torch.nn.layers import ConvBN, DepthwiseConvBN, make_divisible, relu6

# (expansion t, base channels c, repeats n, first stride s) per stage,
# standard MobileNetV2; block numbering follows Keras (block_0..block_16).
_STAGES = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

# Keras block index of each detector tap and the pyramid key it feeds.
_TAP_BLOCKS = {2: "c2", 5: "c3", 12: "c4", 15: "c5"}


def block_specs(alpha: float) -> List[Tuple[int, int, int, int, int]]:
    """[(block_id, stride, expand_ratio, in_ch, out_ch)] for blocks
    0..last tap."""
    specs = []
    block_id = -1
    in_ch = make_divisible(32 * alpha, 8)
    for t, c, n, s in _STAGES:
        out_ch = make_divisible(c * alpha, 8)
        for i in range(n):
            block_id += 1
            if block_id > max(_TAP_BLOCKS):
                return specs
            specs.append((block_id, s if i == 0 else 1, t, in_ch, out_ch))
            in_ch = out_ch
    return specs


class InvertedResidual(nn.Module):
    """Expand 1x1 -> depthwise 3x3 -> project 1x1, residual when
    stride 1 and in == out channels."""

    def __init__(self, in_ch: int, features: int, stride: int = 1, expand_ratio: int = 6):
        super().__init__()
        ce = in_ch * expand_ratio
        self.stride = stride
        self.residual = stride == 1 and in_ch == features
        self.expand = ConvBN(in_ch, ce, 1, act=relu6) if expand_ratio != 1 else None
        self.depthwise = DepthwiseConvBN(ce, 3, stride, act=relu6)
        self.project = ConvBN(ce, features, 1, act=None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = x if self.expand is None else self.expand(x, train)
        y = self.project(self.depthwise(y, train), train)
        return y + x if self.residual else y


class MobileNetV2(nn.Module):
    """Returns the pyramid features {"c2", "c3", "c4", "c5"}."""

    def __init__(self, alpha: float = 0.75):
        super().__init__()
        self.stem = ConvBN(3, make_divisible(32 * alpha, 8), 3, stride=2, act=relu6)
        self.block_names = []
        for block_id, stride, t, in_ch, out_ch in block_specs(alpha):
            name = f"block_{block_id}"
            self.add_module(name, InvertedResidual(in_ch, out_ch, stride, t))
            self.block_names.append(name)

    def forward(self, x: torch.Tensor, train: bool = False) -> Dict[str, torch.Tensor]:
        x = self.stem(x, train)
        feats: Dict[str, torch.Tensor] = {}
        for block_id, name in enumerate(self.block_names):
            x = getattr(self, name)(x, train)
            if block_id in _TAP_BLOCKS:
                feats[_TAP_BLOCKS[block_id]] = x
        return feats
