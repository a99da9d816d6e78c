"""DarkNet-53 backbone, NHWC. Port of
``yoloret_tpu/nn/darknet.py``: a 3x3/32 stem, five stride-2 stages of
[1, 2, 8, 8, 4] residual blocks with [64, 128, 256, 512, 1024] filters
(1x1 to half the filters, 3x3 back, plus the skip), LeakyReLU(0.1).
The detector taps the stage ends at /4, /8, /16, /32. Every BatchNorm
has momentum 0.99, as in the JAX module.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from yoloret_tpu_torch.nn.layers import ConvBN, leaky

_STAGES = ((1, 64), (2, 128), (8, 256), (8, 512), (4, 1024))
_TAPS = {1: "c2", 2: "c3", 3: "c4", 4: "c5"}  # stage index -> pyramid key
TAP_CHANNELS = {key: _STAGES[si][1] for si, key in _TAPS.items()}


class DarkResidual(nn.Module):
    def __init__(self, filters: int):
        super().__init__()
        self.reduce = ConvBN(filters, filters // 2, 1, act=leaky, momentum=0.99)
        self.expand = ConvBN(filters // 2, filters, 3, act=leaky, momentum=0.99)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return x + self.expand(self.reduce(x, train), train)


class DarkNet53(nn.Module):
    """Returns the pyramid features {"c2", "c3", "c4", "c5"}."""

    def __init__(self):
        super().__init__()
        self.stem = ConvBN(3, 32, 3, act=leaky, momentum=0.99)
        ch = 32
        for si, (repeats, filters) in enumerate(_STAGES):
            self.add_module(f"down_{si}", ConvBN(ch, filters, 3, stride=2, act=leaky,
                                                 momentum=0.99))
            for r in range(repeats):
                self.add_module(f"stage_{si}_block_{r}", DarkResidual(filters))
            ch = filters

    def forward(self, x: torch.Tensor, train: bool = False) -> Dict[str, torch.Tensor]:
        x = self.stem(x, train)
        feats: Dict[str, torch.Tensor] = {}
        for si, (repeats, _) in enumerate(_STAGES):
            x = getattr(self, f"down_{si}")(x, train)
            for r in range(repeats):
                x = getattr(self, f"stage_{si}_block_{r}")(x, train)
            if si in _TAPS:
                feats[_TAPS[si]] = x
        return feats
