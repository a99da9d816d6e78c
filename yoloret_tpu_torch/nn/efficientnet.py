"""EfficientNet B0-B7 backbone, NHWC, inference. Port of
``yoloret_tpu/nn/efficientnet.py``: a copy of its stage tables and width
and depth rounding, and the network on the port's ``MBConv`` (swish,
squeeze-excite) from ``nn/layers.py``.

The detector taps the ends of stages 1/2/4/5 (/4, /8, /16, /32); stages
past the last tap are not built unless ``include_top_features``, which
also builds the 1x1 ``top`` conv. Drop-connect is the identity at
inference and holds no parameters, so it is not built.

EfficientNet's block has no fused kernel: its squeeze-excite takes a
global mean between the depthwise and the project conv, so the block
runs as stock PyTorch convolutions (the JAX package runs it on stock
XLA for the same reason).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from yoloret_tpu_torch.nn.layers import ConvBN, MBConv, swish


@dataclasses.dataclass(frozen=True)
class BlockArgs:
    """One ``r?_k?_s??_e?_i?_o?_se?`` block string, decoded."""

    num_repeat: int
    kernel_size: int
    strides: Tuple[int, int]
    expand_ratio: int
    input_filters: int
    output_filters: int
    se_ratio: Optional[float] = 0.25
    id_skip: bool = True


# The 7 stages of the base (B0) network.
BASE_BLOCKS = (
    BlockArgs(1, 3, (1, 1), 1, 32, 16),
    BlockArgs(2, 3, (2, 2), 6, 16, 24),
    BlockArgs(2, 5, (2, 2), 6, 24, 40),
    BlockArgs(3, 3, (2, 2), 6, 40, 80),
    BlockArgs(3, 5, (1, 1), 6, 80, 112),
    BlockArgs(4, 5, (2, 2), 6, 112, 192),
    BlockArgs(1, 3, (1, 1), 6, 192, 320),
)

# model -> (width_coefficient, depth_coefficient, resolution, dropout_rate)
EFFICIENTNET_PARAMS = {
    "b0": (1.0, 1.0, 224, 0.2),
    "b1": (1.0, 1.1, 240, 0.2),
    "b2": (1.1, 1.2, 260, 0.3),
    "b3": (1.2, 1.4, 300, 0.3),
    "b4": (1.4, 1.8, 380, 0.4),
    "b5": (1.6, 2.2, 456, 0.4),
    "b6": (1.8, 2.6, 528, 0.5),
    "b7": (2.0, 3.1, 600, 0.5),
}

# Stage index (0-based) -> pyramid tap key (/4, /8, /16, /32).
_TAP_STAGES = {1: "c2", 2: "c3", 4: "c4", 5: "c5"}


def round_filters(filters: int, width_coefficient: Optional[float], divisor: int = 8) -> int:
    if not width_coefficient:
        return filters
    filters *= width_coefficient
    new_filters = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_filters < 0.9 * filters:
        new_filters += divisor
    return int(new_filters)


def round_repeats(repeats: int, depth_coefficient: Optional[float]) -> int:
    if not depth_coefficient:
        return repeats
    return int(math.ceil(depth_coefficient * repeats))


def decode_block_args(variant: str) -> Tuple[Tuple[BlockArgs, ...], float]:
    """The base stage table scaled for a B-variant: (per-stage args with
    rounded filters and repeats, dropout_rate)."""
    width, depth, _, dropout = EFFICIENTNET_PARAMS[variant]
    out = []
    for args in BASE_BLOCKS:
        out.append(dataclasses.replace(
            args,
            input_filters=round_filters(args.input_filters, width),
            output_filters=round_filters(args.output_filters, width),
            num_repeat=round_repeats(args.num_repeat, depth),
        ))
    return tuple(out), dropout


def tap_channels(variant: str) -> Dict[str, int]:
    """Channels of the taps c2/c3/c4/c5 (stage output filters)."""
    stages, _ = decode_block_args(variant)
    return {key: stages[si].output_filters for si, key in _TAP_STAGES.items()}


class EfficientNet(nn.Module):
    """Returns the pyramid features {"c2", "c3", "c4", "c5"} (+ "top"
    when ``include_top_features``)."""

    def __init__(self, variant: str = "b3", include_top_features: bool = False):
        super().__init__()
        width, _, _, _ = EFFICIENTNET_PARAMS[variant]
        stages, _ = decode_block_args(variant)
        self.include_top_features = include_top_features
        ch = round_filters(32, width)
        self.stem = ConvBN(3, ch, 3, stride=2, act=swish)
        last_tap = max(_TAP_STAGES)
        self.stage_blocks = []  # [(stage index, [block names])]
        for si, stage in enumerate(stages):
            if si > last_tap and not include_top_features:
                break
            names = []
            for r in range(stage.num_repeat):
                name = f"stage_{si}_block_{r}"
                self.add_module(name, MBConv(
                    stage.input_filters if r == 0 else stage.output_filters,
                    stage.output_filters, stage.kernel_size,
                    stage.strides[0] if r == 0 else 1, stage.expand_ratio, stage.se_ratio,
                    stage.id_skip))
                ch = stage.output_filters
                names.append(name)
            self.stage_blocks.append((si, names))
        if include_top_features:
            self.top = ConvBN(ch, round_filters(1280, width), 1, act=swish)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        feats: Dict[str, torch.Tensor] = {}
        for si, names in self.stage_blocks:
            for name in names:
                x = getattr(self, name)(x)
            if si in _TAP_STAGES:
                feats[_TAP_STAGES[si]] = x
        if self.include_top_features:
            feats["top"] = self.top(x)
        return feats
