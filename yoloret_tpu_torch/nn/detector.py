"""YOLO-ReT detector: MobileNetV2 x0.75 taps -> RFCR -> FPN/PANet neck
-> per-scale [B, gh, gw, A, 5+C] raw heads. Port of
``yoloret_tpu/nn/detector.py`` for ``mobilenetv2x75`` with weighted-sum
RFCR, inference only."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from yoloret_tpu_torch.device import DeviceLike, resolve_device
from yoloret_tpu_torch.nn.heads import DetectionNeck
from yoloret_tpu_torch.nn.layers import init_weights, make_divisible, maxpool_downsample
from yoloret_tpu_torch.nn.mobilenetv2 import MobileNetV2
from yoloret_tpu_torch.nn.rfcr import RFCR

# Backbones of the port, keyed like the JAX package's registry.
BACKBONES = {"mobilenetv2x75": 0.75}


class YoloReT(nn.Module):
    """``forward(images)`` with images [B, H, W, 3] (H, W multiples of 32,
    RGB in [0, 1]) returns (y1, y2, y3): [B, H/32, W/32, A, 5+C],
    [B, H/16, ...], [B, H/8, ...], in the compute dtype."""

    def __init__(self, backbone: str = "mobilenetv2x75", num_classes: int = 20,
                 num_anchors: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        if backbone not in BACKBONES:
            raise ValueError(f"unknown backbone {backbone!r}; options: {sorted(BACKBONES)}")
        alpha = BACKBONES[backbone]
        self.backbone = backbone
        self.num_classes = num_classes
        self.num_anchors = num_anchors
        self.dtype = dtype
        c2, c3, c4, c5 = (make_divisible(c * alpha, 8) for c in (24, 32, 96, 160))
        self.body = MobileNetV2(alpha)
        self.rfcr = RFCR((c5, c4, c3, c2))
        fuse = 96
        self.neck = DetectionNeck((c5 + fuse, c4 + fuse, c3 + fuse), num_anchors, num_classes)

    def check_input(self, images: torch.Tensor) -> None:
        h, w = images.shape[-3], images.shape[-2]
        if h % 32 or w % 32:
            raise ValueError(
                f"input spatial size ({h}, {w}) must be a multiple of 32 "
                "(three stride-2 stages feed the /8,/16,/32 pyramid)")

    def neck_heads(self, feats) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """RFCR + neck + head split over the backbone taps."""
        b4 = maxpool_downsample(feats["c2"], 4)
        b1, b2, b3 = self.rfcr(feats["c5"], feats["c4"], feats["c3"], b4)
        return tuple(self.split(y) for y in self.neck(b1, b2, b3))

    def split(self, y: torch.Tensor) -> torch.Tensor:
        """[B, gh, gw, A*(5+C)] -> [B, gh, gw, A, 5+C] (the NHWC reshape
        of the JAX package; the heads keep the compute dtype)."""
        b, gh, gw, _ = y.shape
        return y.reshape(b, gh, gw, self.num_anchors, 5 + self.num_classes)

    def forward(self, images: torch.Tensor):
        self.check_input(images)
        return self.neck_heads(self.body(images.to(self.dtype)))


def build_detector(
    backbone: str = "mobilenetv2x75",
    num_classes: int = 20,
    num_anchors: int = 3,
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> YoloReT:
    """A detector with seeded weights (``torch.Generator(seed)``) on
    ``device``. Parameters stay float32; ``dtype`` is the compute dtype."""
    dev = resolve_device(device)
    model = YoloReT(backbone, num_classes, num_anchors, dtype)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
