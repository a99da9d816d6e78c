"""YOLO-ReT detector: backbone taps -> RFCR -> FPN/PANet neck -> per-scale
[B, gh, gw, A, 5+C] raw heads. Port of ``yoloret_tpu/nn/detector.py``:
every backbone of the JAX registry and every RFCR fusion
(``weighted_sum``, ``concat``, ``none``), at inference and in training."""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from yoloret_tpu_torch.device import DeviceLike, resolve_device
from yoloret_tpu_torch.nn import darknet, efficientnet
from yoloret_tpu_torch.nn.heads import DetectionNeck
from yoloret_tpu_torch.nn.layers import (
    init_weights,
    keep_stats,
    make_divisible,
    maxpool_downsample,
)
from yoloret_tpu_torch.nn.legacy import YoloFastest, YoloNano
from yoloret_tpu_torch.nn.mobilenetv2 import MobileNetV2
from yoloret_tpu_torch.nn.rfcr import RFCR

# Backbones, keyed like the JAX package's registry: (kind, arguments).
BACKBONES = {
    "mobilenetv2x75": ("mobilenetv2", dict(alpha=0.75)),
    "mobilenetv2x14": ("mobilenetv2", dict(alpha=1.4)),
    "mobilenetv2x10": ("mobilenetv2", dict(alpha=1.0)),
    "darknet53": ("darknet", dict()),
    # complete legacy bodies (no RFCR or neck of their own)
    "yolo_nano": ("fullbody", dict(cls="nano")),
    "yolo_fastest": ("fullbody", dict(cls="fastest")),
    "yolo_fastest_xl": ("fullbody", dict(cls="fastest", xl=True)),
    **{f"efficientnetb{i}": ("efficientnet", dict(variant=f"b{i}")) for i in range(8)},
}
RFCR_FUSIONS = ("weighted_sum", "concat", "none")
FUSE_CHANNELS = 96  # the RFCR's fused map, concatenated onto each scale


def _body(kind: str, kw: dict, num_classes: int, num_anchors: int
          ) -> Tuple[nn.Module, Dict[str, int]]:
    """The backbone module and its tap channels ({} for a full body)."""
    if kind == "mobilenetv2":
        alpha = kw["alpha"]
        return MobileNetV2(alpha), {k: make_divisible(c * alpha, 8) for k, c in
                                    (("c2", 24), ("c3", 32), ("c4", 96), ("c5", 160))}
    if kind == "darknet":
        return darknet.DarkNet53(), dict(darknet.TAP_CHANNELS)
    if kind == "efficientnet":
        return efficientnet.EfficientNet(kw["variant"]), efficientnet.tap_channels(kw["variant"])
    body_kw = dict(kw)
    cls = {"nano": YoloNano, "fastest": YoloFastest}[body_kw.pop("cls")]
    return cls(num_classes=num_classes, num_anchors=num_anchors, **body_kw), {}


class YoloReT(nn.Module):
    """``forward(images)`` with images [B, H, W, 3] (H, W multiples of 32,
    RGB in [0, 1]) returns (y1, y2, y3): [B, H/32, W/32, A, 5+C],
    [B, H/16, ...], [B, H/8, ...], in the compute dtype (float32 for the
    full legacy bodies, which cast their heads as the JAX ones do); the
    loss casts them to float32.

    ``remat`` recomputes the backbone's forward in the backward pass
    (``torch.utils.checkpoint``, the JAX package's ``nn.remat``) instead
    of keeping its activations; the recompute does not update the
    BatchNorm statistics a second time."""

    def __init__(self, backbone: str = "mobilenetv2x75", num_classes: int = 20,
                 num_anchors: int = 3, dtype: torch.dtype = torch.float32,
                 rfcr: str = "weighted_sum", remat: bool = False):
        super().__init__()
        if backbone not in BACKBONES:
            raise ValueError(f"unknown backbone {backbone!r}; options: {sorted(BACKBONES)}")
        if rfcr not in RFCR_FUSIONS:
            raise ValueError(
                f"unknown rfcr fusion {rfcr!r}; options: weighted_sum, concat, none")
        kind, kw = BACKBONES[backbone]
        self.backbone = backbone
        self.kind = kind
        self.rfcr_fusion = rfcr
        self.num_classes = num_classes
        self.num_anchors = num_anchors
        self.dtype = dtype
        self.remat = remat
        self.body, taps = _body(kind, kw, num_classes, num_anchors)
        if kind == "fullbody":
            return
        c2, c3, c4, c5 = (taps[k] for k in ("c2", "c3", "c4", "c5"))
        fuse = 0
        if rfcr != "none":
            self.rfcr = RFCR((c5, c4, c3, c2), fuse_channels=FUSE_CHANNELS, fusion=rfcr)
            fuse = FUSE_CHANNELS
        self.neck = DetectionNeck((c5 + fuse, c4 + fuse, c3 + fuse), num_anchors, num_classes)

    def check_input(self, images: torch.Tensor) -> None:
        h, w = images.shape[-3], images.shape[-2]
        if h % 32 or w % 32:
            raise ValueError(
                f"input spatial size ({h}, {w}) must be a multiple of 32 "
                "(three stride-2 stages feed the /8,/16,/32 pyramid)")

    def neck_heads(self, feats, train: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """RFCR (unless ``none``) + neck + head split over the backbone taps."""
        if self.rfcr_fusion != "none":
            b4 = maxpool_downsample(feats["c2"], 4)
            b1, b2, b3 = self.rfcr(feats["c5"], feats["c4"], feats["c3"], b4, train)
        else:
            b1, b2, b3 = feats["c5"], feats["c4"], feats["c3"]
        return tuple(self.split(y) for y in self.neck(b1, b2, b3, train))

    def split(self, y: torch.Tensor) -> torch.Tensor:
        """[B, gh, gw, A*(5+C)] -> [B, gh, gw, A, 5+C] (the NHWC reshape
        of the JAX package)."""
        b, gh, gw, _ = y.shape
        return y.reshape(b, gh, gw, self.num_anchors, 5 + self.num_classes)

    def _features(self, x: torch.Tensor, train: bool, drop_seed: Optional[int]):
        if self.kind == "efficientnet":
            return self.body(x, train, drop_seed)
        return self.body(x, train)

    def forward(self, images: torch.Tensor, train: bool = False,
                backbone_train: Optional[bool] = None, drop_seed: Optional[int] = None):
        """``train`` runs every BatchNorm on batch statistics and updates
        its running statistics. ``backbone_train=False`` with
        ``train=True`` is stage 1 of truncated transfer: the backbone runs
        on its running statistics and leaves them as they are, while the
        RFCR and neck BatchNorms train. ``drop_seed`` seeds EfficientNet's
        drop-connect in training."""
        self.check_input(images)
        if backbone_train is None:
            backbone_train = train
        x = images.to(self.dtype)
        if self.kind == "fullbody":
            return self.body(x, train)
        if self.remat and torch.is_grad_enabled():
            feats = checkpoint(self._features, x, backbone_train, drop_seed, use_reentrant=False,
                               context_fn=lambda: (contextlib.nullcontext(),
                                                   keep_stats(self.body)))
        else:
            feats = self._features(x, backbone_train, drop_seed)
        return self.neck_heads(feats, train)


def build_detector(
    backbone: str = "mobilenetv2x75",
    num_classes: int = 20,
    num_anchors: int = 3,
    dtype: torch.dtype = torch.float32,
    rfcr: str = "weighted_sum",
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> YoloReT:
    """A detector with seeded weights (``torch.Generator(seed)``) on
    ``device``. Parameters stay float32; ``dtype`` is the compute dtype."""
    dev = resolve_device(device)
    model = YoloReT(backbone, num_classes, num_anchors, dtype, rfcr)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
