"""The NMS result slate. Port of ``yoloret_tpu/ops/nms.py::NMSResult``
and ``yoloret_tpu/ops/nms_pallas.py::fused_result``."""

from __future__ import annotations

from typing import NamedTuple

import torch


class NMSResult(NamedTuple):
    boxes: torch.Tensor  # [B, C * max_det, 4] (ymin, xmin, ymax, xmax)
    scores: torch.Tensor  # [B, C * max_det]
    classes: torch.Tensor  # [B, C * max_det] int32
    valid: torch.Tensor  # [B, C * max_det] bool


def fused_result(out_boxes: torch.Tensor, out_scores: torch.Tensor) -> NMSResult:
    """Flatten [B, C, D] suppression outputs into the slate; a slot is
    valid when its score is above 0 (empty slots are zeros)."""
    b, c, d, _ = out_boxes.shape
    classes = torch.arange(c, dtype=torch.int32, device=out_scores.device)
    return NMSResult(
        boxes=out_boxes.reshape(b, c * d, 4),
        scores=out_scores.reshape(b, c * d),
        classes=classes[None, :, None].expand(b, c, d).reshape(b, c * d),
        valid=(out_scores > 0.0).reshape(b, c * d),
    )
