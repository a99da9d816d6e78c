"""The NMS result slate. Port of ``yoloret_tpu/ops/nms.py::NMSResult``,
of ``yoloret_tpu/ops/nms_pallas.py::fused_result`` and of the slate that
``yoloret_tpu/ops/nms.py::class_aware_nms`` returns."""

from __future__ import annotations

from typing import NamedTuple

import torch


class NMSResult(NamedTuple):
    boxes: torch.Tensor  # [B, C * max_det, 4] (ymin, xmin, ymax, xmax)
    scores: torch.Tensor  # [B, C * max_det]
    classes: torch.Tensor  # [B, C * max_det] int32
    valid: torch.Tensor  # [B, C * max_det] bool


def _slate(out_boxes: torch.Tensor, out_scores: torch.Tensor, valid: torch.Tensor
           ) -> NMSResult:
    b, c, d, _ = out_boxes.shape
    classes = torch.arange(c, dtype=torch.int32, device=out_scores.device)
    return NMSResult(
        boxes=out_boxes.reshape(b, c * d, 4),
        scores=out_scores.reshape(b, c * d),
        classes=classes[None, :, None].expand(b, c, d).reshape(b, c * d),
        valid=valid.reshape(b, c * d),
    )


def fused_result(out_boxes: torch.Tensor, out_scores: torch.Tensor) -> NMSResult:
    """Flatten [B, C, D] suppression outputs into the slate; a slot is
    valid when its score is above 0 (empty slots are zeros)."""
    return _slate(out_boxes, out_scores, out_scores > 0.0)


def picked_result(out_boxes: torch.Tensor, out_scores: torch.Tensor) -> NMSResult:
    """The slate of ``class_aware_nms`` from [B, C, D] suppression
    outputs whose empty slots carry a score of -inf: a slot is valid when
    it holds a pick (a pick of score 0 included), and empty slots' scores
    become 0."""
    valid = out_scores > float("-inf")
    return _slate(out_boxes, torch.where(valid, out_scores, 0.0), valid)
