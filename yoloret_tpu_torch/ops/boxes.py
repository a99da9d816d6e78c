"""Box IoU on corner-encoded boxes ``[..., 4]`` = (ymin, xmin, ymax, xmax).

Port of ``yoloret_tpu/ops/boxes.py::iou``: broadcasts over any leading
shape, degenerate boxes clamp to zero area, and the division is
divide-no-nan (0 where the union is 0)."""

from __future__ import annotations

import torch


def div_no_nan(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den with 0 where den == 0."""
    nz = den != 0
    return torch.where(nz, num / torch.where(nz, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def iou(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Broadcasted IoU of ``b1`` and ``b2``."""
    b1_ymin, b1_xmin, b1_ymax, b1_xmax = b1.unbind(-1)
    b2_ymin, b2_xmin, b2_ymax, b2_xmax = b2.unbind(-1)
    b1_area = torch.clamp(b1_xmax - b1_xmin, min=0.0) * torch.clamp(b1_ymax - b1_ymin, min=0.0)
    b2_area = torch.clamp(b2_xmax - b2_xmin, min=0.0) * torch.clamp(b2_ymax - b2_ymin, min=0.0)
    inter_w = torch.clamp(torch.minimum(b1_xmax, b2_xmax) - torch.maximum(b1_xmin, b2_xmin), min=0.0)
    inter_h = torch.clamp(torch.minimum(b1_ymax, b2_ymax) - torch.maximum(b1_ymin, b2_ymin), min=0.0)
    inter = inter_w * inter_h
    return div_no_nan(inter, b1_area + b2_area - inter)
