"""Box IoU and GIoU on corner-encoded boxes ``[..., 4]`` = (ymin, xmin,
ymax, xmax). Port of ``yoloret_tpu/ops/boxes.py``: every function
broadcasts over any leading shape, degenerate boxes clamp to zero area,
and every division is divide-no-nan (0 where the denominator is 0),
written as the JAX package writes it, a ``where`` on both sides of the
division, so that the gradient stays finite on empty boxes."""

from __future__ import annotations

import torch


def _pos(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0), with the gradient split in half at 0 as ``jnp.maximum``
    splits it (``torch.clamp`` passes all of it)."""
    return torch.maximum(x, x.new_zeros(()))


def div_no_nan(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den with 0 where den == 0."""
    nz = den != 0
    return torch.where(nz, num / torch.where(nz, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def pairwise_iou(b1: torch.Tensor, b2: torch.Tensor, mode: str = "iou") -> torch.Tensor:
    """Broadcasted IoU (``mode="iou"``) or generalized IoU in [-1, 1]
    (``mode="giou"``) of ``b1`` and ``b2``."""
    b1_ymin, b1_xmin, b1_ymax, b1_xmax = b1.unbind(-1)
    b2_ymin, b2_xmin, b2_ymax, b2_xmax = b2.unbind(-1)
    b1_area = _pos(b1_xmax - b1_xmin) * _pos(b1_ymax - b1_ymin)
    b2_area = _pos(b2_xmax - b2_xmin) * _pos(b2_ymax - b2_ymin)
    inter_w = _pos(torch.minimum(b1_xmax, b2_xmax) - torch.maximum(b1_xmin, b2_xmin))
    inter_h = _pos(torch.minimum(b1_ymax, b2_ymax) - torch.maximum(b1_ymin, b2_ymin))
    inter = inter_w * inter_h
    union = b1_area + b2_area - inter
    iou_ = div_no_nan(inter, union)
    if mode == "iou":
        return iou_
    if mode != "giou":
        raise ValueError(f"unknown mode {mode!r}; options: iou, giou")
    enc_w = _pos(torch.maximum(b1_xmax, b2_xmax) - torch.minimum(b1_xmin, b2_xmin))
    enc_h = _pos(torch.maximum(b1_ymax, b2_ymax) - torch.minimum(b1_ymin, b2_ymin))
    enc = enc_w * enc_h
    return iou_ - div_no_nan(enc - union, enc)


def iou(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Broadcasted IoU of ``b1`` and ``b2``."""
    return pairwise_iou(b1, b2, "iou")



def wh_iou(wh1: torch.Tensor, wh2: torch.Tensor) -> torch.Tensor:
    """IoU of origin-centred (w, h) rectangles, broadcastable: the anchor
    match of target assignment."""
    w1, h1 = wh1[..., 0], wh1[..., 1]
    w2, h2 = wh2[..., 0], wh2[..., 1]
    inter = torch.minimum(w1, w2) * torch.minimum(h1, h2)
    return div_no_nan(inter, w1 * h1 + w2 * h2 - inter)
