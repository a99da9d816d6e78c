"""The YOLO-ReT training loss. Port of ``yoloret_tpu/train/losses.py``
(reference: code/yolo3/model.py:585-691).

Per detection scale, in float32 whatever the heads' dtype (in float64
for float64 targets: a float64 reference of the whole step):
  * the raw xy/wh decode of ``ops/decode.py``;
  * the box loss on positive cells, ``object_mask * (1 - giou)``, or the
    MSE branch (BCE on the xy offsets, squared error on log-wh, scaled
    by 2 - w*h: what the reference's broken MSE path meant);
  * objectness BCE, with a negative ignored where its best IoU against
    the image's ground truth exceeds ``ignore_thresh``;
  * class BCE (or the focal loss) on positives;
  * every term summed and divided by the batch size.

Deviation kept from the JAX package: the reference builds the ignore
mask against the positive boxes of the whole batch (a dynamic
``tf.boolean_mask``); here each image is held against its own padded
ground-truth list (invalid rows masked), the standard YOLOv3 semantics,
which keeps every shape static.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from yoloret_tpu_torch.ops.boxes import pairwise_iou
from yoloret_tpu_torch.ops.decode import anchor_masks_for, decode_boxes, make_grid, pair
from yoloret_tpu_torch.ops.decode import xywh_to_corners
from yoloret_tpu_torch.ops.targets import GRID_STEPS


class LossBreakdown(NamedTuple):
    total: torch.Tensor
    box: torch.Tensor
    confidence: torch.Tensor
    classification: torch.Tensor


def bce_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid cross-entropy with logits. At a logit
    of exactly 0 the gradient is JAX's: ``maximum`` splits it in half and
    ``abs`` takes the positive side."""
    abs_logits = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, logits.new_zeros(())) - logits * labels
            + torch.log1p(torch.exp(-abs_logits)))


def sigmoid_focal_crossentropy(labels: torch.Tensor, logits: torch.Tensor,
                               alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """RetinaNet focal loss on logits (``class_loss="focal"``)."""
    ce = bce_logits(logits, labels)
    p = torch.sigmoid(logits)
    p_t = labels * p + (1.0 - labels) * (1.0 - p)
    alpha_factor = labels * alpha + (1.0 - labels) * (1.0 - alpha) if alpha else 1.0
    modulating = (1.0 - p_t) ** gamma if gamma else 1.0
    return alpha_factor * modulating * ce


def yolo_loss_per_scale(yolo_output: torch.Tensor, y_true: torch.Tensor,
                        gt_boxes: torch.Tensor, gt_valid: torch.Tensor, anchors: torch.Tensor,
                        grid_step: int, ignore_thresh: float = 0.5, box_loss: str = "giou",
                        class_loss_kind: str = "bce") -> LossBreakdown:
    """Loss of one detection scale.

    yolo_output [B, gh, gw, A, 5+C] raw logits; y_true the same shape
    (``ops/targets.py``'s layout); gt_boxes [B, T, 4] normalised (ymin,
    xmin, ymax, xmax); gt_valid [B, T] bool; anchors [A, 2] (w, h)
    pixels of this scale; grid_step its stride (32, 16 or 8)."""
    dtype = torch.promote_types(y_true.dtype, torch.float32)
    yolo_output = yolo_output.to(dtype)
    y_true = y_true.to(dtype)
    b, gh, gw = yolo_output.shape[:3]
    input_hw = (gh * grid_step, gw * grid_step)
    bf = float(b)
    dev = yolo_output.device

    object_mask = y_true[..., 4:5]
    true_class_probs = y_true[..., 5:]
    pred_xy, pred_wh = decode_boxes(yolo_output, anchors, input_hw)
    pred_box = xywh_to_corners(pred_xy, pred_wh)  # [B, gh, gw, A, 4]
    true_box = torch.clamp(xywh_to_corners(y_true[..., 0:2], y_true[..., 2:4]), 0.0, 1.0)

    # ignore mask: the best IoU of every prediction against its image's ground truth
    iou = pairwise_iou(pred_box[:, :, :, :, None, :], gt_boxes[:, None, None, None, :, :])
    iou = torch.where(gt_valid[:, None, None, None, :], iou, torch.zeros_like(iou))
    best_iou = iou.max(dim=-1, keepdim=True).values
    ignore_mask = (best_iou < ignore_thresh).float()

    obj_bce = bce_logits(yolo_output[..., 4:5], object_mask)
    confidence = object_mask * obj_bce + (1.0 - object_mask) * obj_bce * ignore_mask
    confidence = confidence.sum() / bf

    if class_loss_kind == "focal":
        cls_term = sigmoid_focal_crossentropy(true_class_probs, yolo_output[..., 5:])
    else:
        cls_term = bce_logits(yolo_output[..., 5:], true_class_probs)
    classification = (object_mask * cls_term).sum() / bf

    if box_loss == "giou":
        g = pairwise_iou(pred_box, true_box, "giou")
        box = (object_mask * (1.0 - g[..., None])).sum() / bf
    elif box_loss == "mse":
        grid = make_grid(gh, gw, dev)
        gwh = pair(gw, gh, dev)
        wh_in = pair(input_hw[1], input_hw[0], dev)
        raw_true_xy = y_true[..., 0:2] * gwh - grid
        safe_wh = torch.where(object_mask > 0, y_true[..., 2:4], torch.ones_like(y_true[..., 2:4]))
        raw_true_wh = torch.log(safe_wh * wh_in / anchors.reshape(1, 1, 1, -1, 2))
        raw_true_wh = torch.where(object_mask > 0, raw_true_wh, torch.zeros_like(raw_true_wh))
        scale = 2.0 - y_true[..., 2:3] * y_true[..., 3:4]
        xy_loss = object_mask * scale * bce_logits(yolo_output[..., 0:2], raw_true_xy)
        wh_loss = object_mask * scale * 0.5 * torch.square(raw_true_wh - yolo_output[..., 2:4])
        box = (xy_loss.sum() + wh_loss.sum()) / bf
    else:
        raise ValueError(f"unknown box_loss {box_loss!r}")
    return LossBreakdown(box + confidence + classification, box, confidence, classification)


def yolo_loss(yolo_outputs: Sequence[torch.Tensor], y_trues: Sequence[torch.Tensor],
              gt_boxes: torch.Tensor, gt_valid: torch.Tensor, anchors: torch.Tensor,
              num_scales: int = 3, ignore_thresh: float = 0.5, box_loss: str = "giou",
              class_loss_kind: str = "bce") -> Tuple[torch.Tensor, Tuple[LossBreakdown, ...]]:
    """Sum of the per-scale losses; ``anchors`` is the whole [9, 2]
    table (on the heads' device), sliced per scale by the anchor masks."""
    anchors = anchors.float()
    parts = []
    total = None
    for l, mask in enumerate(anchor_masks_for(num_scales)):
        part = yolo_loss_per_scale(
            yolo_outputs[l], y_trues[l], gt_boxes, gt_valid, anchors[mask[0]:mask[-1] + 1],
            GRID_STEPS[l], ignore_thresh=ignore_thresh, box_loss=box_loss,
            class_loss_kind=class_loss_kind)
        parts.append(part)
        total = part.total if total is None else total + part.total
    return total, tuple(parts)
