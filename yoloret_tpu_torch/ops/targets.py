"""Target assignment: padded ground truth -> dense per-scale YOLO
targets. Port of ``yoloret_tpu/ops/targets.py`` (``assign_targets``,
``assign_targets_batch``, ``true_corner_boxes``), batched over B.

Each box goes to the one scale that holds its best anchor (by wh-IoU
over the 9 anchors, the first maximum on ties), at the cell of its
centre. The centre is floored, ``(x1 + x2) // 2``, as the reference
computes it, and the cell index is clipped to the grid. Where several
boxes of an image land on one cell and anchor, the last valid one
wins: the JAX package writes the padded rows in order in a
``fori_loop``. Here each row that a later row of the same image
overwrites is dropped first, so the scatter that follows writes every
cell at most once (``index_put_`` with repeated indices has no defined
order on CUDA); the dropped rows go to one spare row past the grid,
which is cut off, so that no step waits for the device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from yoloret_tpu_torch.ops.boxes import wh_iou
from yoloret_tpu_torch.ops.decode import anchor_masks_for, pair

# Scale order: index 0 is the coarsest (stride 32).
GRID_STEPS = (32, 16, 8)


def assign_targets_batch(boxes: torch.Tensor, input_hw: Tuple[int, int],
                         anchors: torch.Tensor, num_classes: int, num_scales: int = 3
                         ) -> Tuple[torch.Tensor, ...]:
    """Dense targets of a batch.

    boxes [B, T, 5] padded ground truth (x1, y1, x2, y2, class) in
    network-input pixels, rows of width <= 0 being padding; input_hw
    (H, W), multiples of 32; anchors [9, 2] (w, h) pixels. Returns
    ``num_scales`` float32 tensors [B, gh, gw, 3, 5+C], coarsest first:
    normalised (cx, cy, w, h), objectness 1 and the one-hot class where a
    box is assigned, zeros elsewhere."""
    boxes = boxes.float()
    dev = boxes.device
    bsz, t = boxes.shape[0], boxes.shape[1]
    h, w = input_hw
    wh_in = pair(w, h, dev)
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=dev)

    box_xy = torch.floor((boxes[..., 0:2] + boxes[..., 2:4]) / 2.0) / wh_in
    box_wh = (boxes[..., 2:4] - boxes[..., 0:2]) / wh_in
    valid = boxes[..., 2] - boxes[..., 0] > 0  # [B, T]
    cls = boxes[..., 4].to(torch.int32)
    best = torch.argmax(wh_iou(box_wh[..., None, :] * wh_in, anchors), dim=-1)  # [B, T]
    one_hot = (cls[..., None] == torch.arange(num_classes, device=dev)).float()
    feat = torch.cat([box_xy, box_wh, torch.ones_like(box_xy[..., :1]), one_hot], dim=-1)
    rows = torch.arange(t, device=dev)
    later = rows[None, :] > rows[:, None]  # [T, T]: column after row

    outs = []
    for l, mask in enumerate(anchor_masks_for(num_scales)):
        gh, gw = round(h / GRID_STEPS[l]), round(w / GRID_STEPS[l])
        a = len(mask)
        match = torch.stack([best == m for m in mask], dim=-1)  # [B, T, a]
        in_scale = match.any(dim=-1) & valid
        k = torch.argmax(match.to(torch.uint8), dim=-1)
        gi = torch.clamp(torch.floor(box_xy[..., 0] * gw).long(), 0, gw - 1)
        gj = torch.clamp(torch.floor(box_xy[..., 1] * gh).long(), 0, gh - 1)
        cell = (gj * gw + gi) * a + k  # [B, T]
        overwritten = ((cell[:, :, None] == cell[:, None, :]) & later
                       & in_scale[:, None, :]).any(dim=-1)
        write = in_scale & ~overwritten
        n = gh * gw * a
        slot = torch.arange(bsz, device=dev)[:, None] * n + cell
        slot = torch.where(write, slot, torch.full_like(slot, bsz * n))
        grid = torch.zeros(bsz * n + 1, 5 + num_classes, device=dev)
        grid[slot.reshape(-1)] = feat.reshape(bsz * t, -1)
        outs.append(grid[:-1].reshape(bsz, gh, gw, a, 5 + num_classes))
    return tuple(outs)


def true_corner_boxes(boxes: torch.Tensor, input_hw: Tuple[int, int]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded ground truth [..., T, 5] pixel (x1, y1, x2, y2, cls) ->
    (normalised (ymin, xmin, ymax, xmax) [..., T, 4] float32, validity
    [..., T]), for the loss's ignore mask."""
    h, w = input_hw
    boxes = boxes.float()
    corners = torch.stack([boxes[..., 1] / h, boxes[..., 0] / w, boxes[..., 3] / h,
                           boxes[..., 2] / w], dim=-1)
    return corners, (boxes[..., 2] - boxes[..., 0]) > 0
