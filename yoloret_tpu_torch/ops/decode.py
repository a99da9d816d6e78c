"""YOLO head decode helpers. Port of ``yoloret_tpu/ops/decode.py``
(``make_grid``, ``decode_boxes``, ``xywh_to_corners``, ``correct_boxes``;
differentiable, the loss decodes through them) and of the anchor masks
of ``yoloret_tpu/ops/targets.py``."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

# Scale order: index 0 is the coarsest (stride 32).
ANCHOR_MASKS = ([6, 7, 8], [3, 4, 5], [0, 1, 2])


def anchor_masks_for(num_scales: int) -> Tuple[Sequence[int], ...]:
    """Anchor-index groups per scale, coarsest first."""
    return tuple(ANCHOR_MASKS[-num_scales:])


def pair(a: float, b: float, device=None) -> torch.Tensor:
    """float32 tensor [a, b] built on ``device`` by a kernel, not by a
    host-to-device copy (which would synchronise the stream)."""
    return torch.where(torch.arange(2, device=device) == 0, float(a), float(b))


def make_grid(gh: int, gw: int, device=None) -> torch.Tensor:
    """float32 cell coordinates [gh, gw, 1, 2], ordered (x, y)."""
    gy, gx = torch.meshgrid(torch.arange(gh, device=device), torch.arange(gw, device=device),
                            indexing="ij")
    return torch.stack([gx, gy], dim=-1).float()[:, :, None, :]


def decode_boxes(feats: torch.Tensor, anchors: torch.Tensor, input_hw: Tuple[int, int]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Box centres and sizes of one scale's raw head.

    feats [..., gh, gw, A, 5+C] raw logits; anchors [A, 2] (w, h) in
    network-input pixels; input_hw (H_in, W_in). Returns (box_xy,
    box_wh), each [..., gh, gw, A, 2], normalised to the network input:
    xy = (sigmoid(t_xy) + cell) / (gw, gh), wh = exp(t_wh) * anchor /
    (W_in, H_in)."""
    gh, gw = feats.shape[-4], feats.shape[-3]
    dev, dt = feats.device, feats.dtype
    grid = make_grid(gh, gw, dev).to(dt)
    anchors = anchors.to(device=dev, dtype=dt).reshape(1, 1, -1, 2)
    wh_in = pair(input_hw[1], input_hw[0], dev).to(dt)
    gwh = pair(gw, gh, dev).to(dt)
    box_xy = (torch.sigmoid(feats[..., :2]) + grid) / gwh
    box_wh = torch.exp(feats[..., 2:4]) * anchors / wh_in
    return box_xy, box_wh


def xywh_to_corners(box_xy: torch.Tensor, box_wh: torch.Tensor) -> torch.Tensor:
    """(x, y) centres + (w, h) -> [..., 4] = (ymin, xmin, ymax, xmax)."""
    mins = box_xy - box_wh / 2.0
    maxes = box_xy + box_wh / 2.0
    return torch.cat([mins[..., 1:2], mins[..., 0:1], maxes[..., 1:2], maxes[..., 0:1]], dim=-1)


def correct_boxes(box_xy: torch.Tensor, box_wh: torch.Tensor, input_hw: Tuple[int, int],
                  image_hw: torch.Tensor) -> torch.Tensor:
    """Letterboxed network-frame boxes -> original-image pixels.

    box_xy / box_wh: normalised (x, y) / (w, h) in the network-input
    frame; input_hw: (H_in, W_in); image_hw [..., 2]: (H_img, W_img).
    Undoes the centred letterbox, scales to image pixels, clips to the
    image and returns [..., 4] = (ymin, xmin, ymax, xmax)."""
    dtype = box_xy.dtype
    box_yx = box_xy.flip(-1)
    box_hw = box_wh.flip(-1)
    input_shape = pair(*input_hw, device=box_xy.device).to(dtype)
    image_shape = image_hw.to(dtype)
    max_side = torch.maximum(image_shape[..., 0], image_shape[..., 1])[..., None]
    ratio = image_shape / max_side
    boxed_shape = input_shape * ratio
    offset = (input_shape - boxed_shape) / 2.0
    scale = image_shape / boxed_shape

    box_yx = (box_yx * input_shape - offset) * scale
    box_hw = box_hw * input_shape * scale
    box_mins = box_yx - box_hw / 2.0
    box_maxes = box_yx + box_hw / 2.0
    h = image_shape[..., 0:1]
    w = image_shape[..., 1:2]

    def clip(v, hi):
        return torch.minimum(torch.clamp(v, min=0.0), hi)

    return torch.cat([clip(box_mins[..., 0:1], h), clip(box_mins[..., 1:2], w),
                      clip(box_maxes[..., 0:1], h), clip(box_maxes[..., 1:2], w)], dim=-1)
