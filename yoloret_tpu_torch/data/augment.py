"""The evaluation letterbox on the device. Port of the eval part of
``yoloret_tpu/data/augment.py``: ``AugmentConfig`` (the one field eval
reads, ``input_hw``), ``_to_unit_float`` and ``_eval_one`` / ``eval_batch``, batched
over B instead of vmapped. The training augmentation is not ported yet.

The host stretches each image to a staging square [S, S, 3]; here each
one is resampled into the network input with its aspect ratio kept and
centred. The JAX package resamples with
``jax.image.scale_and_translate(method="linear", antialias=True)``,
whose filter is not ``F.interpolate``'s: ``weight_matrix`` is JAX's own
``compute_weight_mat`` (``jax/_src/image/scale.py``, jax 0.9.0) with the
triangle kernel, and the image is contracted with one such matrix per
axis and per image, as two batched matrix products in float32. They
follow ``torch.backends.cuda.matmul.allow_tf32``, False by PyTorch's
default; with it True the letterbox keeps only TF32's ~3 digits.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    input_hw: Tuple[int, int] = (320, 320)


def to_unit_float(images: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] or float [0, 1] -> float32 [0, 1], on the images'
    device (uint8 quarters the upload)."""
    if images.dtype == torch.uint8:
        return images.float() * (1.0 / 255.0)
    return images.float()


def weight_matrix(in_size: int, out_size: int, scale: torch.Tensor,
                  translation: torch.Tensor) -> torch.Tensor:
    """[B, in, out] resampling weights of a linear, antialiased
    scale-and-translate along one axis, one matrix per image (``scale``
    and ``translation`` [B] float32): output pixel o samples the input at
    (o + 0.5 - translation) / scale - 0.5 with a triangle kernel widened
    by 1 / scale when downsampling, normalised per output pixel (zero
    where the weights sum to at most 1000 eps) and zero where the sample
    lies outside [-0.5, in - 0.5]."""
    dev, dt = scale.device, scale.dtype
    inv_scale = (1.0 / scale)[:, None]
    kernel_scale = torch.clamp(inv_scale, min=1.0)[:, None]
    sample = ((torch.arange(out_size, dtype=dt, device=dev) + 0.5) * inv_scale
              - translation[:, None] * inv_scale - 0.5)  # [B, out]
    x = (sample[:, None, :] - torch.arange(in_size, dtype=dt, device=dev)[:, None]).abs()
    weights = torch.clamp(1.0 - (x / kernel_scale).abs(), min=0.0)  # [B, in, out]
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def eval_batch(images: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
               image_hw: torch.Tensor, cfg: AugmentConfig
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deterministic letterbox of a batch of staging squares.

    images [B, S, S, 3] uint8 or float [0, 1]; boxes [B, T, 5] (x1, y1,
    x2, y2, cls) normalised to the original image; valid [B, T] bool;
    image_hw [B, 2] original (H, W) float32. Returns (images [B, H, W, 3]
    float32 in [0, 1], boxes [B, T, 5] in network-input pixels, clipped,
    zero where dropped, keep [B, T]: valid and wider and taller than one
    pixel)."""
    images = to_unit_float(images)
    b, s = images.shape[0], images.shape[1]
    out_h, out_w = cfg.input_hw
    h, w = float(out_h), float(out_w)
    ih, iw = image_hw[:, 0], image_hw[:, 1]
    r = torch.minimum(w / iw, h / ih)
    nw, nh = iw * r, ih * r
    dx, dy = (w - nw) / 2.0, (h - nh) / 2.0

    wy = weight_matrix(s, out_h, nh / s, dy)  # [B, S, H]
    wx = weight_matrix(s, out_w, nw / s, dx)  # [B, S, W]
    rows = torch.bmm(wy.transpose(1, 2), images.reshape(b, s, s * 3))  # [B, H, S * 3]
    rows = rows.reshape(b, out_h, s, 3).transpose(2, 3).reshape(b, out_h * 3, s)
    out = torch.bmm(rows, wx).reshape(b, out_h, 3, out_w).transpose(2, 3)
    out = torch.clamp(out, 0.0, 1.0).contiguous()

    nw, nh, dx, dy = nw[:, None], nh[:, None], dx[:, None], dy[:, None]
    x1 = torch.clamp(boxes[..., 0] * nw + dx, 0.0, w - 1)
    y1 = torch.clamp(boxes[..., 1] * nh + dy, 0.0, h - 1)
    x2 = torch.clamp(boxes[..., 2] * nw + dx, 0.0, w - 1)
    y2 = torch.clamp(boxes[..., 3] * nh + dy, 0.0, h - 1)
    keep = valid & ((x2 - x1) > 1.0) & ((y2 - y1) > 1.0)
    new_boxes = torch.stack([x1, y1, x2, y2, boxes[..., 4]], dim=-1)
    new_boxes = torch.where(keep[..., None], new_boxes, torch.zeros_like(new_boxes))
    return out, new_boxes, keep
