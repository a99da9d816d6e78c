"""Augmentation on the device. Port of ``yoloret_tpu/data/augment.py``:
``AugmentConfig``, the training chain (``augment_batch``), the online
mosaic and mixup (``mix_batch``) and the evaluation letterbox
(``eval_batch``), batched over B instead of vmapped.

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

Training composes the whole geometric chain (aspect jitter, scale
0.25-2x of the staging square, placement, with the antialiased filter
when it shrinks) into the same two products per image, then flips and
runs the photometric chain (HSV with ``tf.image`` semantics, brightness,
gamma, contrast, noise, blur) elementwise. Its random draws are the
JAX package's, per sample and with its distributions (``draw_augment``),
from a ``torch.Generator`` instead of JAX keys: the transform
(``augment_batch``) takes them as tensors, so the same draws give the
JAX package's images and boxes. The same holds for the mixing draws
(``draw_mix``, ``mix_batch``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """The JAX package's ``AugmentConfig``, field for field."""

    input_hw: Tuple[int, int] = (320, 320)
    min_scale: float = 0.25
    max_scale: float = 2.0
    jitter: float = 0.3
    flip: bool = True
    hue: float = 0.5
    sat: float = 0.5
    val: float = 0.0
    min_gamma: float = 0.8
    max_gamma: float = 2.0
    contrast: float = 0.1
    noise: float = 0.0  # additive uniform noise amplitude (off by default)
    blur: bool = False  # 5x5 gaussian blur (off by default)
    max_boxes: int = 20
    mosaic_prob: float = 0.0  # online 2x2 mosaic, per sample (mix_batch)
    mixup_prob: float = 0.0  # online mixup, per sample; mosaic wins when both fire


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


def resample(images: torch.Tensor, out_hw: Tuple[int, int], scale_yx: Tuple[torch.Tensor, ...],
             trans_yx: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """[B, Sh, Sw, 3] float32 -> [B, H, W, 3]: each image scaled by
    (scale_y, scale_x) [B] and translated by (dy, dx) [B], with the
    linear antialiased filter of ``weight_matrix``, zero outside."""
    b, sh, sw = images.shape[:3]
    out_h, out_w = out_hw
    wy = weight_matrix(sh, out_h, scale_yx[0], trans_yx[0])  # [B, Sh, H]
    wx = weight_matrix(sw, out_w, scale_yx[1], trans_yx[1])  # [B, Sw, W]
    rows = torch.bmm(wy.transpose(1, 2), images.reshape(b, sh, sw * 3))  # [B, H, Sw * 3]
    rows = rows.reshape(b, out_h, sw, 3).transpose(2, 3).reshape(b, out_h * 3, sw)
    return torch.bmm(rows, wx).reshape(b, out_h, 3, out_w).transpose(2, 3)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """``tf.image.rgb_to_hsv`` over the last axis."""
    r, g, b = rgb.unbind(-1)
    mx = rgb.amax(-1)
    mn = rgb.amin(-1)
    diff = mx - mn
    one = torch.ones_like(diff)
    safe = torch.where(diff > 0, diff, one)
    h = torch.where(mx == r, (g - b) / safe,
                    torch.where(mx == g, 2.0 + (b - r) / safe, 4.0 + (r - g) / safe))
    h = torch.where(diff > 0, (h / 6.0) % 1.0, torch.zeros_like(h))
    s = torch.where(mx > 0, diff / torch.where(mx > 0, mx, one), torch.zeros_like(mx))
    return torch.stack([h, s, mx], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """``tf.image.hsv_to_rgb`` over the last axis."""
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int32) % 6

    def select(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def draw_augment(batch: int, cfg: AugmentConfig, generator: torch.Generator,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """One batch's draws, per sample, with the JAX package's
    distributions (``_augment_one``): the two aspect-jitter factors
    U(1 - j, 1 + j), the scale U(min_scale, max_scale), the placement
    fractions U(0, 1), the flip (p 0.5), the hue shift U(-hue, hue), the
    saturation factor U(1 - sat, 1 + sat), the brightness delta
    U(-val, val), the gamma U(min_gamma, max_gamma), the contrast factor
    U(1 - c, 1 + c), and with ``noise`` the noise field U(0, noise)
    [B, H, W, 3]. Drawn on the CPU from ``generator`` (the noise field
    too) and sent to ``device`` in one copy."""
    u = torch.rand(batch, 11, generator=generator)
    j, c = cfg.jitter, cfg.contrast

    def span(k, lo, hi):
        return lo + (hi - lo) * u[:, k]

    draws = {
        "ar_num": span(0, 1 - j, 1 + j), "ar_den": span(1, 1 - j, 1 + j),
        "scale": span(2, cfg.min_scale, cfg.max_scale),
        "fx": u[:, 3], "fy": u[:, 4], "flip": u[:, 5] < 0.5,
        "hue": span(6, -cfg.hue, cfg.hue), "sat": span(7, 1 - cfg.sat, 1 + cfg.sat),
        "val": span(8, -cfg.val, cfg.val),
        "gamma": span(9, cfg.min_gamma, cfg.max_gamma), "contrast": span(10, 1 - c, 1 + c),
    }
    if cfg.noise > 0:
        draws["noise"] = torch.rand((batch, *cfg.input_hw, 3), generator=generator) * cfg.noise
    return {k: v.to(device, non_blocking=True) for k, v in draws.items()}


def augment_batch(images: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                  cfg: AugmentConfig, draws: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The training augmentation of a batch (the JAX package's
    ``augment_batch``) with the per-sample ``draws`` of ``draw_augment``.

    images [B, S, S, 3] uint8 or float [0, 1] staging squares; boxes
    [B, T, 5] (x1, y1, x2, y2, cls) normalised to the original image;
    valid [B, T]. Returns (images [B, H, W, 3] float32 in [0, 1], boxes
    [B, T, 5] in network-input pixels, clipped, zero where dropped, keep
    [B, T]: valid and wider and taller than one pixel)."""
    images = to_unit_float(images)
    s = images.shape[1]
    out_h, out_w = cfg.input_hw
    h, w = float(out_h), float(out_w)
    j = draws

    # geometry: aspect jitter, scale, placement, as one warp per image
    new_ar = (w / h) * j["ar_num"] / j["ar_den"]
    scale = j["scale"]
    tall = new_ar < 1
    ratio = torch.clamp(torch.where(tall, scale * new_ar, scale / new_ar), min=1.0)
    nw = torch.where(tall, ratio * h, scale * w)
    nh = torch.where(tall, scale * h, ratio * w)
    dx = j["fx"] * (w - nw)
    dy = j["fy"] * (h - nh)
    out = resample(images, (out_h, out_w), (nh / s, nw / s), (dy, dx))

    nw, nh, dx, dy = nw[:, None], nh[:, None], dx[:, None], dy[:, None]
    x1 = boxes[..., 0] * nw + dx
    y1 = boxes[..., 1] * nh + dy
    x2 = boxes[..., 2] * nw + dx
    y2 = boxes[..., 3] * nh + dy

    def per_image(v):
        return v.reshape(-1, 1, 1, 1)

    if cfg.flip:
        flip = j["flip"]
        out = torch.where(per_image(flip), out.flip(2), out)
        x1, x2 = (torch.where(flip[:, None], w - x2, x1), torch.where(flip[:, None], w - x1, x2))

    # photometric chain
    if cfg.hue > 0 or cfg.sat > 0:
        hh, ss, vv = rgb_to_hsv(torch.clamp(out, 0.0, 1.0)).unbind(-1)
        if cfg.hue > 0:
            hh = (hh + j["hue"].reshape(-1, 1, 1)) % 1.0
        if cfg.sat > 0:
            ss = torch.clamp(ss * j["sat"].reshape(-1, 1, 1), 0.0, 1.0)
        out = hsv_to_rgb(torch.stack([hh, ss, vv], dim=-1))
    if cfg.val > 0:
        out = out + per_image(j["val"])
    if cfg.min_gamma < cfg.max_gamma:
        out = torch.clamp(out, 0.0, 1.0) ** per_image(j["gamma"])
    if cfg.contrast > 0:
        mean = out.mean(dim=(1, 2), keepdim=True)
        out = (out - mean) * per_image(j["contrast"]) + mean
    if cfg.noise > 0:
        out = out + j["noise"]
    if cfg.blur:
        g = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=out.device)
        kern = (g[:, None] * g[None, :] / 256.0).expand(3, 1, 5, 5)
        out = F.conv2d(out.permute(0, 3, 1, 2), kern, padding=2, groups=3).permute(0, 2, 3, 1)
    out = torch.clamp(out, 0.0, 1.0).contiguous()

    # clip the boxes, drop the degenerate ones
    x1 = torch.clamp(x1, 0.0, w - 1)
    x2 = torch.clamp(x2, 0.0, w - 1)
    y1 = torch.clamp(y1, 0.0, h - 1)
    y2 = torch.clamp(y2, 0.0, h - 1)
    keep = valid & ((x2 - x1) > 1.0) & ((y2 - y1) > 1.0)
    new_boxes = torch.stack([x1, y1, x2, y2, boxes[..., 4]], dim=-1)
    new_boxes = torch.where(keep[..., None], new_boxes, torch.zeros_like(new_boxes))
    return out, new_boxes, keep


def draw_mix(batch: int, cfg: AugmentConfig, generator: torch.Generator,
             device: torch.device) -> Dict[str, torch.Tensor]:
    """One batch's mixing draws, per sample, with the JAX package's
    distributions (``mix_batch``): ``do_mosaic`` (U(0, 1) < mosaic_prob),
    ``do_mixup`` (not ``do_mosaic`` and U(0, 1) < mixup_prob) and the
    mixup weight ``lam`` U(0, 1) [B, 1, 1, 1]. Drawn on the CPU from
    ``generator`` and sent to ``device`` in one copy."""
    u = torch.rand(batch, 3, generator=generator)
    do_mosaic = u[:, 0] < cfg.mosaic_prob
    draws = {"do_mosaic": do_mosaic, "do_mixup": ~do_mosaic & (u[:, 1] < cfg.mixup_prob),
             "lam": u[:, 2].reshape(batch, 1, 1, 1)}
    return {k: v.to(device, non_blocking=True) for k, v in draws.items()}


def mix_batch(images: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
              cfg: AugmentConfig, draws: Dict[str, torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Online mosaic and mixup of a batch (the JAX package's
    ``mix_batch``), after ``augment_batch``, with the draws of
    ``draw_mix``. The mix partners are rows of the same batch: row i takes
    rows i+1, i+2, i+3 (mod B) for its mosaic and row i+B/2 for its mixup.

    Per sample: with ``do_mosaic``, a 2x2 mosaic of rows i..i+3 at half
    scale (the antialiased linear resize of ``resample``), the centre
    fixed at (W/2, H/2), each quadrant's boxes halved, moved, clipped to
    [0, W-1] x [0, H-1] and kept when wider and taller than one pixel;
    else with ``do_mixup``, ``lam * row i + (1 - lam) * row i+B/2`` with
    the union of both rows' boxes; else unchanged.

    images [B, H, W, 3] float32; boxes [B, T, 5] (x1, y1, x2, y2, cls) in
    input pixels; valid [B, T]. Returns (images, boxes [B, cap*T, 5],
    valid [B, cap*T]), cap 4 with mosaic on, 2 with mixup alone; with both
    probabilities 0 the inputs as they are."""
    mosaic_on, mixup_on = cfg.mosaic_prob > 0, cfg.mixup_prob > 0
    if not (mosaic_on or mixup_on):
        return images, boxes, valid
    b, h, w, _ = images.shape
    t = boxes.shape[1]
    cap = (4 if mosaic_on else 2) * t

    def roll(x, s):  # row i takes row i + s
        return torch.roll(x, -s, dims=0)

    def pad_cap(bx, v):
        extra = cap - bx.shape[1]
        return F.pad(bx, (0, 0, 0, extra)), F.pad(v, (0, extra))

    def per_row(flag, x):
        return flag.reshape(-1, *([1] * (x.dim() - 1)))

    boxes = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    out_img = images
    out_boxes, out_valid = pad_cap(boxes, valid)

    if mixup_on:
        p = b // 2
        lam = draws["lam"]
        mix_img = images * lam + roll(images, p) * (1.0 - lam)
        mix_boxes, mix_valid = pad_cap(torch.cat([boxes, roll(boxes, p)], dim=1),
                                       torch.cat([valid, roll(valid, p)], dim=1))
        do = draws["do_mixup"]
        out_img = torch.where(per_row(do, out_img), mix_img, out_img)
        out_boxes = torch.where(per_row(do, out_boxes), mix_boxes, out_boxes)
        out_valid = torch.where(per_row(do, out_valid), mix_valid, out_valid)

    if mosaic_on:
        h2, w2 = h // 2, w // 2
        scale = (torch.full((b,), h2 / h, device=images.device),
                 torch.full((b,), w2 / w, device=images.device))
        shift = torch.zeros(b, device=images.device)
        small = resample(images, (h2, w2), scale, (shift, shift))
        mosaic_img = torch.cat([torch.cat([small, roll(small, 1)], dim=2),
                                torch.cat([roll(small, 2), roll(small, 3)], dim=2)], dim=1)

        def quad(bx, v, ox, oy):
            x = torch.clamp(bx[..., [0, 2]] * 0.5 + ox, 0.0, float(w - 1))  # x1, x2
            y = torch.clamp(bx[..., [1, 3]] * 0.5 + oy, 0.0, float(h - 1))  # y1, y2
            keep = v & ((x[..., 1] - x[..., 0]) > 1.0) & ((y[..., 1] - y[..., 0]) > 1.0)
            return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1], bx[..., 4]], -1), keep

        quads = [quad(roll(boxes, k), roll(valid, k), ox, oy)
                 for k, (ox, oy) in enumerate(((0.0, 0.0), (float(w2), 0.0), (0.0, float(h2)),
                                               (float(w2), float(h2))))]
        do = draws["do_mosaic"]
        out_img = torch.where(per_row(do, out_img), mosaic_img, out_img)
        out_boxes = torch.where(per_row(do, out_boxes), torch.cat([q for q, _ in quads], dim=1),
                                out_boxes)
        out_valid = torch.where(per_row(do, out_valid), torch.cat([v for _, v in quads], dim=1),
                                out_valid)

    out_boxes = torch.where(out_valid[..., None], out_boxes, torch.zeros_like(out_boxes))
    return out_img, out_boxes, out_valid


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
    s = images.shape[1]
    out_h, out_w = cfg.input_hw
    h, w = float(out_h), float(out_w)
    ih, iw = image_hw[:, 0], image_hw[:, 1]
    r = torch.minimum(w / iw, h / ih)
    nw, nh = iw * r, ih * r
    dx, dy = (w - nw) / 2.0, (h - nh) / 2.0
    out = resample(images, (out_h, out_w), (nh / s, nw / s), (dy, dx))
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
