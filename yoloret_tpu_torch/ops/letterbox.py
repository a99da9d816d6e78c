"""Host-side letterbox (aspect-preserving resize + centred zero pad).
Port of ``yoloret_tpu/ops/letterbox.py`` (``letterbox_params``,
``letterbox_numpy_u8``); PIL bilinear, uint8 out."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def letterbox_params(image_hw: Tuple[int, int], out_hw: Tuple[int, int]):
    """(new_h, new_w, dy, dx) of the resized content inside the canvas,
    with floor arithmetic."""
    ih, iw = image_hw
    h, w = out_hw
    scale = min(w / iw, h / ih)
    nh = int(ih * scale)
    nw = int(iw * scale)
    return nh, nw, (h - nh) // 2, (w - nw) // 2


def letterbox_numpy_u8(image: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Letterbox a [H, W, 3] uint8 (or [0, 1] float) image to out_hw,
    returning uint8 (the device divides by 255)."""
    from PIL import Image

    ih, iw = image.shape[:2]
    nh, nw, dy, dx = letterbox_params((ih, iw), out_hw)
    src = image
    if src.dtype != np.uint8:
        src = np.clip(src * 255.0, 0, 255).astype(np.uint8)
    resized = np.asarray(Image.fromarray(src).resize((nw, nh), Image.BILINEAR), dtype=np.uint8)
    canvas = np.zeros((out_hw[0], out_hw[1], image.shape[-1]), np.uint8)
    canvas[dy:dy + nh, dx:dx + nw] = resized
    return canvas
