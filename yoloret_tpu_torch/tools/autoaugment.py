"""AutoAugment for object detection, on the host (numpy and PIL). A copy
of the JAX package's ``yoloret_tpu/tools/autoaugment.py``: the same ops,
policies, ``np.random.RandomState`` draws in the same order and PIL
calls, so the same seed gives the same image and boxes bit for bit.
The training stream applies it per sample on the staging square
(``data/pipeline.py``, ``Dataset(aa_policy=...)``).

Equivalent of the reference's vendored TF AutoAugment-for-detection
(reference: code/yolo3/autoaugment_v1.py, entry point
``distort_image_with_autoaugment`` at :1654-1684; policies from Zoph et
al., "Learning Data Augmentation Strategies for Object Detection").

Design: every geometric op goes through ONE affine core -- the image is
warped with PIL (which maps output->input, so it gets the inverse
matrix) and the boxes' corners are mapped with the FORWARD matrix, so
image and boxes stay consistent by construction.

Boxes are [N, 5] float (x1, y1, x2, y2, class) in pixels.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

GRAY = 128  # replace/fill value, matches the TF implementation
_MAX_LEVEL = 10.0


# ---- affine core ---------------------------------------------------------

def _affine(image: np.ndarray, boxes: np.ndarray, m: np.ndarray):
    """Apply forward 2x3 affine ``m`` (maps input (x, y, 1) -> output
    (x', y')) to image and boxes."""
    from PIL import Image

    h, w = image.shape[:2]
    m3 = np.vstack([m, [0.0, 0.0, 1.0]])
    inv = np.linalg.inv(m3)
    pil = Image.fromarray(image)
    out = pil.transform(
        (w, h), Image.AFFINE,
        data=tuple(inv[:2].ravel()),
        resample=Image.BILINEAR,
        fillcolor=(GRAY, GRAY, GRAY),
    )
    if boxes.size == 0:
        return np.asarray(out), boxes.reshape(0, 5)
    corners = np.stack([
        boxes[:, [0, 1]], boxes[:, [2, 1]], boxes[:, [0, 3]], boxes[:, [2, 3]]
    ], axis=1)  # [N, 4, 2]
    ones = np.ones((*corners.shape[:2], 1))
    mapped = np.concatenate([corners, ones], -1) @ m.T  # [N, 4, 2]
    new = boxes.copy()
    new[:, 0] = mapped[..., 0].min(1)
    new[:, 1] = mapped[..., 1].min(1)
    new[:, 2] = mapped[..., 0].max(1)
    new[:, 3] = mapped[..., 1].max(1)
    new[:, [0, 2]] = np.clip(new[:, [0, 2]], 0, w)
    new[:, [1, 3]] = np.clip(new[:, [1, 3]], 0, h)
    keep = (new[:, 2] - new[:, 0] >= 1) & (new[:, 3] - new[:, 1] >= 1)
    return np.asarray(out), new[keep]


def _translate(image, boxes, dx=0.0, dy=0.0):
    return _affine(image, boxes, np.array([[1.0, 0.0, dx], [0.0, 1.0, dy]]))


def _shear(image, boxes, sx=0.0, sy=0.0):
    return _affine(image, boxes, np.array([[1.0, sx, 0.0], [sy, 1.0, 0.0]]))


def _rotate(image, boxes, degrees):
    h, w = image.shape[:2]
    cx, cy = w / 2.0, h / 2.0
    t = np.deg2rad(degrees)
    c, s = np.cos(t), np.sin(t)
    # rotate about the image center
    m = np.array([
        [c, -s, cx - c * cx + s * cy],
        [s, c, cy - s * cx - c * cy],
    ])
    return _affine(image, boxes, m)


# ---- color / pixel ops ---------------------------------------------------

def _enhance(image, kind: str, factor: float):
    from PIL import Image, ImageEnhance

    enh = getattr(ImageEnhance, kind)(Image.fromarray(image))
    return np.asarray(enh.enhance(factor))


def _equalize(image):
    from PIL import Image, ImageOps

    return np.asarray(ImageOps.equalize(Image.fromarray(image)))


def _solarize(image, threshold=128):
    return np.where(image < threshold, image, 255 - image).astype(np.uint8)


def _cutout(image, pad: int, rng):
    h, w = image.shape[:2]
    if pad <= 0:
        return image
    cy, cx = rng.randint(0, h), rng.randint(0, w)
    y0, y1 = max(0, cy - pad), min(h, cy + pad)
    x0, x1 = max(0, cx - pad), min(w, cx + pad)
    out = image.copy()
    out[y0:y1, x0:x1] = GRAY
    return out


def _apply_only_bboxes(image, boxes, prob, rng, region_fn):
    """Apply ``region_fn(region, rng) -> region`` to the pixel CONTENT
    inside each gt box (boxes stay put), each with probability ``prob``
    -- the reference's *_Only_BBoxes machinery
    (autoaugment_v1.py `_apply_multi_bbox_augmentation`)."""
    out = image.copy()
    h, w = image.shape[:2]
    for b in boxes:
        if rng.rand() >= prob:
            continue
        x0, y0, x1, y1 = (int(round(v)) for v in b[:4])
        x0, y0 = max(0, x0), max(0, y0)
        x1, y1 = min(w, x1), min(h, y1)
        if x1 <= x0 or y1 <= y0:
            continue
        out[y0:y1, x0:x1] = region_fn(out[y0:y1, x0:x1].copy(), rng)
    return out


def _shift_content_y(region, d):
    shifted = np.full_like(region, GRAY)
    rh = region.shape[0]
    d = int(round(d))
    if d >= rh or -d >= rh:
        return shifted
    if d >= 0:
        shifted[d:] = region[: rh - d]
    else:
        shifted[: rh + d] = region[-d:]
    return shifted


def _translate_only_bboxes(image, boxes, dy_px: float, prob: float, rng):
    """TranslateY over box content (the v0 workhorse op)."""
    return _apply_only_bboxes(
        image, boxes, prob, rng, lambda r, _rng: _shift_content_y(r, dy_px)
    )


def _shear_region(region, s, axis):
    from PIL import Image

    rh, rw = region.shape[:2]
    m = np.array([[1.0, s if axis == "x" else 0.0, 0.0],
                  [s if axis == "y" else 0.0, 1.0, 0.0]])
    m3 = np.vstack([m, [0, 0, 1]])
    inv = np.linalg.inv(m3)
    out = Image.fromarray(region).transform(
        (rw, rh), Image.AFFINE, data=tuple(inv[:2].ravel()),
        resample=Image.BILINEAR, fillcolor=(GRAY, GRAY, GRAY),
    )
    return np.asarray(out)


def _bbox_cutout(image, boxes, pad_fraction, rng):
    """Cut a gray region sized by ONE randomly-chosen box, centered at a
    random location anywhere in the IMAGE (reference ``bbox_cutout`` +
    ``_cutout_inside_bbox``, autoaugment_v1.py:1293-1358: mask half-size is
    ``pad_fraction * box_dim/2`` and the center is sampled over the full
    image, so the mask may land partly or wholly outside the box)."""
    if boxes.shape[0] == 0:
        return image
    h, w = image.shape[:2]
    b = boxes[rng.randint(boxes.shape[0])]
    bh = max(1.0, b[3] - b[1])
    bw = max(1.0, b[2] - b[0])
    ph = int(pad_fraction * (bh / 2.0))
    pw = int(pad_fraction * (bw / 2.0))
    if ph <= 0 or pw <= 0:
        return image
    cy, cx = rng.randint(0, h), rng.randint(0, w)
    out = image.copy()
    out[max(0, cy - ph):cy + ph, max(0, cx - pw):cx + pw] = GRAY
    return out


def _autocontrast(image):
    from PIL import Image, ImageOps

    return np.asarray(ImageOps.autocontrast(Image.fromarray(image)))


def _posterize(image, bits):
    # keep bits=0 (full blackout) legal, as the reference's bit-shift
    # posterize does (autoaugment_v1.py:289-292) -- v3's ('Posterize', 0.8, 2)
    # maps to bits=0
    bits = int(np.clip(bits, 0, 8))
    if bits == 0:
        return np.zeros_like(image)
    shift = 8 - bits
    return ((image >> shift) << shift).astype(np.uint8)


def _solarize_add(image, addition, threshold=128):
    img = image.astype(np.int64)
    added = np.clip(img + int(addition), 0, 255)
    return np.where(img < threshold, added, img).astype(np.uint8)


# ---- level -> argument conversions (TF autoaugment conventions) ---------

def _lvl_to_translate(level, rng, max_px=120.0):
    # the reference wires translate_bbox_const=120 to ALL Translate ops --
    # whole-image *_BBox AND *_Only_BBoxes (autoaugment_v1.py:1467-1468,
    # 1681-1682; translate_const=250 is defined but never used there)
    v = level / _MAX_LEVEL * max_px
    return -v if rng.rand() < 0.5 else v


def _lvl_to_shear(level, rng, max_s=0.3):
    v = level / _MAX_LEVEL * max_s
    return -v if rng.rand() < 0.5 else v


def _lvl_to_rotate(level, rng, max_deg=30.0):
    v = level / _MAX_LEVEL * max_deg
    return -v if rng.rand() < 0.5 else v


def _lvl_to_enhance(level):
    return level / _MAX_LEVEL * 1.8 + 0.1


# ---- op table ------------------------------------------------------------

def _make_ops() -> Dict[str, Callable]:
    return {
        "TranslateX_BBox": lambda im, bx, lvl, rng: _translate(
            im, bx, dx=_lvl_to_translate(lvl, rng)),
        "TranslateY_BBox": lambda im, bx, lvl, rng: _translate(
            im, bx, dy=_lvl_to_translate(lvl, rng)),
        "ShearX_BBox": lambda im, bx, lvl, rng: _shear(
            im, bx, sx=_lvl_to_shear(lvl, rng)),
        "ShearY_BBox": lambda im, bx, lvl, rng: _shear(
            im, bx, sy=_lvl_to_shear(lvl, rng)),
        "Rotate_BBox": lambda im, bx, lvl, rng: _rotate(
            im, bx, _lvl_to_rotate(lvl, rng)),
        "Equalize": lambda im, bx, lvl, rng: (_equalize(im), bx),
        "Solarize": lambda im, bx, lvl, rng: (
            # threshold = int(lvl/10 * 256): level 8 -> 204 (mild), matching
            # the reference's _level_wrapper(256) (autoaugment_v1.py:1483-1484)
            _solarize(im, int(lvl / _MAX_LEVEL * 256)), bx),
        "Color": lambda im, bx, lvl, rng: (
            _enhance(im, "Color", _lvl_to_enhance(lvl)), bx),
        "Sharpness": lambda im, bx, lvl, rng: (
            _enhance(im, "Sharpness", _lvl_to_enhance(lvl)), bx),
        "Contrast": lambda im, bx, lvl, rng: (
            _enhance(im, "Contrast", _lvl_to_enhance(lvl)), bx),
        "Brightness": lambda im, bx, lvl, rng: (
            _enhance(im, "Brightness", _lvl_to_enhance(lvl)), bx),
        "Cutout": lambda im, bx, lvl, rng: (
            _cutout(im, int(lvl / _MAX_LEVEL * 100), rng), bx),
        "AutoContrast": lambda im, bx, lvl, rng: (_autocontrast(im), bx),
        "Posterize": lambda im, bx, lvl, rng: (
            _posterize(im, int(lvl / _MAX_LEVEL * 4)), bx),
        "SolarizeAdd": lambda im, bx, lvl, rng: (
            _solarize_add(im, lvl / _MAX_LEVEL * 110), bx),
        "BBox_Cutout": lambda im, bx, lvl, rng: (
            _bbox_cutout(im, bx, lvl / _MAX_LEVEL * 0.75, rng), bx),
        # *_Only_BBoxes ops transform the CONTENT of each gt box (boxes
        # stay put); the sub-policy probability is applied PER BOX, as
        # the reference's _apply_multi_bbox_augmentation does -- the
        # policy runner scales it by 1/3 (_scale_bbox_only_op_probability)
        # and passes it through instead of coin-flipping the whole op
        # (see distort_image_with_autoaugment).
        "TranslateY_Only_BBoxes": lambda im, bx, lvl, rng, prob=1.0: (
            _translate_only_bboxes(
                im, bx, _lvl_to_translate(lvl, rng, max_px=120.0), prob, rng),
            bx),
        "ShearX_Only_BBoxes": lambda im, bx, lvl, rng, prob=1.0: (
            _apply_only_bboxes(
                im, bx, prob, rng,
                lambda r, _rng: _shear_region(r, _lvl_to_shear(lvl, rng), "x")),
            bx),
        "ShearY_Only_BBoxes": lambda im, bx, lvl, rng, prob=1.0: (
            _apply_only_bboxes(
                im, bx, prob, rng,
                lambda r, _rng: _shear_region(r, _lvl_to_shear(lvl, rng), "y")),
            bx),
        "Flip_Only_BBoxes": lambda im, bx, lvl, rng, prob=1.0: (
            _apply_only_bboxes(im, bx, prob, rng, lambda r, _rng: r[:, ::-1]),
            bx),
        "Equalize_Only_BBoxes": lambda im, bx, lvl, rng, prob=1.0: (
            _apply_only_bboxes(im, bx, prob, rng, lambda r, _rng: _equalize(r)),
            bx),
        "Cutout_Only_BBoxes": lambda im, bx, lvl, rng, prob=1.0: (
            _apply_only_bboxes(
                im, bx, prob, rng,
                # reference wires Cutout_Only_BBoxes to cutout_const=100, same
                # as whole-image Cutout (autoaugment_v1.py:1530-1531, 1681)
                lambda r, _rng: _region_cutout(r, int(lvl / _MAX_LEVEL * 100), _rng)),
            bx),
    }


ONLY_BBOX_OPS = frozenset(
    n for n in (
        "TranslateY_Only_BBoxes", "ShearX_Only_BBoxes", "ShearY_Only_BBoxes",
        "Flip_Only_BBoxes", "Equalize_Only_BBoxes", "Cutout_Only_BBoxes",
    )
)


def _region_cutout(region, pad, rng):
    rh, rw = region.shape[:2]
    if pad <= 0 or rh == 0 or rw == 0:
        return region
    cy, cx = rng.randint(0, rh), rng.randint(0, rw)
    region[max(0, cy - pad):cy + pad, max(0, cx - pad):cx + pad] = GRAY
    return region


# Detection-AutoAugment policies (reference autoaugment_v1.py
# policy_v0/v1/v2/v3/vtest at :36-144; Zoph et al.): sub-policies of
# (op, probability, magnitude) tuples.
POLICIES: Dict[str, List[List[Tuple[str, float, int]]]] = {
    "v0": [
        [("TranslateX_BBox", 0.6, 4), ("Equalize", 0.8, 10)],
        [("TranslateY_Only_BBoxes", 0.2, 2), ("Cutout", 0.8, 8)],
        [("Sharpness", 0.0, 8), ("ShearX_BBox", 0.4, 0)],
        [("ShearY_BBox", 1.0, 2), ("TranslateY_Only_BBoxes", 0.6, 6)],
        [("Rotate_BBox", 0.6, 10), ("Color", 1.0, 6)],
    ],
    "v1": [
        [("TranslateX_BBox", 0.6, 4), ("Equalize", 0.8, 10)],
        [("TranslateY_Only_BBoxes", 0.2, 2), ("Cutout", 0.8, 8)],
        [("Sharpness", 0.0, 8), ("ShearX_BBox", 0.4, 0)],
        [("ShearY_BBox", 1.0, 2), ("TranslateY_Only_BBoxes", 0.6, 6)],
        [("Rotate_BBox", 0.6, 10), ("Color", 1.0, 6)],
        [("Color", 0.0, 0), ("ShearX_Only_BBoxes", 0.8, 4)],
        [("ShearY_Only_BBoxes", 0.8, 2), ("Flip_Only_BBoxes", 0.0, 10)],
        [("Equalize", 0.6, 10), ("TranslateX_BBox", 0.2, 2)],
        [("Color", 1.0, 10), ("TranslateY_Only_BBoxes", 0.4, 6)],
        [("Rotate_BBox", 0.8, 10), ("Contrast", 0.0, 10)],
        [("Cutout", 0.2, 2), ("Brightness", 0.8, 10)],
        [("Color", 1.0, 6), ("Equalize", 1.0, 2)],
        [("Cutout_Only_BBoxes", 0.4, 6), ("TranslateY_Only_BBoxes", 0.8, 2)],
        [("Color", 0.2, 8), ("Rotate_BBox", 0.8, 10)],
        [("Sharpness", 0.4, 4), ("TranslateY_Only_BBoxes", 0.0, 4)],
        [("Sharpness", 1.0, 4), ("SolarizeAdd", 0.4, 4)],
        [("Rotate_BBox", 1.0, 8), ("Sharpness", 0.2, 8)],
        [("ShearY_BBox", 0.6, 10), ("Equalize_Only_BBoxes", 0.6, 8)],
        [("ShearX_BBox", 0.2, 6), ("TranslateY_Only_BBoxes", 0.2, 10)],
        [("SolarizeAdd", 0.6, 8), ("Brightness", 0.8, 10)],
    ],
    "v2": [
        [("Color", 0.0, 6), ("Cutout", 0.6, 8), ("Sharpness", 0.4, 8)],
        [("Rotate_BBox", 0.4, 8), ("Sharpness", 0.4, 2),
         ("Rotate_BBox", 0.8, 10)],
        [("TranslateY_BBox", 1.0, 8), ("AutoContrast", 0.8, 2)],
        [("AutoContrast", 0.4, 6), ("ShearX_BBox", 0.8, 8),
         ("Brightness", 0.0, 10)],
        [("SolarizeAdd", 0.2, 6), ("Contrast", 0.0, 10),
         ("AutoContrast", 0.6, 0)],
        [("Cutout", 0.2, 0), ("Solarize", 0.8, 8), ("Color", 1.0, 4)],
        [("TranslateY_BBox", 0.0, 4), ("Equalize", 0.6, 8),
         ("Solarize", 0.0, 10)],
        [("TranslateY_BBox", 0.2, 2), ("ShearY_BBox", 0.8, 8),
         ("Rotate_BBox", 0.8, 8)],
        [("Cutout", 0.8, 8), ("Brightness", 0.8, 8), ("Cutout", 0.2, 2)],
        [("Color", 0.8, 4), ("TranslateY_BBox", 1.0, 6), ("Rotate_BBox", 0.6, 6)],
        [("Rotate_BBox", 0.6, 10), ("BBox_Cutout", 1.0, 4), ("Cutout", 0.2, 8)],
        [("Rotate_BBox", 0.0, 0), ("Equalize", 0.6, 6), ("ShearY_BBox", 0.6, 8)],
        [("Brightness", 0.8, 8), ("AutoContrast", 0.4, 2),
         ("Brightness", 0.2, 2)],
        [("TranslateY_BBox", 0.4, 8), ("Solarize", 0.4, 6),
         ("SolarizeAdd", 0.2, 10)],
        [("Contrast", 1.0, 10), ("SolarizeAdd", 0.2, 8), ("Equalize", 0.2, 4)],
    ],
    "v3": [
        [("Posterize", 0.8, 2), ("TranslateX_BBox", 1.0, 8)],
        [("BBox_Cutout", 0.2, 10), ("Sharpness", 1.0, 8)],
        [("Rotate_BBox", 0.6, 8), ("Rotate_BBox", 0.8, 10)],
        [("Equalize", 0.8, 10), ("AutoContrast", 0.2, 10)],
        [("SolarizeAdd", 0.2, 2), ("TranslateY_BBox", 0.2, 8)],
        [("Sharpness", 0.0, 2), ("Color", 0.4, 8)],
        [("Equalize", 1.0, 8), ("TranslateY_BBox", 1.0, 8)],
        [("Posterize", 0.6, 2), ("Rotate_BBox", 0.0, 10)],
        [("AutoContrast", 0.6, 0), ("Rotate_BBox", 1.0, 6)],
        [("Equalize", 0.0, 4), ("Cutout", 0.8, 10)],
        [("Brightness", 1.0, 2), ("TranslateY_BBox", 1.0, 6)],
        [("Contrast", 0.0, 2), ("ShearY_BBox", 0.8, 0)],
        [("AutoContrast", 0.8, 10), ("Contrast", 0.2, 10)],
        [("Rotate_BBox", 1.0, 10), ("Cutout", 1.0, 10)],
        [("SolarizeAdd", 0.8, 6), ("Equalize", 0.8, 8)],
    ],
    # deterministic single-op policy for tests/debugging
    "test": [[("TranslateX_BBox", 1.0, 4)]],
}


def distort_image_with_autoaugment(
    image: np.ndarray,
    boxes: np.ndarray,
    policy: str = "v0",
    rng: Optional[np.random.RandomState] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Apply one randomly-chosen sub-policy of ``policy`` to an HWC
    uint8 image + [N, 5] pixel boxes (reference entry point:
    code/yolo3/autoaugment_v1.py:1654-1684)."""
    if rng is None:
        rng = np.random.RandomState()
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; have {sorted(POLICIES)}")
    ops = _make_ops()
    sub = POLICIES[policy][rng.randint(len(POLICIES[policy]))]
    image = np.ascontiguousarray(image)
    boxes = np.asarray(boxes, np.float64).reshape(-1, 5)
    for name, prob, level in sub:
        if name in ONLY_BBOX_OPS:
            # probability applies PER BOX inside the op, scaled by 1/3 first
            # so crowded scenes aren't over-distorted (reference
            # _scale_bbox_only_op_probability at autoaugment_v1.py:486-493,
            # applied by every *_only_bboxes fn at :716-780)
            image, boxes = ops[name](
                image, boxes, float(level), rng, prob=prob / 3.0)
            continue
        if rng.rand() >= prob:
            continue
        image, boxes = ops[name](image, boxes, float(level), rng)
    return image.astype(np.uint8), boxes
