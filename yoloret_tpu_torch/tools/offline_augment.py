"""Offline dataset expansion: cutout / mixup / 4-image mosaic. A copy of
the JAX package's ``yoloret_tpu/tools/offline_augment.py`` on the port's
``data/annotations.py`` and ``tools/autoaugment.py``, with the same
seeded ``random`` and numpy draws: one seed writes the same files.

numpy+PIL reimplementation of the reference's standalone script
(reference: code/augment_data.py:69-192 — which oddly used PyTorch
tensors for image math, :5-6). Writes augmented JPEGs next to an
extended annotation list, as the reference's main loop does (:194-327).

Semantics matched:
  * cutout: random erase patches; a GT box is DROPPED when the erased
    overlap of the box exceeds ``remove_thresh`` of its area (:69-120),
  * mixup: pixel-average two images, union of boxes (:122-145),
  * mosaic: 4 images on a 640x640 canvas around a random center
    (:148-192), boxes shifted and clipped.
"""

from __future__ import annotations

import os
import random
from typing import List, Sequence, Tuple

import numpy as np

from yoloret_tpu_torch.data.annotations import parse_annotation_line


def cutout(
    image: np.ndarray,
    boxes: np.ndarray,
    *,
    n_holes: int = 1,
    max_frac: float = 0.4,
    remove_thresh: float = 0.6,
    rng: random.Random | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Erase random rectangles; drop boxes mostly covered by the holes."""
    rng = rng or random
    h, w = image.shape[:2]
    out = image.copy()
    covered = np.zeros((len(boxes),), np.float64)
    areas = np.maximum(
        (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]), 1.0
    ) if len(boxes) else np.zeros((0,))
    for _ in range(n_holes):
        ch = int(rng.uniform(0.1, max_frac) * h)
        cw = int(rng.uniform(0.1, max_frac) * w)
        y = rng.randint(0, max(h - ch, 1))
        x = rng.randint(0, max(w - cw, 1))
        out[y : y + ch, x : x + cw] = 127
        for i, b in enumerate(boxes):
            ix = max(0.0, min(b[2], x + cw) - max(b[0], x))
            iy = max(0.0, min(b[3], y + ch) - max(b[1], y))
            covered[i] += ix * iy
    keep = covered / areas <= remove_thresh if len(boxes) else np.ones((0,), bool)
    return out, boxes[keep]


def mixup(
    img_a: np.ndarray, boxes_a: np.ndarray, img_b: np.ndarray, boxes_b: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Pixel-average two images (resized to A's size), union the boxes."""
    from PIL import Image

    ha, wa = img_a.shape[:2]
    if img_b.shape[:2] != (ha, wa):
        sb = np.asarray(Image.fromarray(img_b).resize((wa, ha), Image.BILINEAR))
        sy, sx = ha / img_b.shape[0], wa / img_b.shape[1]
        boxes_b = boxes_b.copy()
        if len(boxes_b):
            boxes_b[:, [0, 2]] *= sx
            boxes_b[:, [1, 3]] *= sy
        img_b = sb
    mixed = ((img_a.astype(np.float32) + img_b.astype(np.float32)) / 2).astype(np.uint8)
    boxes = np.concatenate([boxes_a, boxes_b], axis=0) if len(boxes_b) else boxes_a
    return mixed, boxes


def mosaic(
    images: Sequence[np.ndarray],
    boxes_list: Sequence[np.ndarray],
    *,
    size: int = 640,
    rng: random.Random | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """4-image mosaic on a size x size canvas (reference :148-192)."""
    from PIL import Image

    assert len(images) == 4
    rng = rng or random
    canvas = np.full((size, size, 3), 114, np.uint8)
    cx = int(rng.uniform(size * 0.3, size * 0.7))
    cy = int(rng.uniform(size * 0.3, size * 0.7))
    quads = [
        (0, 0, cx, cy),
        (cx, 0, size - cx, cy),
        (0, cy, cx, size - cy),
        (cx, cy, size - cx, size - cy),
    ]
    out_boxes: List[np.ndarray] = []
    for (x0, y0, qw, qh), img, boxes in zip(quads, images, boxes_list):
        if qw < 2 or qh < 2:
            continue
        ih, iw = img.shape[:2]
        resized = np.asarray(Image.fromarray(img).resize((qw, qh), Image.BILINEAR))
        canvas[y0 : y0 + qh, x0 : x0 + qw] = resized
        if len(boxes):
            b = boxes.copy().astype(np.float64)
            b[:, [0, 2]] = b[:, [0, 2]] * (qw / iw) + x0
            b[:, [1, 3]] = b[:, [1, 3]] * (qh / ih) + y0
            b[:, 0] = np.clip(b[:, 0], x0, x0 + qw)
            b[:, 2] = np.clip(b[:, 2], x0, x0 + qw)
            b[:, 1] = np.clip(b[:, 1], y0, y0 + qh)
            b[:, 3] = np.clip(b[:, 3], y0, y0 + qh)
            ok = (b[:, 2] - b[:, 0] > 2) & (b[:, 3] - b[:, 1] > 2)
            if ok.any():
                out_boxes.append(b[ok])
    boxes = np.concatenate(out_boxes, axis=0) if out_boxes else np.zeros((0, 5))
    return canvas, boxes


def _fmt_line(path: str, boxes: np.ndarray) -> str:
    toks = [path]
    for b in boxes:
        toks.append(
            f"{int(round(b[0]))},{int(round(b[1]))},{int(round(b[2]))},{int(round(b[3]))},{int(b[4])}"
        )
    return " ".join(toks)


def augment_dataset(
    annotation_file: str,
    out_dir: str,
    out_list: str,
    *,
    n_cutout: int = 0,
    n_mixup: int = 0,
    n_mosaic: int = 0,
    n_autoaugment: int = 0,
    aa_policy: str = "v0",
    seed: int = 0,
) -> int:
    """Generate augmented JPEGs + an extended list (original lines kept),
    as the reference's main loop does (augment_data.py:194-327)."""
    from PIL import Image

    rng = random.Random(seed)
    os.makedirs(out_dir, exist_ok=True)
    with open(annotation_file) as f:
        lines = [l.strip() for l in f if l.strip()]
    parsed = [parse_annotation_line(l) for l in lines]

    def load(i):
        path, boxes = parsed[i]
        return np.asarray(Image.open(path).convert("RGB")), boxes

    new_lines = list(lines)
    serial = 0

    def emit(img, boxes, tag):
        nonlocal serial
        p = os.path.join(out_dir, f"aug_{tag}_{serial:06d}.jpg")
        serial += 1
        Image.fromarray(img).save(p, quality=95)
        new_lines.append(_fmt_line(p, boxes))

    for _ in range(n_cutout):
        img, boxes = load(rng.randrange(len(parsed)))
        out, kept = cutout(img, boxes, rng=rng)
        emit(out, kept, "cutout")
    for _ in range(n_mixup):
        ia, ba = load(rng.randrange(len(parsed)))
        ib, bb = load(rng.randrange(len(parsed)))
        out, kept = mixup(ia, ba, ib, bb)
        emit(out, kept, "mixup")
    for _ in range(n_mosaic):
        idxs = [rng.randrange(len(parsed)) for _ in range(4)]
        imgs, bxs = zip(*[load(i) for i in idxs])
        out, kept = mosaic(imgs, bxs, rng=rng)
        emit(out, kept, "mosaic")
    if n_autoaugment:
        from yoloret_tpu_torch.tools.autoaugment import distort_image_with_autoaugment

        nprng = np.random.RandomState(seed)
        for _ in range(n_autoaugment):
            img, boxes = load(rng.randrange(len(parsed)))
            out, kept = distort_image_with_autoaugment(
                img, boxes, policy=aa_policy, rng=nprng
            )
            if len(kept):  # a sub-policy can push every box off-image
                emit(out, kept, "aa")

    with open(out_list, "w") as f:
        f.write("\n".join(new_lines) + "\n")
    return len(new_lines)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="offline cutout/mixup/mosaic dataset expansion "
        "(the reference's augment_data.py as a CLI)"
    )
    p.add_argument("annotation_file")
    p.add_argument("out_dir")
    p.add_argument("out_list")
    p.add_argument("--cutout", type=int, default=0)
    p.add_argument("--mixup", type=int, default=0)
    p.add_argument("--mosaic", type=int, default=0)
    p.add_argument("--autoaugment", type=int, default=0,
                   help="AutoAugment-for-detection samples (tools/autoaugment.py)")
    p.add_argument("--aa_policy", type=str, default="v0")
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    n = augment_dataset(
        a.annotation_file, a.out_dir, a.out_list,
        n_cutout=a.cutout, n_mixup=a.mixup, n_mosaic=a.mosaic,
        n_autoaugment=a.autoaugment, aa_policy=a.aa_policy, seed=a.seed,
    )
    print(f"{n} lines -> {a.out_list}")


if __name__ == "__main__":
    main()
