"""Candidate-selection accuracy study: the mAP cost of finite candidate
pools in the postprocess. Port of ``yoloret_tpu/tools/topk_study.py``.

The reference runs EXACT per-class NMS over every grid position
(reference: code/yolo3/model.py:470-486). The postprocess bounds the
work with a per-class candidate pool K or a shared pool M. This script
measures what that costs in mAP, on a crowded multi-class synthetic task
trained to PARTIAL convergence so the score landscape is noisy (a fully
overfit model is insensitive -- every config scores 1.0 and the study
says nothing).

The JAX package's study also has rows for ``jax.lax.approx_max_k``
(recall 0.95, approximate on a TPU only). The port's top-k is exact
(``torch.topk``), so it has the exact rows alone: the per-class full
pool, and per-class and shared pools of 64, 256 and 512.

    python -m yoloret_tpu_torch.tools.topk_study [--epochs 60] [--size 160] [--device cuda]

Output: a markdown table of mAP per {pool structure, pool depth}, and the
exact full-pool baseline.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

CLASS_COLORS = [
    (230, 40, 40),
    (40, 230, 40),
    (60, 60, 235),
    (235, 235, 50),
]
CLASS_NAMES = ["red", "green", "blue", "yellow"]
DEPTHS = (64, 256, 512)


def build_crowded(root: str, n: int = 48, hw=(160, 160), seed: int = 0,
                  objects=(6, 11)):
    """Dense scenes: 6-10 rectangles of 4 color classes per image, with
    overlap allowed -- candidate competition actually happens here."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    h, w = hw
    lines = []
    for i in range(n):
        arr = np.full((h, w, 3), 24, np.uint8)
        boxes = []
        for _ in range(int(rng.randint(*objects))):
            bw = int(rng.randint(18, 48))
            bh = int(rng.randint(18, 48))
            x = int(rng.randint(0, w - bw))
            y = int(rng.randint(0, h - bh))
            c = int(rng.randint(0, len(CLASS_COLORS)))
            arr[y : y + bh, x : x + bw] = CLASS_COLORS[c]
            boxes.append((x, y, x + bw, y + bh, c))
        p = os.path.join(root, f"crowd{i}.jpg")
        Image.fromarray(arr).save(p, quality=95)
        lines.append(
            p + " " + " ".join(",".join(map(str, b)) for b in boxes)
        )
    ann = os.path.join(root, f"crowd_train_{n}.txt")
    with open(ann, "w") as f:
        f.write("\n".join(lines) + "\n")
    classes = os.path.join(root, "classes.txt")
    with open(classes, "w") as f:
        f.write("\n".join(CLASS_NAMES) + "\n")
    anchors = os.path.join(root, "anchors.txt")
    with open(anchors, "w") as f:
        f.write("10,13, 16,30, 33,23, 30,61, 62,45, 59,119, 116,90, 156,198, 373,326\n")
    return ann, classes, anchors


def crowded_train_cfg(workdir: str, ann: str, classes: str,
                      anchors_path: str, epochs: int = 60, size: int = 160,
                      batch: int = 8, max_boxes: int = 12):
    """The partial-convergence recipe every crowded-synthetic study
    shares (this study and the accuracy gate): mild augmentation + 60
    epochs is what learns the 4-class task on this dataset in the JAX
    package (the default augmentation at 40 epochs measured mAP 0.0002
    there)."""
    from yoloret_tpu_torch.configs import RunConfig

    return RunConfig(
        backbone="mobilenetv2x75",
        input_size=(size, size),
        train_dataset=ann,
        classes_path=classes,
        anchors_path=anchors_path,
        batch_size=batch,
        epochs=(epochs, epochs),
        learning_rate=(2e-3, 2e-3),
        freeze=False,
        max_boxes=max_boxes,
        augment={"hue": 0.0, "sat": 0.2, "jitter": 0.1,
                 "min_scale": 0.8, "max_scale": 1.2,
                 "min_gamma": 0.9, "max_gamma": 1.2},
        bf16=False,
        mesh_data=1,
        checkpoint_every=10**9,
        log_dir=os.path.join(workdir, "logs"),
        seed=0,
    )


def full_pool(size: int) -> int:
    """Grid positions x 3 anchors at the three strides: the exact pool."""
    return sum((size // s) ** 2 * 3 for s in (32, 16, 8))


def crowded_predictor(weights, anchors_path: str, size: int, device="cuda"):
    """The float32 MAP-grade Predictor (threshold 0) of the study's
    trained weights."""
    from yoloret_tpu_torch.data import load_anchors
    from yoloret_tpu_torch.infer import Predictor

    return Predictor(
        backbone="mobilenetv2x75", weights=weights,
        class_names=CLASS_NAMES, anchors=load_anchors(anchors_path),
        input_hw=(size, size), score_threshold=0.0, bf16=False, device=device,
    )


def eval_table(pred, ann: str, size: int, batch: int = 8, max_boxes: int = 12,
               depths=DEPTHS):
    """mAP of ``pred`` over ``ann`` for the exact per-class full pool and
    each pool structure at each depth: [(pool, top-k, depth, mAP, delta
    against the full pool)], printed as a markdown table."""
    from yoloret_tpu_torch.data import Dataset, DatasetMode
    from yoloret_tpu_torch.eval import evaluate_map

    n_pos = full_pool(size)

    def eval_cfg(pool, k):
        ds = Dataset(ann, batch_size=batch, input_hw=(size, size), mode=DatasetMode.TEST,
                     max_boxes=max_boxes, device=pred.device)
        mAP, _ = evaluate_map(pred, ds, CLASS_NAMES, verbose=False, num_candidates=k, pool=pool)
        return mAP

    rows = []
    baseline = eval_cfg("per_class", n_pos)
    rows.append(("per_class", "exact", f"full ({n_pos})", baseline, 0.0))
    for pool in ("per_class", "shared"):
        for k in depths:
            m = eval_cfg(pool, k)
            rows.append((pool, "exact", str(k), m, m - baseline))

    print(f"\n## Candidate-selection mAP study ({len(CLASS_NAMES)} classes, "
          f"{size}px, {n_pos} positions, partial convergence)\n")
    print("| pool | top-k | depth | mAP | delta vs exact-full |")
    print("|---|---|---|---|---|")
    for pool, kind, k, m, d in rows:
        print(f"| {pool} | {kind} | {k} | {m:.4f} | {d:+.4f} |")
    return rows


def run(epochs: int = 60, size: int = 160, batch: int = 8,
        workdir: str | None = None, max_boxes: int = 12, device="cuda"):
    from yoloret_tpu_torch.device import reproducible
    from yoloret_tpu_torch.train.trainer import train

    workdir = workdir or tempfile.mkdtemp(prefix="yoloret_topk_study_")
    ann, classes, anchors_path = build_crowded(workdir)
    cfg = crowded_train_cfg(workdir, ann, classes, anchors_path,
                            epochs=epochs, size=size, batch=batch,
                            max_boxes=max_boxes)
    with reproducible(device):  # the gate's weights, on one kind of card
        weights = train(cfg, device=device)
        pred = crowded_predictor(weights, anchors_path, size, device)
        return eval_table(pred, ann, size, batch, max_boxes)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--size", type=int, default=160)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    run(a.epochs, a.size, a.batch, device=a.device)


if __name__ == "__main__":
    main()
