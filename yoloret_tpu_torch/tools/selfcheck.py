"""End-to-end learning self-check. Port of
``yoloret_tpu/tools/selfcheck.py``.

Trains the flagship detector on a tiny synthetic dataset (bright
rectangles on dark background, deterministic) through the REAL
trainer + data pipeline, then evaluates VOC mAP with the real
evaluator through the Predictor's kernels. A healthy build overfits
(the JAX package: mAP ~1.0); anything below the threshold means a
wiring/numerics regression somewhere between the pipeline, loss,
optimizer and postprocess. Exit code 1 below the threshold. On the card
the run computes in float32 on deterministic kernels
(``device.reproducible``), so that it gives the same mAP every time.

    python -m yoloret_tpu_torch.tools.selfcheck [--epochs 150] [--size 96] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def build_synthetic(root: str, n: int = 48, hw=(120, 160), seed: int = 0,
                    objects: int = 3):
    """n images with `objects` colored rectangles each. Sized by
    measurement in the JAX package: single-object 16-image data plateaus
    at mAP ~0.02 even at 300 steps (too little positive signal against
    the ~1/567 objectness prior); 48 images x 3 objects reaches mAP 0.63
    by 360 steps and ~1.0 by the 150-epoch default."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    lines = []
    for i in range(n):
        h, w = hw
        arr = np.full((h, w, 3), 24, np.uint8)
        boxes = []
        for k in range(objects):
            bw = int(rng.randint(40, 70))
            bh = int(rng.randint(30, 60))
            x = int(rng.randint(0, w - bw))
            y = int(rng.randint(0, h - bh))
            c = (i + k) % 2
            arr[y : y + bh, x : x + bw] = [(230, 40, 40), (40, 230, 40)][c]
            boxes.append(f"{x},{y},{x + bw},{y + bh},{c}")
        p = os.path.join(root, f"img{i}.jpg")
        Image.fromarray(arr).save(p, quality=95)
        lines.append(p + " " + " ".join(boxes))
    ann = os.path.join(root, f"synth_train_{n}.txt")
    with open(ann, "w") as f:
        f.write("\n".join(lines) + "\n")
    classes = os.path.join(root, "classes.txt")
    with open(classes, "w") as f:
        f.write("red\ngreen\n")
    anchors = os.path.join(root, "anchors.txt")
    with open(anchors, "w") as f:
        f.write("10,13, 16,30, 33,23, 30,61, 62,45, 59,119, 116,90, 156,198, 373,326\n")
    return ann, classes, anchors


def selfcheck_cfg(workdir: str, ann: str, classes: str, anchors_path: str,
                  epochs: int = 30, size: int = 96, batch: int = 8, seed: int = 0):
    """The self-check's training recipe (the JAX package's, seed 0 there);
    ``seed`` draws the weights' init and the training stream."""
    from yoloret_tpu_torch.configs import RunConfig

    return RunConfig(
        backbone="mobilenetv2x75",
        input_size=(size, size),
        train_dataset=ann,
        classes_path=classes,
        anchors_path=anchors_path,
        batch_size=batch,
        epochs=(epochs, epochs),
        learning_rate=(2e-3, 2e-3),  # stage-2 lr applies (freeze=False)
        freeze=False,  # train everything: random init, no ImageNet here
        # Gentle augmentation: the synthetic classes are COLORS, so the
        # reference's hue +-0.5 would swap the labels; objectness also
        # needs hundreds of steps at this scale, so keep geometry mild.
        augment={"hue": 0.0, "sat": 0.2, "jitter": 0.1,
                 "min_scale": 0.8, "max_scale": 1.2,
                 "min_gamma": 0.9, "max_gamma": 1.2},
        bf16=False,
        mesh_data=1,
        checkpoint_every=10**9,  # no periodic ckpt in the self-check
        log_dir=os.path.join(workdir, "logs"),
        train_unfreeze=None,
        seed=seed,
    )


def evaluate(weights, ann: str, anchors_path: str, size: int = 96, batch: int = 8,
             device="cuda", verbose: bool = True, **predictor_kw) -> float:
    """VOC mAP of the trained ``weights`` (a weight file or state dict)
    over ``ann`` through a MAP-grade Predictor (threshold 0; float32
    unless ``predictor_kw`` says ``bf16=True``; ``use_int8=True``
    calibrates the int8 backbone on up to 32 letterboxed images of
    ``ann``)."""
    from yoloret_tpu_torch.configs import RunConfig
    from yoloret_tpu_torch.data import Dataset, DatasetMode, load_anchors
    from yoloret_tpu_torch.eval import evaluate_map
    from yoloret_tpu_torch.infer import Predictor
    from yoloret_tpu_torch.infer.predictor import int8_options

    kw = {"bf16": False, **predictor_kw}
    if kw.get("use_int8"):
        kw.update(int8_options(RunConfig(test_dataset=ann, input_size=(size, size), int8=True)))
    pred = Predictor(
        backbone="mobilenetv2x75", weights=weights,
        class_names=["red", "green"], anchors=load_anchors(anchors_path),
        input_hw=(size, size), score_threshold=0.0, device=device, **kw,
    )
    ds = Dataset(ann, batch_size=batch, input_hw=(size, size), mode=DatasetMode.TEST,
                 device=pred.device)
    mAP, _ = evaluate_map(pred, ds, ["red", "green"], verbose=verbose)
    return mAP


def run(epochs: int = 30, size: int = 96, batch: int = 8, threshold: float = 0.8,
        workdir: str | None = None, device="cuda", seed: int = 0):
    """Train the recipe on ``build_synthetic``'s data and evaluate it:
    (mAP, the trained weight file)."""
    from yoloret_tpu_torch.device import reproducible
    from yoloret_tpu_torch.train.trainer import train

    workdir = workdir or tempfile.mkdtemp(prefix="yoloret_selfcheck_")
    ann, classes, anchors_path = build_synthetic(workdir)
    cfg = selfcheck_cfg(workdir, ann, classes, anchors_path, epochs, size, batch, seed)
    with reproducible(device):
        # stage-2 path without a warm start: train_unfreeze stays None
        weights = train(cfg, device=device)
        mAP = evaluate(weights, ann, anchors_path, size, batch, device)
    status = "PASS" if mAP >= threshold else "FAIL"
    print(f"selfcheck {status}: mAP={mAP:.3f} (threshold {threshold})")
    return mAP, weights


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--size", type=int, default=96)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--threshold", type=float, default=0.8)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    mAP, _ = run(a.epochs, a.size, a.batch, a.threshold, device=a.device)
    raise SystemExit(0 if mAP >= a.threshold else 1)


if __name__ == "__main__":
    main()
