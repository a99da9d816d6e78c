"""Accuracy-regression gate runner: train the crowded-synthetic recipe
and print the resulting mAP as one JSON line. Port of
``yoloret_tpu/tools/accuracy_gate.py``.

    python -m yoloret_tpu_torch.tools.accuracy_gate [--workdir DIR] [--device cuda]
    python -m yoloret_tpu_torch.tools.accuracy_gate --loss_trace --epochs 3

Recipe: ``tools/topk_study.py::crowded_train_cfg`` (seed 0, 60 epochs,
mild augment -- the shared partial-convergence study recipe). Eval is
``--mode=MAP`` grade (reference: code/yolo.py:397-405): threshold 0,
the default shared-pool postprocess. The JAX package's band (0.22-0.45
on one CPU device) does not carry over: the port's seeded init differs
from JAX's, and 60 epochs of partial convergence amplify any difference
chaotically. ``--loss_trace`` prints the per-epoch mean loss of a short
run of the same recipe, which has no such amplification. On the card
both train and evaluate in float32 on deterministic kernels
(``device.reproducible``), so that a rerun gives the same numbers, as
the JAX package pins its device topology for the same reason.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile


def gate_result(pred, ann: str, epochs: int, size: int = 160, batch: int = 8,
                max_boxes: int = 12) -> dict:
    """mAP of the gate's Predictor ``pred`` over ``ann``, printed as the
    ``GATE_RESULT`` line."""
    from yoloret_tpu_torch.data import Dataset, DatasetMode
    from yoloret_tpu_torch.eval import evaluate_map
    from yoloret_tpu_torch.tools.topk_study import CLASS_NAMES

    ds = Dataset(ann, batch_size=batch, input_hw=(size, size), mode=DatasetMode.TEST,
                 max_boxes=max_boxes, device=pred.device)
    mAP, aps = evaluate_map(pred, ds, CLASS_NAMES, verbose=False)
    result = {
        "mAP": round(float(mAP), 6),
        "aps": {int(k): round(float(v), 6) for k, v in aps.items()},
        "epochs": epochs,
    }
    print("GATE_RESULT " + json.dumps(result), flush=True)
    return result


def run(workdir: str | None = None, epochs: int = 60, size: int = 160,
        batch: int = 8, device="cuda"):
    """Train the recipe and print its ``GATE_RESULT``: (that result, the
    trained weight file)."""
    from yoloret_tpu_torch.device import reproducible
    from yoloret_tpu_torch.tools.topk_study import (
        build_crowded,
        crowded_predictor,
        crowded_train_cfg,
    )
    from yoloret_tpu_torch.train.trainer import train

    workdir = workdir or tempfile.mkdtemp(prefix="yoloret_gate_")
    ann, classes, anchors_path = build_crowded(workdir)
    cfg = crowded_train_cfg(workdir, ann, classes, anchors_path,
                            epochs=epochs, size=size, batch=batch)
    with reproducible(device):
        weights = train(cfg, device=device)
        pred = crowded_predictor(weights, anchors_path, size, device)
        return gate_result(pred, ann, epochs, size, batch), weights


def epoch_records(stage_dir: str) -> list:
    """The per-epoch records (loss, sec, ...) of the ``metrics.jsonl`` in a
    training stage's directory, the one that holds its weight files (the
    trainer appends, so a reused directory carries earlier runs'
    records)."""
    with open(os.path.join(stage_dir, "metrics.jsonl")) as f:
        return [rec for rec in map(json.loads, f) if "loss" in rec]


def stage2_losses(cfg, epochs: int) -> list:
    """The last ``epochs`` per-epoch mean losses of the stage-2 run under
    ``cfg.log_dir``."""
    recs = epoch_records(os.path.join(cfg.log_dir, f"{cfg.backbone}_stage2"))
    return [rec["loss"] for rec in recs][-epochs:]


def run_loss_trace(workdir: str | None = None, epochs: int = 3,
                   size: int = 160, batch: int = 8, device="cuda") -> dict:
    """Train the same recipe for a few epochs and print the per-epoch mean
    loss trace (``GATE_LOSS_TRACE``). NB: epochs is part of the recipe --
    the cosine LR schedule spans it."""
    from yoloret_tpu_torch.device import reproducible
    from yoloret_tpu_torch.tools.topk_study import build_crowded, crowded_train_cfg
    from yoloret_tpu_torch.train.trainer import train

    workdir = workdir or tempfile.mkdtemp(prefix="yoloret_losstrace_")
    ann, classes, anchors_path = build_crowded(workdir)
    cfg = crowded_train_cfg(workdir, ann, classes, anchors_path,
                            epochs=epochs, size=size, batch=batch)
    with reproducible(device):
        train(cfg, device=device)
    result = {"losses": stage2_losses(cfg, epochs), "epochs": epochs}
    print("GATE_LOSS_TRACE " + json.dumps(result), flush=True)
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", default=None)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--size", type=int, default=160)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--loss_trace", action="store_true",
                   help="fast tight gate: N-epoch loss trace instead of "
                        "the full 60-epoch mAP run")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    if a.loss_trace:
        run_loss_trace(workdir=a.workdir, epochs=a.epochs, size=a.size,
                       batch=a.batch, device=a.device)
    else:
        run(workdir=a.workdir, epochs=a.epochs, size=a.size, batch=a.batch,
            device=a.device)


if __name__ == "__main__":
    main()
