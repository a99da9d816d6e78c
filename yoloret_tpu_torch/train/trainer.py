"""Training orchestration: ``train()``. Port of
``yoloret_tpu/train/trainer.py`` (reference: code/train.py:20-218) on
one device.

Two stages, as the reference runs them:
  * stage 1 (``freeze=True``): the backbone frozen (no optimizer state,
    no update, its BatchNorms on their running statistics), Adam(lr[0],
    eps=1e-8) with per-epoch cosine decay over epochs[0]; writes
    ``<log_dir>/<backbone>_stage1/<backbone>_trained_weights_stage_1.pt``;
  * stage 2 (``freeze=False``, ``train_unfreeze=<stage-1 file>``): every
    parameter trains, Adam(lr[1]); writes ``..._trained_weights_final.pt``.

The training stream takes the augmentation options of the JAX
package: online AutoAugment (``autoaugment_policy``, on the host), online
mosaic and mixup (``augment.mosaic_prob`` / ``mixup_prob``, on the
device), and with ``multi_scale`` one dataset per input size, epoch e
drawing from size ``e % len(sizes)`` (the model is fully convolutional;
``steps_per_epoch`` comes from the first size).

Each epoch appends a line to ``<stage dir>/metrics.jsonl`` (loss, val
loss, lr, seconds, images/s) and TensorBoard scalars; with ``tb_images``
also the first n rows of the epoch's last batch, as the step saw them,
with the detections of the current (not EMA) weights drawn
(``train_input/{i}``). The validation loss runs the inference forward
over ``val_dataset``; with ``--map_every`` and at stage end the VOC mAP
runs over ``test_dataset``. Both detection passes go through one
``Predictor`` that is handed the weights (the EMA weights for the mAP
with ``use_ema``) each time, so its fused MBConv and NMS kernels see the
trained weights. Checkpoints every ``checkpoint_every`` epochs keep the
optimizer state, the step and the early stopper; ``--resume`` restarts
at the next epoch, with each size's data stream at the batch where it
stopped.

Not ported (each stops with a message naming its ROADMAP.md item):
data parallelism and multihost, and Orbax weight files.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from yoloret_tpu_torch.configs import RunConfig
from yoloret_tpu_torch.data import Dataset, DatasetMode, load_anchors, load_classes
from yoloret_tpu_torch.data.augment import AugmentConfig
from yoloret_tpu_torch.device import DeviceLike, resolve_device
from yoloret_tpu_torch.nn.detector import YoloReT
from yoloret_tpu_torch.nn.layers import init_weights
from yoloret_tpu_torch.train.freeze import backbone_freeze_mask
from yoloret_tpu_torch.train.step import (
    StepConfig,
    TrainState,
    cosine_lr_schedule,
    eval_step,
    train_step,
)
from yoloret_tpu_torch.utils.checkpoint import CheckpointManager, load_params, save_params
from yoloret_tpu_torch.utils.tensorboard import SummaryWriter


def unported_options(cfg: RunConfig) -> Optional[str]:
    """What of ``cfg`` the port cannot train yet, with its item in
    ROADMAP.md's queue 1, or None."""
    if (cfg.mesh_data or 1) > 1 or cfg.multihost:
        return ("--mesh_data above 1 and multihost: data-parallel training waits for "
                "parallelism, item 6 (ROADMAP.md, queue 1); it is not ported to "
                "yoloret_tpu_torch yet")
    return None


class EarlyStopper:
    """val_loss early stopping (reference code/train.py:101-105:
    ``EarlyStopping(monitor='val_loss', min_delta=0, patience=epochs//2)``);
    a non-finite loss stops at once. ``update()`` returns True when the
    stage should stop."""

    def __init__(self, patience: int):
        self.patience = max(1, int(patience))
        self.best = float("inf")
        self.stale = 0

    def update(self, val_loss: float) -> bool:
        if not np.isfinite(val_loss):
            return True
        if val_loss < self.best:
            self.best, self.stale = val_loss, 0
            return False
        self.stale += 1
        return self.stale >= self.patience


def train(cfg: RunConfig, device: DeviceLike = "cuda") -> str:
    """Run one training stage on ``device``; returns the path of the
    stage-end weight file."""
    refused = unported_options(cfg)
    if refused:
        raise NotImplementedError(refused)
    if not (cfg.train_dataset and cfg.classes_path and cfg.anchors_path):
        raise ValueError("train_dataset, classes_path and anchors_path are required")
    dev = resolve_device(device)
    class_names = load_classes(cfg.classes_path)
    num_classes = len(class_names)
    anchors = load_anchors(cfg.anchors_path)
    stage = 1 if cfg.freeze else 2
    epochs = cfg.epochs[0] if cfg.freeze else cfg.epochs[1]
    lr = cfg.learning_rate[0] if cfg.freeze else cfg.learning_rate[1]
    hw = tuple(cfg.input_size)
    # multi-scale: one dataset per size, round-robin by epoch
    train_sizes = [hw]
    if cfg.multi_scale:
        train_sizes = [(int(s), int(s)) for s in cfg.multi_scale]
        if not all(h % 32 == 0 for h, _ in train_sizes):
            raise ValueError(f"--multi_scale sizes must be multiples of 32: {cfg.multi_scale}")

    log_dir = os.path.join(cfg.log_dir, f"{cfg.backbone}_stage{stage}")
    os.makedirs(log_dir, exist_ok=True)

    common = dict(anchors=anchors, num_classes=num_classes, num_scales=cfg.num_scales,
                  max_boxes=cfg.max_boxes, seed=cfg.seed, device=dev)
    train_dss = [Dataset(cfg.train_dataset, cfg.batch_size, input_hw=size, mode=DatasetMode.TRAIN,
                         augment_config=AugmentConfig(**cfg.augment) if cfg.augment else None,
                         aa_policy=cfg.autoaugment_policy, **common)
                 for size in train_sizes]
    val_ds = (Dataset(cfg.val_dataset, cfg.batch_size, input_hw=hw, mode=DatasetMode.VALIDATE,
                      **common) if cfg.val_dataset else None)
    map_ds = (Dataset(cfg.test_dataset, cfg.batch_size, input_hw=hw, mode=DatasetMode.TEST,
                      device=dev) if cfg.test_dataset else None)
    steps_per_epoch = train_dss[0].steps_per_epoch()

    model = YoloReT(cfg.backbone, num_classes=num_classes,
                    dtype=torch.bfloat16 if cfg.bf16 else torch.float32, rfcr=cfg.rfcr,
                    remat=cfg.remat)
    init_weights(model, torch.Generator().manual_seed(cfg.seed))
    # stage 2 starts from the stage-1 file; --model is a warm start
    init_path = cfg.train_unfreeze if not cfg.freeze else cfg.model
    if init_path:
        model.load_state_dict(load_params(init_path), strict=True)
    model.to(dev)

    schedule = cosine_lr_schedule(lr, epochs, steps_per_epoch)
    labels = None
    if cfg.freeze:
        labels = backbone_freeze_mask((n for n, _ in model.named_parameters()),
                                      upto_block=cfg.truncate_block)
    state = TrainState(model, schedule, labels, use_ema=cfg.use_ema)
    step_cfg = StepConfig(
        anchors=tuple(map(tuple, anchors.tolist())), num_scales=cfg.num_scales,
        ignore_thresh=cfg.ignore_thresh, box_loss=cfg.box_loss,
        class_loss_kind=cfg.class_loss, backbone_train=not cfg.freeze, use_adv=cfg.use_adv,
        ema_decay=cfg.ema_decay)

    ckpt = CheckpointManager(os.path.join(log_dir, "ckpt"), every=cfg.checkpoint_every)
    stopper = (EarlyStopper(cfg.early_stopping_patience or epochs // 2)
               if cfg.early_stopping else None)

    def ckpt_tree() -> dict:
        tree = state.state_dict()
        if stopper is not None:
            tree["stopper"] = {"best": float(stopper.best), "stale": int(stopper.stale)}
        return tree

    start_epoch = 0
    if cfg.resume:
        latest = ckpt.latest_epoch()
        if latest is not None:
            tree = ckpt.restore(latest)
            state.load_state_dict(tree)
            if stopper is not None and "stopper" in tree:
                stopper.best = float(tree["stopper"]["best"])
                stopper.stale = int(tree["stopper"]["stale"])
            start_epoch = latest + 1
            print(f"resumed from epoch {latest} checkpoint")

    mfile = open(os.path.join(log_dir, "metrics.jsonl"), "a")
    tb = SummaryWriter(os.path.join(log_dir, "tb"))
    predictor = None

    def log(rec: dict) -> None:
        print(json.dumps(rec))
        mfile.write(json.dumps(rec) + "\n")
        mfile.flush()

    def predictor_with(use_ema: bool):
        """The detection passes' Predictor holding the current weights
        (the EMA weights with ``use_ema``), its fused copy refreshed."""
        nonlocal predictor
        from yoloret_tpu_torch.infer import Predictor

        weights = state.eval_state_dict(use_ema)
        if predictor is None:
            predictor = Predictor(cfg.backbone, weights=weights, class_names=class_names,
                                  anchors=anchors, input_hw=hw, bf16=cfg.bf16, rfcr=cfg.rfcr,
                                  score_threshold=0.0, device=dev)
        else:
            predictor.model.load_state_dict(weights, strict=True)
            predictor.refresh()
        return predictor

    def eval_map(epoch: int) -> float:
        """VOC mAP over the test set with the current weights (the EMA
        weights with use_ema), through the Predictor's kernels."""
        from yoloret_tpu_torch.eval import evaluate_map

        mean_ap, _ = evaluate_map(predictor_with(cfg.use_ema), map_ds, class_names,
                                  nms_iou=cfg.nms_iou, verbose=False)
        log({"epoch": epoch, "mAP": mean_ap})
        tb.add_scalar("mAP", mean_ap, epoch)
        tb.flush()
        return mean_ap

    def tb_images(epoch: int, images: torch.Tensor) -> None:
        """The first ``tb_images`` rows of an augmented batch with the
        current weights' detections drawn (score 0.3; boxes in the
        batch's own input pixels), as TensorBoard images
        (``write_images`` parity, reference code/train.py:71-73)."""
        from PIL import Image

        from yoloret_tpu_torch.infer.predictor import Detection, draw_detections

        n = min(cfg.tb_images, images.shape[0])
        rows = images[:n]
        image_hw = torch.tensor([list(rows.shape[1:3])], dtype=torch.float32).repeat(n, 1)
        res = predictor_with(False).infer(rows, image_hw.to(dev), score_threshold=0.3,
                                          iou_threshold=cfg.nms_iou, num_candidates=256)
        boxes, scores, classes, valid = (t.cpu().numpy() for t in
                                         (res.boxes, res.scores, res.classes, res.valid))
        pixels = rows.float().cpu().numpy()
        for i in range(n):
            u8 = (np.clip(pixels[i], 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
            dets = [Detection((float(b[1]), float(b[0]), float(b[3]), float(b[2])), float(s),
                              int(c), class_names[int(c)])
                    for b, s, c in zip(boxes[i][valid[i]], scores[i][valid[i]],
                                       classes[i][valid[i]])]
            pil = draw_detections(Image.fromarray(u8), dets, class_names)
            tb.add_image(f"train_input/{i}", np.asarray(pil), epoch)
        tb.flush()

    print(f"stage {stage}: {cfg.backbone} @{list(hw)}, batch {cfg.batch_size}, "
          f"{steps_per_epoch} steps/epoch x {epochs} epochs on {dev}")
    # each size's stream skips the batches that its completed epochs drew
    streams = [ds.build(epochs=None, skip_batches=steps_per_epoch * sum(
        1 for e in range(start_epoch) if e % len(train_dss) == i))
        for i, ds in enumerate(train_dss)]
    loss_keys = ("images", "gt_boxes", "gt_valid") + tuple(
        f"y_true_{l}" for l in range(cfg.num_scales))
    epoch = max(start_epoch, epochs) - 1  # the stage-end epoch if the loop does not run
    try:
        for epoch in range(start_epoch, epochs):
            t0 = time.perf_counter()
            batches = streams[epoch % len(streams)]
            if len(streams) > 1:
                print(f"epoch {epoch}: input size {train_sizes[epoch % len(train_sizes)]}")
            losses = []  # device scalars: one read per epoch
            for bstep in range(steps_per_epoch):
                batch = next(batches)
                m = train_step(state, batch, step_cfg, seed=cfg.seed + 1)
                losses.append(m["loss"])
                if (bstep + 1) % 50 == 0:
                    print(f"epoch {epoch} step {bstep + 1}/{steps_per_epoch} "
                          f"loss {float(losses[-1]):.4f}")
            train_loss = float(torch.stack(losses).mean())

            val_loss = float("nan")
            if val_ds is not None:
                vtotal, vn = 0.0, 0
                for vbatch in val_ds.build(epochs=1):
                    vtotal += float(eval_step(state, {k: vbatch[k] for k in loss_keys},
                                              step_cfg)["val_loss"])
                    vn += 1
                val_loss = vtotal / max(vn, 1)

            dt = time.perf_counter() - t0
            lr_now = schedule(epoch * steps_per_epoch)
            log({"epoch": epoch, "loss": train_loss, "val_loss": val_loss, "lr": lr_now,
                 "sec": round(dt, 2),
                 "images_per_sec": round(cfg.batch_size * steps_per_epoch / dt, 1)})
            tb.add_scalar("loss", train_loss, epoch)
            if np.isfinite(val_loss):
                tb.add_scalar("val_loss", val_loss, epoch)
            tb.add_scalar("lr", lr_now, epoch)
            tb.flush()
            ckpt.maybe_save(epoch, ckpt_tree(),
                            val_loss if np.isfinite(val_loss) else train_loss)
            if cfg.tb_images > 0:
                tb_images(epoch, batch["images"])
            if map_ds is not None and cfg.map_every > 0 and (epoch + 1) % cfg.map_every == 0:
                eval_map(epoch)
            if stopper is not None:
                # with no val split only the divergence guard applies
                stop = (stopper.update(val_loss) if val_ds is not None
                        else not np.isfinite(train_loss))
                if stop:
                    print(f"early stopping at epoch {epoch}: val_loss has not improved for "
                          f"{stopper.patience} epochs (best {stopper.best:.4f})")
                    break
    finally:
        for stream in streams:
            stream.close()

    if map_ds is not None:
        print(f"stage-end mAP: {eval_map(epoch):.6f}")
    suffix = "stage_1" if cfg.freeze else "final"
    out = os.path.join(log_dir, f"{cfg.backbone}_trained_weights_{suffix}.pt")
    save_params(out, model.state_dict(), state.ema)
    mfile.close()
    tb.close()
    print(f"saved {out}")
    return out
