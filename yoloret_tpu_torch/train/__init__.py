"""Training: the loss, the truncated-transfer labels, the step and the
two-stage trainer (``train.trainer.train``, imported on use)."""

from yoloret_tpu_torch.train.freeze import backbone_freeze_mask
from yoloret_tpu_torch.train.losses import LossBreakdown, yolo_loss, yolo_loss_per_scale
from yoloret_tpu_torch.train.step import (
    StepConfig,
    TrainState,
    cosine_lr_schedule,
    eval_step,
    train_step,
)

__all__ = [
    "LossBreakdown",
    "yolo_loss",
    "yolo_loss_per_scale",
    "backbone_freeze_mask",
    "StepConfig",
    "TrainState",
    "cosine_lr_schedule",
    "eval_step",
    "train_step",
]
