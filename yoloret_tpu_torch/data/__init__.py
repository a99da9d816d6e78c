"""Data path of the port: annotation lists, TFRecord shards, the host
decode, the device augmentation and letterbox, and the targets."""

from yoloret_tpu_torch.data.annotations import (
    load_anchors,
    load_annotation_lines,
    load_classes,
    parse_annotation_line,
)
from yoloret_tpu_torch.data.augment import AugmentConfig, augment_batch, draw_augment, eval_batch
from yoloret_tpu_torch.data.pipeline import Dataset, DatasetMode

__all__ = [
    "load_anchors",
    "load_annotation_lines",
    "load_classes",
    "parse_annotation_line",
    "AugmentConfig",
    "augment_batch",
    "draw_augment",
    "eval_batch",
    "Dataset",
    "DatasetMode",
]
