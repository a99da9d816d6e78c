"""Evaluation data path of the port: annotation lists, TFRecord shards,
the host decode and the device letterbox."""

from yoloret_tpu_torch.data.annotations import (
    load_anchors,
    load_annotation_lines,
    load_classes,
    parse_annotation_line,
)
from yoloret_tpu_torch.data.augment import AugmentConfig, eval_batch
from yoloret_tpu_torch.data.pipeline import Dataset, DatasetMode

__all__ = [
    "load_anchors",
    "load_annotation_lines",
    "load_classes",
    "parse_annotation_line",
    "AugmentConfig",
    "eval_batch",
    "Dataset",
    "DatasetMode",
]
