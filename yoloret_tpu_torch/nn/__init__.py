"""The detector as ``torch.nn`` modules (NHWC, inference and training)."""

from yoloret_tpu_torch.nn.detector import YoloReT, build_detector

__all__ = ["YoloReT", "build_detector"]
