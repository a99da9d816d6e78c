"""The detector as ``torch.nn`` modules (NHWC, inference)."""

from yoloret_tpu_torch.nn.detector import YoloReT, build_detector

__all__ = ["YoloReT", "build_detector"]
