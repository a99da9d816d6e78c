"""Inference API of the port."""

from yoloret_tpu_torch.infer.predictor import Detection, Predictor

__all__ = ["Detection", "Predictor"]
