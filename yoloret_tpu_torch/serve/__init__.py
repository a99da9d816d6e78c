"""HTTP serving of the port's Predictor."""

from yoloret_tpu_torch.serve.server import DetectionServer

__all__ = ["DetectionServer"]
