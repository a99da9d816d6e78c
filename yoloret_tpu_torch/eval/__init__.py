"""mAP evaluation of the port."""

from yoloret_tpu_torch.eval.map import MAPEvaluator, evaluate_map, voc_ap

__all__ = ["MAPEvaluator", "evaluate_map", "voc_ap"]
