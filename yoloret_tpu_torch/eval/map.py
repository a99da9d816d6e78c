"""VOC-style mAP evaluation. Port of ``yoloret_tpu/eval/map.py``.

``voc_ap`` and ``MAPEvaluator`` are copies of the JAX package's (host
numpy). The protocol is the reference ``MAPCallback``'s (reference:
code/yolo3/map.py:10-248): per-class greedy matching of score-sorted
detections against per-image ground truth at IoU > threshold with
per-GT dedup (:157-221, +1-pixel VOC IoU convention :166-178), AP by
monotone precision-envelope integration -- the VOC2010 "correct AP"
(:16-32) -- and mAP as the class mean (:237-248).

``evaluate_map`` runs ``Predictor.infer`` on each device batch of an
eval ``Dataset`` (``data/pipeline.py``): the fused detector and the
postprocess on the card, one suppression kernel launch per batch. The
JAX package's two-program split (``_infer_detect``) works around an
XLA-TPU compile cliff and has no counterpart here; its mesh sharding and
approximate top-k are not ported (top-k is exact, as on the JAX
package's CPU runs).
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def voc_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """Area under the monotone precision envelope
    (reference: code/yolo3/map.py:16-32)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


class MAPEvaluator:
    """Streaming accumulator: feed per-image detections + ground truth,
    then ``compute()`` per-class APs (at the single VOC threshold) or
    ``compute_range()`` for COCO-style mAP@[.5:.95].

    Boxes are (x1, y1, x2, y2) in original-image pixels.
    """

    def __init__(self, num_classes: int, iou_threshold: float = 0.5):
        self.num_classes = num_classes
        self.iou = iou_threshold
        self._preds: List[Tuple[int, int, float, np.ndarray]] = []
        self._gt: Dict[int, np.ndarray] = {}  # image idx -> [N, 5] (x1,y1,x2,y2,cls)
        self._next_idx = 0

    def add_image(
        self,
        pred_boxes: np.ndarray,  # [M, 4] (x1, y1, x2, y2)
        pred_scores: np.ndarray,  # [M]
        pred_classes: np.ndarray,  # [M]
        gt: np.ndarray,  # [N, 5] (x1, y1, x2, y2, cls)
    ) -> int:
        idx = self._next_idx
        self._next_idx += 1
        for b, s, c in zip(pred_boxes, pred_scores, pred_classes):
            self._preds.append((idx, int(c), float(s), np.asarray(b, float)))
        self._gt[idx] = np.asarray(gt, float).reshape(-1, 5)
        return idx

    def compute_range(self, thresholds=None) -> float:
        """COCO-style mAP averaged over IoU thresholds .5:.05:.95 —
        an extension beyond the reference's single-threshold VOC AP."""
        if thresholds is None:
            thresholds = np.arange(0.5, 0.96, 0.05)
        keep = self.iou
        vals = []
        try:
            for t in thresholds:
                # VOC matching uses strict >, COCO uses >=; subtract a hair.
                self.iou = float(t) - 1e-9
                aps = self.compute()
                vals.append(np.mean(list(aps.values())) if aps else 0.0)
        finally:
            self.iou = keep
        return float(np.mean(vals))

    def compute(self) -> Dict[int, float]:
        aps: Dict[int, float] = {}
        for cls in range(self.num_classes):
            preds = [p for p in self._preds if p[1] == cls]
            if not preds:
                aps[cls] = 0.0
                continue
            npos = 0
            gt_cls: Dict[int, dict] = {}
            for idx, g in self._gt.items():
                rows = g[g[:, 4] == cls]
                npos += len(rows)
                gt_cls[idx] = {"bbox": rows[:, :4], "det": [False] * len(rows)}

            order = np.argsort([-p[2] for p in preds])
            tp = np.zeros(len(preds))
            fp = np.zeros(len(preds))
            for rank, pi in enumerate(order):
                idx, _, _, box = preds[pi]
                res = gt_cls[idx]
                bbgt = res["bbox"]
                ovmax, jmax = -np.inf, -1
                if bbgt.size > 0:
                    ixmin = np.maximum(bbgt[:, 0], box[0])
                    iymin = np.maximum(bbgt[:, 1], box[1])
                    ixmax = np.minimum(bbgt[:, 2], box[2])
                    iymax = np.minimum(bbgt[:, 3], box[3])
                    iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
                    ih = np.maximum(iymax - iymin + 1.0, 0.0)
                    inter = iw * ih
                    union = (
                        (box[2] - box[0] + 1.0) * (box[3] - box[1] + 1.0)
                        + (bbgt[:, 2] - bbgt[:, 0] + 1.0) * (bbgt[:, 3] - bbgt[:, 1] + 1.0)
                        - inter
                    )
                    overlaps = inter / union
                    ovmax = float(np.max(overlaps))
                    jmax = int(np.argmax(overlaps))
                if ovmax > self.iou and not res["det"][jmax]:
                    tp[rank] = 1.0
                    res["det"][jmax] = True
                else:
                    fp[rank] = 1.0

            fp = np.cumsum(fp)
            tp = np.cumsum(tp)
            rec = tp / np.maximum(float(npos), np.finfo(np.float64).eps)
            prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
            aps[cls] = voc_ap(rec, prec)
        return aps


def evaluate_map(
    predictor,
    dataset,
    class_names: Sequence[str],
    *,
    score_threshold: float = 0.0,
    iou_threshold: float = 0.5,
    nms_iou: float = 0.5,
    max_batches: Optional[int] = None,
    verbose: bool = True,
    num_candidates: int = 512,
    pool: Optional[str] = None,
) -> Tuple[float, Dict[int, float]]:
    """Run ``predictor`` (an ``infer.Predictor``) over an eval ``dataset``
    (``data.Dataset``, TEST mode, on the predictor's device) and return
    (mAP, per-class APs) -- the ``--mode=MAP`` driver (reference:
    code/yolo.py:397-405). ``score_threshold``, ``nms_iou``,
    ``num_candidates`` and ``pool`` override the predictor's settings;
    ``pool="per_class"`` with ``num_candidates`` = the grid size is the
    reference's exact per-class NMS. Batch i + 1 is dispatched before
    batch i's detections are read back, so the device works while the
    host files them. Prints the loop's images/s and the dataset's decodes
    by decoder (native libjpeg or PIL) when ``verbose``."""
    ev = MAPEvaluator(len(class_names), iou_threshold)
    n_images = 0
    kw = dict(score_threshold=score_threshold, iou_threshold=nms_iou,
              num_candidates=num_candidates, pool=pool)

    def collect(batch, res):
        boxes = res.boxes.cpu().numpy()  # [B, M, 4] (ymin, xmin, ymax, xmax)
        scores = res.scores.cpu().numpy()
        classes = res.classes.cpu().numpy()
        valid = res.valid.cpu().numpy()
        gt, gt_valid = batch["orig_boxes"], batch["orig_valid"]
        for i in range(int(batch["n_valid"])):  # skip pad rows of the final partial batch
            m = valid[i]
            xyxy = boxes[i][m][:, [1, 0, 3, 2]]  # -> (x1, y1, x2, y2)
            ev.add_image(xyxy, scores[i][m], classes[i][m], gt[i][gt_valid[i]])
        return int(batch["n_valid"])

    decodes_before = Counter(dataset.decodes)
    t0 = time.perf_counter()
    batches = dataset.build(epochs=1)
    pending = None
    try:
        for bi, batch in enumerate(batches):
            if max_batches is not None and bi >= max_batches:
                break
            res = predictor.infer(batch["images"], batch["image_hw"], **kw)
            if pending is not None:
                n_images += collect(*pending)
            pending = (batch, res)
        if pending is not None:
            n_images += collect(*pending)
    finally:
        batches.close()
    dt = time.perf_counter() - t0
    if verbose and n_images:
        decodes = dataset.decodes - decodes_before
        print(f"eval: {n_images} images, {dt / n_images * 1e3:.4f} ms/image, "
              f"{n_images / dt:.2f} images/s; decoded: native {decodes['native']}, "
              f"PIL {decodes['pil']}")

    aps = ev.compute()
    if verbose:
        for cls, ap in aps.items():
            print(f"{class_names[cls]} ap: {ap:.6f}")
    mean_ap = float(np.mean(list(aps.values()))) if aps else 0.0
    if verbose:
        print(f"mAP: {mean_ap:.6f}")
    return mean_ap, aps
