"""Inference API: the serving path on the card. Port of
``yoloret_tpu/infer/predictor.py`` (``Detection``, ``Predictor``) without
the int8, zoom-ensemble, mesh and video paths.

The host letterboxes each image to uint8 (4x smaller upload than
float32), the device divides by 255, runs the detector through
``nn/fused_infer.py`` (a MobileNetV2 backbone: 16 fused MBConv kernel
launches per forward; any other backbone of the registry: its stock
forward) and the shared-pool postprocess (one suppression kernel launch
per forward).
Requests are padded to a small ladder of batch buckets (1/8/32/128) by
replicating row 0, and requests above the top bucket go in top-bucket
chunks. CUDA work is asynchronous, so letterboxing chunk k+1 overlaps
the device running chunk k; at most ``inflight_chunks`` chunks are
dispatched and not yet collected, so device memory stays O(window).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from yoloret_tpu_torch.data.annotations import load_anchors, load_classes
from yoloret_tpu_torch.data.augment import to_unit_float
from yoloret_tpu_torch.device import DeviceLike, resolve_device, upload
from yoloret_tpu_torch.nn.detector import YoloReT
from yoloret_tpu_torch.nn.fused_infer import fused_detector_apply, fused_params
from yoloret_tpu_torch.nn.layers import init_weights
from yoloret_tpu_torch.ops.letterbox import letterbox_numpy_u8
from yoloret_tpu_torch.ops.nms import NMSResult
from yoloret_tpu_torch.ops.postprocess import detect_batch
from yoloret_tpu_torch.weights import from_flax


@dataclasses.dataclass
class Detection:
    box: Tuple[float, float, float, float]  # (x1, y1, x2, y2) image pixels
    score: float
    class_id: int
    class_name: str


Weights = Union[str, Mapping[str, Any], None]


class Predictor:
    """``weights``: None (seeded init from ``seed``), a path to a saved
    port state dict (``torch.save(model.state_dict())``), a port state
    dict, or Flax variables ``{'params', 'batch_stats'}`` as numpy
    arrays (converted by ``weights.from_flax``). ``backbone`` is any name
    of ``nn.detector.BACKBONES``; ``rfcr`` the RFCR fusion the weights
    were trained with (``weighted_sum``, ``concat`` or ``none``)."""

    def __init__(
        self,
        backbone: str = "mobilenetv2x75",
        weights: Weights = None,
        classes_path: Optional[str] = None,
        anchors_path: Optional[str] = None,
        class_names: Optional[Sequence[str]] = None,
        anchors: Optional[np.ndarray] = None,
        input_hw: Tuple[int, int] = (320, 320),
        score_threshold: float = 0.6,
        iou_threshold: float = 0.5,
        bf16: bool = True,
        seed: int = 0,
        num_candidates: int = 256,
        batch_buckets: Sequence[int] = (1, 8, 32, 128),
        inflight_chunks: int = 2,
        rfcr: str = "weighted_sum",
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        if class_names is None:
            if not classes_path:
                raise ValueError("need class_names or classes_path")
            class_names = load_classes(classes_path)
        if anchors is None:
            if not anchors_path:
                raise ValueError("need anchors or anchors_path")
            anchors = load_anchors(anchors_path)
        if not batch_buckets:
            raise ValueError("batch_buckets must be non-empty")
        self.class_names = list(class_names)
        self.anchors = np.asarray(anchors, np.float32)
        self.input_hw = tuple(input_hw)
        self.score_threshold = score_threshold
        self.iou_threshold = iou_threshold
        self.num_candidates = num_candidates
        self.batch_buckets = tuple(sorted({int(b) for b in batch_buckets}))
        self.inflight_chunks = max(1, int(inflight_chunks))
        self.dispatched_batch_sizes: set = set()
        self.forwards = 0  # device forwards dispatched (one per chunk)

        self.model = YoloReT(backbone, num_classes=len(self.class_names),
                             dtype=torch.bfloat16 if bf16 else torch.float32, rfcr=rfcr)
        if weights is None:
            init_weights(self.model, torch.Generator().manual_seed(seed))
        else:
            if isinstance(weights, str):
                weights = torch.load(weights, map_location="cpu", weights_only=True)
            elif "params" in weights:
                weights = from_flax(weights, self.model)
            self.model.load_state_dict(weights, strict=True)
        self.model.to(self.device).eval()
        self.refresh()

    def refresh(self) -> None:
        """Re-fold the backbone weights after the model's parameters
        changed (the fused path reads a folded copy)."""
        self._anchors_t = torch.as_tensor(self.anchors, device=self.device)
        self._fused = fused_params(self.model)

    # -- device path --------------------------------------------------------

    @torch.inference_mode()
    def infer(self, images: torch.Tensor, image_hw: torch.Tensor, *,
              score_threshold: Optional[float] = None, iou_threshold: Optional[float] = None,
              num_candidates: Optional[int] = None, pool: Optional[str] = None) -> NMSResult:
        """images [B, H, W, 3] on the device, uint8 (0-255) or float
        ([0, 1]), and image_hw [B, 2] float32 -> NMSResult. The
        thresholds and ``num_candidates`` override the predictor's own
        settings for this call; ``pool`` is the postprocess's candidate
        pool, ``"shared"`` (None) or ``"per_class"``. Asynchronous on
        CUDA."""
        outs = fused_detector_apply(self.model, to_unit_float(images), self._fused)
        return detect_batch(
            outs, self._anchors_t, len(self.class_names), image_hw,
            score_threshold=self.score_threshold if score_threshold is None else score_threshold,
            iou_threshold=self.iou_threshold if iou_threshold is None else iou_threshold,
            num_candidates=self.num_candidates if num_candidates is None else num_candidates,
            pool=pool)

    # -- array API ----------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (the top bucket chunks bigger requests)."""
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.batch_buckets[-1]

    def detect_arrays(self, images: Sequence[np.ndarray]) -> List[List[Detection]]:
        """images: HWC uint8/float RGB arrays of any sizes -> detections
        per image. Chunks of the top bucket are dispatched ahead of
        readback, with at most ``inflight_chunks`` in flight; the oldest
        is collected BEFORE the next is dispatched."""
        top = self.batch_buckets[-1]
        out: List[List[Detection]] = []
        pending: deque = deque()
        for s in range(0, len(images), top):
            chunk = images[s:s + top]
            if len(pending) >= self.inflight_chunks:
                out.extend(self._collect_chunk(*pending.popleft()))
            pending.append((len(chunk), self._dispatch_chunk(chunk)))
        while pending:
            out.extend(self._collect_chunk(*pending.popleft()))
        return out

    def _dispatch_chunk(self, images: Sequence[np.ndarray]) -> NMSResult:
        batch = len(images)
        bucket = self._bucket_for(batch)
        lb = np.stack([letterbox_numpy_u8(np.asarray(im), self.input_hw) for im in images])
        hw = np.asarray([[im.shape[0], im.shape[1]] for im in images], np.float32)
        if bucket > batch:
            lb = np.concatenate([lb, np.broadcast_to(lb[:1], (bucket - batch, *lb.shape[1:]))])
            hw = np.concatenate([hw, np.broadcast_to(hw[:1], (bucket - batch, 2))])
        self.dispatched_batch_sizes.add(bucket)
        self.forwards += 1
        return self.infer(upload(lb, self.device), upload(hw, self.device))

    def _collect_chunk(self, batch: int, res: NMSResult) -> List[List[Detection]]:
        boxes = res.boxes[:batch].cpu().numpy()
        scores = res.scores[:batch].cpu().numpy()
        classes = res.classes[:batch].cpu().numpy()
        valid = res.valid[:batch].cpu().numpy()
        out: List[List[Detection]] = []
        for i in range(batch):
            dets = []
            for b, s, c in zip(boxes[i][valid[i]], scores[i][valid[i]], classes[i][valid[i]]):
                ymin, xmin, ymax, xmax = (float(v) for v in b)
                dets.append(Detection((xmin, ymin, xmax, ymax), float(s), int(c),
                                      self.class_names[int(c)]))
            out.append(dets)
        return out
