"""Inference API: the serving path on the card. Port of
``yoloret_tpu/infer/predictor.py`` (``Detection``, ``Predictor`` with
``detect_arrays`` and ``detect_image``, its int8 backbone and zoom-in
ensemble, ``draw_detections``) without the mesh and video paths.

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

``use_int8=True`` takes the W8A8 backbone (``nn/int8_infer.py``: int8
tensors between backbone convs, no MBConv launch), calibrated on
``calibration_images`` or, without them, on 16 uniform noise images of
``RandomState(0)``, as the JAX package does. ``zoom_ensemble=True`` runs
the network a second time on the centre ``zoom_hw`` crop of the
normalised batch (the fused path: 16 more MBConv launches; or the int8
path) and hands both passes' heads to the per-class postprocess.
"""

from __future__ import annotations

import colorsys
import dataclasses
import time
from collections import deque
from typing import Any, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from yoloret_tpu_torch.data.annotations import load_anchors, load_classes
from yoloret_tpu_torch.data.augment import to_unit_float
from yoloret_tpu_torch.device import DeviceLike, resolve_device, upload
from yoloret_tpu_torch.nn.detector import YoloReT
from yoloret_tpu_torch.nn.fused_infer import fused_detector_apply, fused_params
from yoloret_tpu_torch.nn.int8_infer import int8_detector_apply, quantize_from_data, supports_int8
from yoloret_tpu_torch.nn.layers import init_weights
from yoloret_tpu_torch.ops.letterbox import letterbox_numpy_u8
from yoloret_tpu_torch.ops.nms import NMSResult
from yoloret_tpu_torch.ops.postprocess import detect_batch
from yoloret_tpu_torch.utils.checkpoint import load_params
from yoloret_tpu_torch.weights import from_flax


@dataclasses.dataclass
class Detection:
    box: Tuple[float, float, float, float]  # (x1, y1, x2, y2) image pixels
    score: float
    class_id: int
    class_name: str


Weights = Union[str, Mapping[str, Any], None]


class Predictor:
    """``weights``: None (seeded init from ``seed``), a path to a port
    weight file (``utils.checkpoint.save_params``, the trainer's
    stage-end file, or ``torch.save(model.state_dict())``; with
    ``use_ema`` its EMA parameters), a port state dict, or Flax variables
    ``{'params', 'batch_stats'}`` as numpy arrays (converted by
    ``weights.from_flax``). ``backbone`` is any name
    of ``nn.detector.BACKBONES``; ``rfcr`` the RFCR fusion the weights
    were trained with (``weighted_sum``, ``concat`` or ``none``).
    ``use_int8`` (MobileNetV2 and EfficientNet backbones) and
    ``calibration_images`` ([N, H, W, 3], uint8 or float in [0, 1]), and
    ``zoom_ensemble`` with ``zoom_hw``, take the JAX package's meaning."""

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
        use_ema: bool = False,
        zoom_ensemble: bool = False,
        zoom_hw: Tuple[int, int] = (224, 224),
        use_int8: bool = False,
        calibration_images: Optional[np.ndarray] = None,
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
        self.zoom_ensemble = zoom_ensemble
        self.zoom_hw = tuple(zoom_hw)
        if use_int8 and not supports_int8(backbone):
            raise ValueError(f"the int8 path supports mobilenetv2* / efficientnetb*, not "
                             f"{backbone!r}")
        self._calib = None
        if use_int8:
            if calibration_images is None:
                calibration_images = np.random.RandomState(0).randint(
                    0, 256, (16, *self.input_hw, 3), np.uint8)
            calib = np.asarray(calibration_images, np.float32)
            self._calib = calib / 255.0 if calib.max() > 1.5 else calib

        self.model = YoloReT(backbone, num_classes=len(self.class_names),
                             dtype=torch.bfloat16 if bf16 else torch.float32, rfcr=rfcr)
        if weights is None:
            init_weights(self.model, torch.Generator().manual_seed(seed))
        else:
            if isinstance(weights, str):
                weights = load_params(weights, use_ema)
            elif "params" in weights:
                weights = from_flax(weights, self.model)
            self.model.load_state_dict(weights, strict=True)
        self.model.to(self.device).eval()
        self.refresh()

    def refresh(self) -> None:
        """Re-fold the backbone weights after the model's parameters
        changed (the fused path reads a folded copy), and with
        ``use_int8`` re-calibrate and re-quantize them."""
        self._anchors_t = torch.as_tensor(self.anchors, device=self.device)
        self._qp = None if self._calib is None else quantize_from_data(self.model, self._calib)
        self._fused = fused_params(self.model) if self._qp is None else None

    def _forward(self, images: torch.Tensor):
        if self._qp is not None:
            return int8_detector_apply(self.model, self._qp, images)
        return fused_detector_apply(self.model, images, self._fused)

    # -- device path --------------------------------------------------------

    @torch.inference_mode()
    def infer(self, images: torch.Tensor, image_hw: torch.Tensor, *,
              score_threshold: Optional[float] = None, iou_threshold: Optional[float] = None,
              num_candidates: Optional[int] = None, pool: Optional[str] = None) -> NMSResult:
        """images [B, H, W, 3] on the device, uint8 (0-255) or float
        ([0, 1]), and image_hw [B, 2] float32 -> NMSResult. The
        thresholds and ``num_candidates`` override the predictor's own
        settings for this call; ``pool`` is the postprocess's candidate
        pool, ``"shared"`` or ``"per_class"`` (None: shared, per-class with
        the zoom ensemble). Asynchronous on CUDA."""
        images = to_unit_float(images)
        outs = self._forward(images)
        zoom_outs = None
        if self.zoom_ensemble:
            (h, w), (zh, zw) = images.shape[1:3], self.zoom_hw
            y0, x0 = (h - zh) // 2, (w - zw) // 2
            zoom_outs = self._forward(images[:, y0:y0 + zh, x0:x0 + zw, :])
        return detect_batch(
            outs, self._anchors_t, len(self.class_names), image_hw,
            score_threshold=self.score_threshold if score_threshold is None else score_threshold,
            iou_threshold=self.iou_threshold if iou_threshold is None else iou_threshold,
            num_candidates=self.num_candidates if num_candidates is None else num_candidates,
            zoom_outputs=zoom_outs, pool=pool)

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

    # -- image API (reference detect_image, yolo.py:235-315) ----------------

    def detect_image(self, image, draw: bool = True):
        """image: a path or a PIL image -> (PIL image, with the detections
        drawn unless ``draw`` is False; the detections). Prints the
        number of boxes and the wall time of ``detect_arrays``."""
        from PIL import Image

        if isinstance(image, str):
            image = Image.open(image)
        image = image.convert("RGB")
        arr = np.asarray(image, np.uint8)
        t0 = time.perf_counter()
        dets = self.detect_arrays([arr])[0]
        dt = time.perf_counter() - t0
        print(f"found {len(dets)} boxes in {dt * 1e3:.1f} ms")
        if draw:
            image = draw_detections(image, dets, self.class_names)
        return image, dets


def draw_detections(image, detections: Sequence[Detection], class_names: Sequence[str]):
    """Draw boxes and labels on a PIL image in place, one HSV colour per
    class, PIL's default font, boxes (image width + height) // 600 px
    thick (reference: code/yolo.py:221-233, 276-313); returns it."""
    from PIL import ImageDraw, ImageFont

    n = max(len(class_names), 1)
    colors = [tuple(int(255 * v) for v in colorsys.hsv_to_rgb(i / n, 1.0, 1.0))
              for i in range(n)]
    draw = ImageDraw.Draw(image)
    font = ImageFont.load_default()
    thickness = max(1, (image.size[0] + image.size[1]) // 600)
    for d in detections:
        x1, y1, x2, y2 = d.box
        color = colors[d.class_id % n]
        for t in range(thickness):
            draw.rectangle([x1 + t, y1 + t, x2 - t, y2 - t], outline=color)
        draw.text((x1 + 2, max(y1 - 12, 0)), f"{d.class_name} {d.score:.2f}", fill=color,
                  font=font)
    return image
