"""Inference API: the serving path on the card. Port of
``yoloret_tpu/infer/predictor.py`` (``Detection``, ``Predictor`` with
``detect_arrays``, ``detect_image`` and ``detect_video``, its int8
backbone, zoom-in ensemble and data-parallel mesh, ``draw_detections``,
``_make_tracker``). ``frame_schedule`` is ``detect_video``'s per-frame
schedule (detect or track) without OpenCV.

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

``mesh`` (``parallel.mesh.make_mesh``) serves data-parallel from one
process: each entry of the mesh's data axis holds a replica of the
weights on its device (its own folded and packed MBConv weights, its
own int8 parameters), the buckets round up to multiples of the data
axis, and ``infer`` splits each padded batch into equal shards in
order, enqueues each shard's forward and postprocess on its device's
stream, with that device current, and gathers the slates in order on
the first device. The replicas share nothing, so the slates are one
device's. A mesh whose ``model`` axis is above 1 splits each shard's
images by rows over its model group (``parallel/spatial.py``: the
weights once a device, the fused kernel on each row shard's slabs), and
runs the shard's postprocess on the group's first device on the
gathered heads: the int8 backbone there runs on the row shards too (its
int8 params calibrated once, copied once a device), and the zoom
ensemble's centre crop is split over the row shards as an image of its
own.
"""

from __future__ import annotations

import colorsys
import dataclasses
import time
from collections import deque
from typing import (Any, Callable, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from yoloret_tpu_torch.data.annotations import load_anchors, load_classes
from yoloret_tpu_torch.data.augment import to_unit_float
from yoloret_tpu_torch.device import DeviceLike, on_device, resolve_device, upload
from yoloret_tpu_torch.nn.detector import YoloReT
from yoloret_tpu_torch.nn.fused_infer import fused_detector_apply, fused_params
from yoloret_tpu_torch.nn.int8_infer import int8_detector_apply, quantize_from_data, supports_int8
from yoloret_tpu_torch.nn.layers import init_weights
from yoloret_tpu_torch.ops.letterbox import letterbox_numpy_u8
from yoloret_tpu_torch.ops.nms import NMSResult
from yoloret_tpu_torch.ops.postprocess import detect_batch
from yoloret_tpu_torch.parallel.mesh import Mesh, replicate, shard_batch
from yoloret_tpu_torch.parallel.spatial import Replica, spatial_forward, spatial_params
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
        mesh: Optional[Mesh] = None,
    ):
        self.mesh = mesh
        self._n_data = 1 if mesh is None else mesh.data
        self.device = resolve_device(device if mesh is None else mesh.devices[0])
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
        self.batch_buckets = _round_buckets(batch_buckets, self._n_data)
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
        ``use_int8`` re-calibrate and re-quantize them; on a mesh, copy
        them to every data shard's first device (with a model axis above
        1, to every device of the mesh once, the int8 params with them)
        and fold and pack each there."""
        self._anchors_t = torch.as_tensor(self.anchors, device=self.device)
        self._qp = None if self._calib is None else quantize_from_data(self.model, self._calib)
        self._spatial = None
        if self.mesh is not None and self.mesh.model > 1:
            self._spatial = spatial_params(self.model, self.mesh, self._qp)
            self._fused = self._spatial[self.device].fused
            self._replicas = []  # each data shard's forward runs over its model group
            self._anchors = [self._anchors_t.to(dev) for dev in self.mesh.data_devices]
            return
        with on_device(self.device):
            self._fused = fused_params(self.model) if self._qp is None else None
        self._replicas = [Replica(self.model, self._qp, self._fused)]
        self._anchors = [self._anchors_t]
        if self.mesh is not None:
            copies = replicate(self.mesh, [self.model, self._qp, self._anchors_t])
            for dev, (model, qp, anchors) in list(zip(self.mesh.data_devices, copies))[1:]:
                with on_device(dev):
                    fused = fused_params(model) if qp is None else None
                self._replicas.append(Replica(model, qp, fused))
                self._anchors.append(anchors)

    def _forward(self, images: torch.Tensor, replica: int = 0):
        model, qp, fused = self._replicas[replica]
        if qp is not None:
            return int8_detector_apply(model, qp, images)
        return fused_detector_apply(model, images, fused)

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
        the zoom ensemble). Asynchronous on CUDA. On a mesh the batch must
        split evenly over the data axis; the slates come back on the first
        device, in order."""
        kw = dict(score_threshold=score_threshold, iou_threshold=iou_threshold,
                  num_candidates=num_candidates, pool=pool)
        if self.mesh is None:
            return self._infer_replica(0, images, image_hw, **kw)
        shards = shard_batch(self.mesh, (images, image_hw))
        if self._spatial is not None:
            xs = [to_unit_float(x) for x, _ in shards]
            heads = spatial_forward(self.model, self.mesh, xs, self._spatial)
            zoom = [None] * len(xs)
            if self.zoom_ensemble:
                zoom = spatial_forward(self.model, self.mesh, xs, self._spatial,
                                       crop=self._zoom_box(xs[0]))
        slates = []
        for i, (dev, (x, hw)) in enumerate(zip(self.mesh.data_devices, shards)):
            with on_device(dev):
                slates.append(self._infer_replica(i, x, hw, **kw) if self._spatial is None
                              else self._postprocess(i, heads[i], hw, zoom[i], **kw))
        return NMSResult(*(torch.cat([field.to(self.device) for field in fields])
                           for fields in zip(*slates)))

    def _infer_replica(self, replica: int, images: torch.Tensor, image_hw: torch.Tensor,
                       **kw) -> NMSResult:
        images = to_unit_float(images)
        outs = self._forward(images, replica)
        zoom_outs = None
        if self.zoom_ensemble:
            y0, x0, zh, zw = self._zoom_box(images)
            zoom_outs = self._forward(images[:, y0:y0 + zh, x0:x0 + zw, :], replica)
        return self._postprocess(replica, outs, image_hw, zoom_outs, **kw)

    def _zoom_box(self, images: torch.Tensor) -> Tuple[int, int, int, int]:
        """(y0, x0, zh, zw): the zoom ensemble's centre crop of ``images``
        [B, H, W, 3]."""
        (h, w), (zh, zw) = images.shape[1:3], self.zoom_hw
        return (h - zh) // 2, (w - zw) // 2, zh, zw

    def _postprocess(self, replica: int, outs, image_hw: torch.Tensor, zoom_outs, *,
                     score_threshold: Optional[float], iou_threshold: Optional[float],
                     num_candidates: Optional[int], pool: Optional[str]) -> NMSResult:
        """Data shard ``replica``'s slates from its heads ``outs`` (and the
        zoom ensemble's ``zoom_outs``), on its device."""
        return detect_batch(
            outs, self._anchors[replica], len(self.class_names), image_hw,
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

    # -- video API (reference detect_video, yolo.py:435-554) ----------------

    def detect_video(self, source, output: Optional[str] = None,
                     max_frames: Optional[int] = None, track_interval: int = 1,
                     max_tracks: int = 20) -> int:
        """OpenCV capture loop with an FPS overlay; returns the number of
        frames processed. ``source`` is a file, or ``0`` / ``"0"`` for the
        camera (``IOError`` when it does not open); with ``output`` the
        frames are written there as mp4v at the source's FPS (25 when it
        reports none), each with its boxes, labels and FPS drawn.

        ``track_interval=1`` (default) detects every frame.
        ``track_interval=N>1`` is the reference's interleave (yolo.py:
        470-520): detect on frames 0, N, 2N, ..., hand each of at most
        ``max_tracks`` boxes to a tracker (``_make_tracker``: CSRT, else
        KCF, else MIL), and carry the boxes whose tracker still holds
        through the frames between (``frame_schedule``). The detector
        sees each frame in RGB, the trackers in OpenCV's BGR."""
        import cv2

        cap = cv2.VideoCapture(0 if source in ("0", 0) else source)
        if not cap.isOpened():
            raise IOError(f"cannot open video source {source!r}")
        writer = None
        if output:
            fourcc = cv2.VideoWriter_fourcc(*"mp4v")
            fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
            w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            writer = cv2.VideoWriter(output, fourcc, fps, (w, h))

        def frames():
            n = 0
            while True:
                ok, frame = cap.read()
                if not ok or (max_frames is not None and n >= max_frames):
                    return
                n += 1
                yield frame

        def detect(frame):
            return self.detect_arrays([cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)])[0]

        n, t0 = 0, time.perf_counter()
        try:
            for frame, dets in frame_schedule(frames(), detect, lambda: _make_tracker(cv2),
                                              track_interval, max_tracks):
                for d in dets:
                    x1, y1, x2, y2 = [int(v) for v in d.box]
                    cv2.rectangle(frame, (x1, y1), (x2, y2), (0, 255, 0), 2)
                    cv2.putText(frame, f"{d.class_name} {d.score:.2f}", (x1, max(y1 - 4, 10)),
                                cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1)
                fps_now = (n + 1) / (time.perf_counter() - t0)
                cv2.putText(frame, f"FPS: {fps_now:.1f}", (8, 24), cv2.FONT_HERSHEY_SIMPLEX, 0.8,
                            (0, 0, 255), 2)
                if writer is not None:
                    writer.write(frame)
                n += 1
        finally:
            cap.release()
            if writer is not None:
                writer.release()
        return n


def _round_buckets(buckets: Sequence[int], n: int) -> Tuple[int, ...]:
    """The batch buckets, each rounded up to a multiple of the mesh's data
    axis ``n`` so that every shard has one shape, sorted, without
    repeats."""
    return tuple(sorted({-(-int(b) // n) * n for b in buckets}))


def frame_schedule(frames: Iterable[np.ndarray], detect: Callable[[np.ndarray], List[Detection]],
                   make_tracker: Optional[Callable[[], Any]] = None, track_interval: int = 1,
                   max_tracks: int = 20) -> Iterator[Tuple[np.ndarray, List[Detection]]]:
    """The per-frame schedule of ``Predictor.detect_video``, without
    OpenCV: yields (frame, detections) for each of ``frames`` ([H, W, 3]
    arrays), one at a time.

    Frame n is detected (``detect(frame)``) when ``track_interval <= 1``
    or n is a multiple of it. With ``track_interval > 1`` each detection
    frame drops the trackers and seeds one (``make_tracker()``, then
    ``init(frame, (x, y, w, h))`` in ints) for each of the first
    ``max_tracks`` detections, its box clamped into the frame; every
    other frame calls each tracker's ``update(frame)`` -> (ok, (x, y, w,
    h)) and carries only the detections whose update succeeded, with the
    tracker's box and their own score and class."""
    trackers: List[Tuple[Any, Detection]] = []
    for n, frame in enumerate(frames):
        if track_interval <= 1 or n % track_interval == 0:
            dets = detect(frame)
            if track_interval > 1:
                trackers = []
                h, w = frame.shape[:2]
                for d in dets[:max_tracks]:
                    x1, y1, x2, y2 = d.box
                    x1 = max(0.0, min(x1, w - 2.0))
                    y1 = max(0.0, min(y1, h - 2.0))
                    bw = max(1.0, min(x2, w) - x1)
                    bh = max(1.0, min(y2, h) - y1)
                    t = make_tracker()
                    t.init(frame, (int(x1), int(y1), int(bw), int(bh)))
                    trackers.append((t, d))
        else:
            dets, kept = [], []
            for t, d in trackers:
                ok, (x, y, bw, bh) = t.update(frame)
                if not ok:
                    continue
                d = Detection((float(x), float(y), float(x + bw), float(y + bh)), d.score,
                              d.class_id, d.class_name)
                kept.append((t, d))
                dets.append(d)
            trackers = kept
        yield frame, dets


def _make_tracker(cv2):
    """The best single-object tracker OpenCV has: CSRT (the reference's,
    yolo.py:474) when it ships contrib, else KCF, else MIL, looked up in
    ``cv2``, ``cv2.legacy`` and as ``cv2.Tracker<Name>_create``."""
    for name in ("TrackerCSRT", "TrackerKCF", "TrackerMIL"):
        cls = getattr(cv2, name, None) or getattr(getattr(cv2, "legacy", None), name, None)
        if cls is not None:
            try:
                return cls.create()
            except Exception:
                pass
        fn = getattr(cv2, f"{name}_create", None)
        if fn is not None:
            return fn()
    raise RuntimeError("no OpenCV tracker implementation available")


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


def int8_options(cfg) -> dict:
    """Predictor arguments for a ``RunConfig``'s ``int8``: the W8A8
    backbone calibrated on up to ``quantize_samples`` images of
    ``test_dataset`` (else
    ``train_dataset``; text lists and TFRecord shards, in sorted glob
    order), letterboxed to uint8 at the input size; on noise when neither
    is set. {} without ``int8``. The CLI and the tools call it."""
    if not cfg.int8:
        return {}
    import glob
    import io

    from PIL import Image

    from yoloret_tpu_torch.data.annotations import parse_annotation_line
    from yoloret_tpu_torch.data.tfrecord import Example, index_tfrecord, read_record_at

    def encoded(path):
        for off, ln in index_tfrecord(path):
            yield io.BytesIO(Example.parse(read_record_at(path, off, ln)).features[
                "image/encoded"])

    def listed(path):
        with open(path) as fh:
            for line in fh:
                if line.strip():
                    yield parse_annotation_line(line)[0]

    imgs = []
    source = cfg.test_dataset or cfg.train_dataset
    for path in sorted(glob.glob(source)) if source else ():
        for f in encoded(path) if path.endswith(".tfrecord") else listed(path):
            arr = np.asarray(Image.open(f).convert("RGB"), np.uint8)
            imgs.append(letterbox_numpy_u8(arr, cfg.input_size))
            if len(imgs) >= cfg.quantize_samples:
                break
        if len(imgs) >= cfg.quantize_samples:
            break
    return dict(use_int8=True, calibration_images=np.stack(imgs) if imgs else None)
