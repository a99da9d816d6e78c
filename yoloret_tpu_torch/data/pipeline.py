"""Input pipeline: annotation lists and TFRecord shards -> decoded
staging squares on the host -> batches augmented (TRAIN) or letterboxed
(VALIDATE, TEST) on the device. Port of ``yoloret_tpu/data/pipeline.py``
(``DatasetMode``, ``Dataset``, ``_load_sample``, ``_host_batches``,
``_finalize_train``, ``_finalize_eval``, ``build``).

A thread pool decodes each batch, with the decoder the JAX package
prefers: JPEG files (``.jpg``/``.jpeg``) and every TFRecord payload go
to the native libjpeg loader (``yoloret_tpu_torch/native``: a
DCT-scaled decode, then a half-pixel bilinear stretch to the staging
square; ctypes releases the interpreter lock for each call), other
files, payloads the loader refuses (a PNG) and every image where the
loader cannot be built go to PIL (decode, then a bilinear stretch).
``Dataset.decodes`` counts the decodes by decoder. One prefetch thread
keeps ``prefetch`` batches ahead of the consumer. The uint8 staging
images go to the device pinned and asynchronous, where
``data/augment.py::eval_batch`` letterboxes them.
The final partial eval batch is padded to the batch size by repeating
its last sample and carries ``n_valid``, so no image is dropped and none
is counted twice.

The host stream is the JAX package's, bit for bit: a
``np.random.RandomState(seed)`` shuffles the order of each TRAIN epoch
and draws each sample's JPEG re-encode quality in [80, 100] (the native
loader re-encodes in the same call; PIL saves and reopens), the final
partial TRAIN batch is dropped, and ``skip_batches`` replays the draws
of the batches it skips without decoding them. With ``aa_policy`` the
stream also draws one AutoAugment seed per sample, after the batch's JPEG
qualities and before the skip test, and each TRAIN sample is distorted on
its staging square (``tools/autoaugment.py``). The device draws of the
augmentation come from a ``torch.Generator`` seeded by the seed and the
batch's position in the stream, so that a stream resumed at batch k
augments batch k as the uninterrupted one does; the online mosaic and
mixup (``mosaic_prob``, ``mixup_prob``: ``data/augment.py::mix_batch``)
draw from a generator of their own, seeded the same way, so the
augmentation draws do not depend on them. TRAIN and VALIDATE batches
carry the dense targets ``y_true_{l}`` and the ground truth of the
loss's ignore mask, ``gt_boxes`` / ``gt_valid``; with mixing on, their
box axis is the mixed batch's (4T with mosaic, 2T with mixup alone).

Not ported (ROADMAP.md, queue 1): per-host input sharding (item 6).
"""

from __future__ import annotations

import dataclasses
import enum
import glob as globlib
import io
import queue
import threading
import warnings
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from yoloret_tpu_torch import native
from yoloret_tpu_torch.data.annotations import parse_annotation_line
from yoloret_tpu_torch.data.augment import (
    AugmentConfig,
    augment_batch,
    draw_augment,
    draw_mix,
    eval_batch,
    mix_batch,
)
from yoloret_tpu_torch.data.tfrecord import Example, index_tfrecord, read_record_at
from yoloret_tpu_torch.device import DeviceLike, resolve_device, upload
from yoloret_tpu_torch.ops.targets import assign_targets_batch, true_corner_boxes
from yoloret_tpu_torch.tools.autoaugment import distort_image_with_autoaugment


# The range of training's random JPEG re-encode quality (the reference's).
JPEG_QUALITY = (80, 100)
# Offsets the seed of the mixing draws' generator from the augmentation's
# (the JAX package folds 0x6D6978, "mix", into the batch's key).
MIX_STREAM = 0x6D6978


class DatasetMode(enum.Enum):
    TRAIN = "train"
    VALIDATE = "validate"
    TEST = "test"


def _staging_u8(img, staging: int) -> np.ndarray:
    """PIL image -> uint8 [S, S, 3], stretched to the staging square."""
    from PIL import Image

    return np.asarray(img.convert("RGB").resize((staging, staging), Image.BILINEAR), np.uint8)


def _decode(source, staging: int, quality: Optional[int] = None
            ) -> Tuple[np.ndarray, Tuple[int, int], str]:
    """An image file path or encoded bytes -> (uint8 [S, S, 3], (H, W) of
    the original, the decoder: "native" or "pil"). The native loader
    takes JPEG paths and all bytes, as in the JAX package
    (``yoloret_tpu/data/pipeline.py::_decode_image`` and the TFRecord
    branch of ``_load_sample``). ``quality`` re-encodes the staging
    square as a JPEG of that quality and decodes it again (training's
    random JPEG quality); None keeps it."""
    is_bytes = isinstance(source, bytes)
    if (is_bytes or source.lower().endswith((".jpg", ".jpeg"))) and native.available():
        try:
            if is_bytes:
                return (*native.decode_resize_q_bytes_u8(source, staging, quality or 0), "native")
            return (*native.decode_resize_q_u8(source, staging, quality or 0), "native")
        except IOError:
            pass  # not a JPEG after all (e.g. a PNG payload): PIL below
    from PIL import Image

    with Image.open(io.BytesIO(source) if is_bytes else source) as img:
        iw, ih = img.size
        u8 = _staging_u8(img, staging)
    if quality is not None:
        buf = io.BytesIO()
        Image.fromarray(u8).save(buf, format="JPEG", quality=int(quality))
        buf.seek(0)
        u8 = np.asarray(Image.open(buf).convert("RGB"), np.uint8)
    return u8, (ih, iw), "pil"


class _Failure:
    def __init__(self, error: BaseException):
        self.error = error


_END = object()


@dataclass
class Dataset:
    """A dataset: ``glob`` names text annotation lists and ``.tfrecord``
    shards, mixed as in the reference (code/yolo3/data.py:185-200).
    ``build`` yields device batches of ``batch_size``. TRAIN and VALIDATE
    need ``anchors`` [9, 2] and ``num_classes`` for their targets."""

    glob: str
    batch_size: int
    input_hw: Tuple[int, int] = (320, 320)
    mode: DatasetMode = DatasetMode.TEST
    max_boxes: int = 20
    staging: Optional[int] = None  # default: max(input_hw)
    num_workers: int = 8
    prefetch: int = 2
    device: DeviceLike = "cuda"
    anchors: Optional[np.ndarray] = None
    num_classes: Optional[int] = None
    num_scales: int = 3
    seed: int = 0
    augment_config: Optional[AugmentConfig] = None  # TRAIN augmentation override
    aa_policy: Optional[str] = None  # online AutoAugment policy ("v0".."v3"), TRAIN only
    augment: AugmentConfig = field(init=False)
    decodes: Counter = field(init=False)  # decodes by decoder ("native", "pil")

    def __post_init__(self):
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be at least 1, not {self.batch_size}")
        if self.mode != DatasetMode.TEST and (self.anchors is None or not self.num_classes):
            raise ValueError(f"Dataset(mode={self.mode.name}) needs anchors and num_classes "
                             "for its targets")
        self.device = resolve_device(self.device)
        self.staging = self.staging or max(self.input_hw)
        base = self.augment_config or AugmentConfig()
        self.augment = dataclasses.replace(base, input_hw=tuple(self.input_hw),
                                           max_boxes=self.max_boxes)
        # mixing draws its partners from the batch: below 4 rows mosaic
        # repeats tiles, below 2 mixup blends a sample with itself
        if self.augment.mosaic_prob > 0 and self.batch_size < 4:
            warnings.warn(f"mosaic_prob > 0 with a batch of {self.batch_size} (< 4): mosaic "
                          "tiles will repeat images", stacklevel=2)
        if self.augment.mixup_prob > 0 and self.batch_size < 2:
            warnings.warn(f"mixup_prob > 0 with a batch of {self.batch_size} (< 2): mixup "
                          "would blend a sample with itself", stacklevel=2)
        if self.anchors is not None:
            self._anchors = torch.as_tensor(np.asarray(self.anchors, np.float32),
                                            device=self.device)
        self.decodes = Counter()
        self._decodes_lock = threading.Lock()
        files = (sorted(globlib.glob(self.glob)) if any(c in self.glob for c in "*?[")
                 else [self.glob])
        if not files:
            raise FileNotFoundError(f"no dataset files match {self.glob!r}")
        self.lines: List[str] = []
        self._records: List[Tuple[str, int, int]] = []
        for f in files:
            if f.endswith(".tfrecord"):
                self._records.extend((f, off, ln) for off, ln in index_tfrecord(f))
            else:
                with open(f) as fh:
                    self.lines.extend(line for line in fh if line.strip())
        self._parsed = [parse_annotation_line(line) for line in self.lines]
        if self.mode == DatasetMode.TRAIN and len(self) < self.batch_size:
            # drop-last training would yield no batch at all
            raise ValueError(f"training dataset has {len(self)} samples but the batch is "
                             f"{self.batch_size}; reduce --batch_size")

    def __len__(self) -> int:
        return len(self._parsed) + len(self._records)

    def steps_per_epoch(self) -> int:
        return max(1, len(self) // self.batch_size)

    # -- host side ---------------------------------------------------------

    def _load_sample(self, idx: int, quality: Optional[int] = None,
                     aa_seed: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]:
        """(uint8 staging image, boxes [T, 5] normalised to the original
        image, valid [T], original (H, W)) of sample ``idx``: text-list
        lines first, then TFRecord records. ``quality``: the pre-drawn
        JPEG re-encode quality (None: none); ``aa_seed``: the pre-drawn
        seed of the sample's AutoAugment (None: none)."""
        if idx < len(self._parsed):
            path, boxes = self._parsed[idx]
            img, (ih, iw), decoder = _decode(path, self.staging, quality)
            b = boxes.copy()
            if len(b):
                b[:, [0, 2]] /= float(iw)
                b[:, [1, 3]] /= float(ih)
        else:
            # Example with the encoded image and normalised boxes (schema
            # of the reference's code/voc_annotation.py:31-60)
            shard, off, ln = self._records[idx - len(self._parsed)]
            f = Example.parse(read_record_at(shard, off, ln)).features
            img, (ih, iw), decoder = _decode(f["image/encoded"], self.staging, quality)
            cols = [np.asarray(f.get(f"image/object/bbox/{k}", []), np.float32)
                    for k in ("xmin", "ymin", "xmax", "ymax", "label")]
            b = np.stack(cols, axis=-1) if len(cols[0]) else np.zeros((0, 5), np.float32)
        with self._decodes_lock:
            self.decodes[decoder] += 1
        if aa_seed is not None:
            # the boxes are fractions of the original image, so of the
            # stretched staging square too: to its pixels, distort, back
            s = float(self.staging)
            px = np.asarray(b, np.float64).reshape(-1, 5).copy()
            px[:, :4] *= s
            img, px = distort_image_with_autoaugment(img, px, self.aa_policy,
                                                     np.random.RandomState(aa_seed))
            b = px.astype(np.float32)
            b[:, :4] /= s
        t = self.max_boxes
        out = np.zeros((t, 5), np.float32)
        n = min(len(b), t)
        out[:n] = b[:n]
        valid = np.zeros((t,), bool)
        valid[:n] = True
        return img, out, valid, (ih, iw)

    def host_plan(self, epochs: Optional[int], skip: int = 0
                  ) -> Iterator[Tuple[np.ndarray, int, List[Optional[int]],
                                      List[Optional[int]]]]:
        """The host stream without the decodes: (sample indices, real
        samples, JPEG qualities, AutoAugment seeds) per batch, the JAX
        package's draws in its order (``_host_batches``). The first
        ``skip`` batches are drawn and not yielded."""
        if not len(self):
            return
        rng = np.random.RandomState(self.seed)
        order = np.arange(len(self))
        train = self.mode == DatasetMode.TRAIN
        epoch = 0
        while epochs is None or epoch < epochs:
            if train:
                rng.shuffle(order)
            for start in range(0, len(order), self.batch_size):
                idxs = order[start:start + self.batch_size]
                n_valid = len(idxs)
                if n_valid < self.batch_size:
                    if train or n_valid == 0:
                        break
                    idxs = np.concatenate(
                        [idxs, np.repeat(idxs[-1:], self.batch_size - n_valid)])
                if train:
                    lo, hi = JPEG_QUALITY
                    qs = [int(q) for q in rng.randint(lo, hi + 1, size=len(idxs))]
                else:
                    qs = [None] * len(idxs)
                if train and self.aa_policy:
                    aas = [int(s) for s in rng.randint(0, 2**31 - 1, size=len(idxs))]
                else:
                    aas = [None] * len(idxs)
                if skip > 0:
                    skip -= 1
                    continue
                yield idxs, n_valid, qs, aas
            epoch += 1

    def _host_batches(self, epochs: Optional[int], skip: int = 0) -> Iterator[dict]:
        with ThreadPoolExecutor(self.num_workers) as pool:
            for idxs, n_valid, qs, aas in self.host_plan(epochs, skip):
                samples = list(pool.map(self._load_sample, idxs, qs, aas))
                yield {
                    "images": np.stack([s[0] for s in samples]),
                    "boxes": np.stack([s[1] for s in samples]),
                    "valid": np.stack([s[2] for s in samples]),
                    "image_hw": np.asarray([s[3] for s in samples], np.float32),
                    "n_valid": n_valid,
                }

    # -- device side ---------------------------------------------------------

    def _targets(self, boxes_px: torch.Tensor, keep: torch.Tensor) -> dict:
        """``y_true_{l}`` and the loss's ``gt_boxes`` / ``gt_valid`` of the
        kept boxes (network-input pixels)."""
        boxes_px = torch.where(keep[..., None], boxes_px, torch.zeros_like(boxes_px))
        ys = assign_targets_batch(boxes_px, self.input_hw, self._anchors, self.num_classes,
                                  self.num_scales)
        gt, gt_valid = true_corner_boxes(boxes_px, self.input_hw)
        out = {"gt_boxes": gt, "gt_valid": gt_valid & keep}
        for l in range(self.num_scales):
            out[f"y_true_{l}"] = ys[l]
        return out

    def _augment_generator(self, position: int, stream: int = 0) -> torch.Generator:
        """The generator of the augmentation draws (``stream`` 0) or of the
        mixing draws (``MIX_STREAM``) of the batch at ``position`` in the
        TRAIN stream."""
        return torch.Generator().manual_seed(
            (self.seed * 1_000_003 + position + stream * 7_919) % (2 ** 63))

    def _finalize_train(self, host: dict, position: int) -> dict:
        """The augmented (and mixed) device batch with its targets."""
        batch = host["images"].shape[0]
        draws = draw_augment(batch, self.augment, self._augment_generator(position),
                             self.device)
        images, boxes_px, keep = augment_batch(
            upload(host["images"], self.device), upload(host["boxes"], self.device),
            upload(host["valid"], self.device), self.augment, draws)
        if self.augment.mosaic_prob > 0 or self.augment.mixup_prob > 0:
            mix = draw_mix(batch, self.augment,
                           self._augment_generator(position, MIX_STREAM), self.device)
            images, boxes_px, keep = mix_batch(images, boxes_px, keep, self.augment, mix)
        return {"images": images, **self._targets(boxes_px, keep)}

    def _finalize_eval(self, host: dict) -> dict:
        """The letterboxed device batch, with the ground truth in original
        image pixels for the mAP evaluator, which reads it on the host
        (``orig_boxes`` [B, T, 5] and ``orig_valid`` [B, T] stay numpy).
        VALIDATE batches also carry the targets of the validation loss."""
        hw = host["image_hw"]
        image_hw = upload(hw, self.device)
        images, boxes_px, keep = eval_batch(
            upload(host["images"], self.device), upload(host["boxes"], self.device),
            upload(host["valid"], self.device), image_hw, self.augment)
        orig = host["boxes"].copy()
        orig[..., [0, 2]] *= hw[:, None, 1:2]
        orig[..., [1, 3]] *= hw[:, None, 0:1]
        out = {
            "images": images,
            "image_hw": image_hw,
            "boxes_px": boxes_px,
            "boxes_valid": keep,
            "orig_boxes": orig,
            "orig_valid": host["valid"],
            "n_valid": host["n_valid"],  # real samples in the batch
        }
        if self.mode == DatasetMode.VALIDATE:
            out.update(self._targets(boxes_px, keep))
        return out

    def build(self, epochs: Optional[int] = None, skip_batches: int = 0) -> Iterator[dict]:
        """Iterator of finalized device batches (``epochs`` None: forever).
        A prefetch thread decodes ahead; an error there is raised here.
        Closing the iterator stops the thread. ``skip_batches`` starts the
        stream at that batch: the host draws of the skipped batches are
        replayed without decoding and the device draws are seeded by the
        position, so batch ``skip_batches + i`` is the batch an
        uninterrupted stream yields there."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                for host in self._host_batches(epochs, skip_batches):
                    if not put(host):
                        return
                put(_END)
            except Exception as e:  # handed to the consumer, which raises it
                put(_Failure(e))

        thread = threading.Thread(target=producer, name="yoloret-prefetch", daemon=True)
        thread.start()
        position = skip_batches
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, _Failure):
                    raise item.error
                if self.mode == DatasetMode.TRAIN:
                    yield self._finalize_train(item, position)
                else:
                    yield self._finalize_eval(item)
                position += 1
        finally:
            stop.set()
            thread.join()
