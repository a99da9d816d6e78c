"""Evaluation input pipeline: annotation lists and TFRecord shards ->
decoded staging squares on the host -> batches letterboxed on the device.
Port of the TEST/VALIDATE side of ``yoloret_tpu/data/pipeline.py``
(``DatasetMode``, ``Dataset``, ``_load_sample``, ``_host_batches``,
``_finalize_eval``, ``build``).

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
The final partial batch is padded to the batch size by repeating its
last sample and carries ``n_valid``, so no image is dropped and none is
counted twice.

TRAIN mode (augmentation, targets) is not ported yet: ROADMAP.md, queue
1, item 4 (training).
"""

from __future__ import annotations

import enum
import glob as globlib
import io
import queue
import threading
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np

from yoloret_tpu_torch import native
from yoloret_tpu_torch.data.annotations import parse_annotation_line
from yoloret_tpu_torch.data.augment import AugmentConfig, eval_batch
from yoloret_tpu_torch.data.tfrecord import Example, index_tfrecord, read_record_at
from yoloret_tpu_torch.device import DeviceLike, resolve_device, upload


class DatasetMode(enum.Enum):
    TRAIN = "train"
    VALIDATE = "validate"
    TEST = "test"


def _staging_u8(img, staging: int) -> np.ndarray:
    """PIL image -> uint8 [S, S, 3], stretched to the staging square."""
    from PIL import Image

    return np.asarray(img.convert("RGB").resize((staging, staging), Image.BILINEAR), np.uint8)


def _decode(source, staging: int) -> Tuple[np.ndarray, Tuple[int, int], str]:
    """An image file path or encoded bytes -> (uint8 [S, S, 3], (H, W) of
    the original, the decoder: "native" or "pil"). The native loader
    takes JPEG paths and all bytes, as in the JAX package's eval path
    (``yoloret_tpu/data/pipeline.py::_decode_image`` and the TFRecord
    branch of ``_load_sample``, quality 0: no re-encode)."""
    is_bytes = isinstance(source, bytes)
    if (is_bytes or source.lower().endswith((".jpg", ".jpeg"))) and native.available():
        try:
            if is_bytes:
                return (*native.decode_resize_q_bytes_u8(source, staging, 0), "native")
            return (*native.decode_resize_q_u8(source, staging, 0), "native")
        except IOError:
            pass  # not a JPEG after all (e.g. a PNG payload): PIL below
    from PIL import Image

    with Image.open(io.BytesIO(source) if is_bytes else source) as img:
        iw, ih = img.size
        return _staging_u8(img, staging), (ih, iw), "pil"


class _Failure:
    def __init__(self, error: BaseException):
        self.error = error


_END = object()


@dataclass
class Dataset:
    """An evaluation dataset: ``glob`` names text annotation lists and
    ``.tfrecord`` shards, mixed as in the reference (code/yolo3/data.py:
    185-200). ``build`` yields device batches of ``batch_size``."""

    glob: str
    batch_size: int
    input_hw: Tuple[int, int] = (320, 320)
    mode: DatasetMode = DatasetMode.TEST
    max_boxes: int = 20
    staging: Optional[int] = None  # default: max(input_hw)
    num_workers: int = 8
    prefetch: int = 2
    device: DeviceLike = "cuda"
    augment: AugmentConfig = field(init=False)
    decodes: Counter = field(init=False)  # decodes by decoder ("native", "pil")

    def __post_init__(self):
        if self.mode == DatasetMode.TRAIN:
            raise NotImplementedError(
                "Dataset(mode=TRAIN): training augmentation and targets are not ported yet "
                "(ROADMAP.md, queue 1, item 4); use TEST or VALIDATE")
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be at least 1, not {self.batch_size}")
        self.device = resolve_device(self.device)
        self.staging = self.staging or max(self.input_hw)
        self.augment = AugmentConfig(input_hw=tuple(self.input_hw))
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

    def __len__(self) -> int:
        return len(self._parsed) + len(self._records)

    # -- host side ---------------------------------------------------------

    def _load_sample(self, idx: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]:
        """(uint8 staging image, boxes [T, 5] normalised to the original
        image, valid [T], original (H, W)) of sample ``idx``: text-list
        lines first, then TFRecord records."""
        if idx < len(self._parsed):
            path, boxes = self._parsed[idx]
            img, (ih, iw), decoder = _decode(path, self.staging)
            b = boxes.copy()
            if len(b):
                b[:, [0, 2]] /= float(iw)
                b[:, [1, 3]] /= float(ih)
        else:
            # Example with the encoded image and normalised boxes (schema
            # of the reference's code/voc_annotation.py:31-60)
            shard, off, ln = self._records[idx - len(self._parsed)]
            f = Example.parse(read_record_at(shard, off, ln)).features
            img, (ih, iw), decoder = _decode(f["image/encoded"], self.staging)
            cols = [np.asarray(f.get(f"image/object/bbox/{k}", []), np.float32)
                    for k in ("xmin", "ymin", "xmax", "ymax", "label")]
            b = np.stack(cols, axis=-1) if len(cols[0]) else np.zeros((0, 5), np.float32)
        with self._decodes_lock:
            self.decodes[decoder] += 1
        t = self.max_boxes
        out = np.zeros((t, 5), np.float32)
        n = min(len(b), t)
        out[:n] = b[:n]
        valid = np.zeros((t,), bool)
        valid[:n] = True
        return img, out, valid, (ih, iw)

    def _host_batches(self, epochs: Optional[int]) -> Iterator[dict]:
        if not len(self):
            return
        order = np.arange(len(self))
        epoch = 0
        with ThreadPoolExecutor(self.num_workers) as pool:
            while epochs is None or epoch < epochs:
                for start in range(0, len(order), self.batch_size):
                    idxs = order[start:start + self.batch_size]
                    n_valid = len(idxs)
                    if n_valid < self.batch_size:
                        idxs = np.concatenate(
                            [idxs, np.repeat(idxs[-1:], self.batch_size - n_valid)])
                    samples = list(pool.map(self._load_sample, idxs))
                    yield {
                        "images": np.stack([s[0] for s in samples]),
                        "boxes": np.stack([s[1] for s in samples]),
                        "valid": np.stack([s[2] for s in samples]),
                        "image_hw": np.asarray([s[3] for s in samples], np.float32),
                        "n_valid": n_valid,
                    }
                epoch += 1

    # -- device side ---------------------------------------------------------

    def _finalize_eval(self, host: dict) -> dict:
        """The letterboxed device batch, with the ground truth in original
        image pixels for the mAP evaluator, which reads it on the host
        (``orig_boxes`` [B, T, 5] and ``orig_valid`` [B, T] stay numpy).
        The JAX package's batch also carries the ``y_true_*`` targets and
        ``gt_boxes`` / ``gt_valid``, which only the validation loss reads;
        they come with the training slice."""
        hw = host["image_hw"]
        image_hw = upload(hw, self.device)
        images, boxes_px, keep = eval_batch(
            upload(host["images"], self.device), upload(host["boxes"], self.device),
            upload(host["valid"], self.device), image_hw, self.augment)
        orig = host["boxes"].copy()
        orig[..., [0, 2]] *= hw[:, None, 1:2]
        orig[..., [1, 3]] *= hw[:, None, 0:1]
        return {
            "images": images,
            "image_hw": image_hw,
            "boxes_px": boxes_px,
            "boxes_valid": keep,
            "orig_boxes": orig,
            "orig_valid": host["valid"],
            "n_valid": host["n_valid"],  # real samples in the batch
        }

    def build(self, epochs: Optional[int] = None) -> Iterator[dict]:
        """Iterator of finalized device batches (``epochs`` None: forever).
        A prefetch thread decodes ahead; an error there is raised here.
        Closing the iterator stops the thread."""
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
                for host in self._host_batches(epochs):
                    if not put(host):
                        return
                put(_END)
            except Exception as e:  # handed to the consumer, which raises it
                put(_Failure(e))

        thread = threading.Thread(target=producer, name="yoloret-eval-prefetch", daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, _Failure):
                    raise item.error
                yield self._finalize_eval(item)
        finally:
            stop.set()
            thread.join()
