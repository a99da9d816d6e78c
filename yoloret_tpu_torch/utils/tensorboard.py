"""Minimal TensorBoard event-file writer (scalars and images), with no
TensorFlow. A copy of ``yoloret_tpu/utils/tensorboard.py``, on the port's
own protobuf wire helpers and TFRecord framing (``data/tfrecord.py``).

Wire format: each record is an ``Event`` proto --
  Event { double wall_time = 1; int64 step = 2; Summary summary = 5; }
  Summary { repeated Value value = 1; }
  Summary.Value { string tag = 1; float simple_value = 2; Image image = 4; }
  Image { int32 height = 1; int32 width = 2; int32 colorspace = 3;
          bytes encoded_image_string = 4; }  (PNG, encoded by PIL)
The first record is a version banner event (file_version = "brain.Event:2").
"""

from __future__ import annotations

import io
import os
import socket
import struct
import time
from typing import Optional

import numpy as np

from yoloret_tpu_torch.data.tfrecord import TFRecordWriter, _len_delim, _tag, _varint


def _double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _event(wall_time: float, step: int, body: bytes = b"") -> bytes:
    return _double(1, wall_time) + _int64(2, step) + body


class SummaryWriter:
    """Append-only writer: ``add_scalar(tag, value, step)`` and
    ``add_image(tag, image, step)``."""

    def __init__(self, log_dir: str, filename_suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}{filename_suffix}")
        self.path = os.path.join(log_dir, fname)
        self._w = TFRecordWriter(self.path)
        self._w.write(_event(time.time(), 0, _len_delim(3, b"brain.Event:2")))

    def add_scalar(self, tag: str, value: float, step: int, wall_time: Optional[float] = None):
        val = _len_delim(1, tag.encode()) + _float(2, float(value))
        body = _len_delim(5, _len_delim(1, val))  # Event.summary.value
        self._w.write(_event(wall_time or time.time(), int(step), body))

    def add_image(self, tag: str, image, step: int, wall_time: Optional[float] = None):
        """An HWC uint8 (or [0, 1] float) image summary, PNG-encoded
        (``write_images`` parity, reference: code/train.py:71-73)."""
        from PIL import Image as PILImage

        arr = np.asarray(image)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        if arr.ndim == 2:
            arr = arr[..., None]
        h, w, c = arr.shape
        buf = io.BytesIO()
        PILImage.fromarray(arr.squeeze() if c == 1 else arr).save(buf, format="PNG")
        # colorspace: 1 gray, 3 RGB, 4 RGBA
        img = _int64(1, h) + _int64(2, w) + _int64(3, c) + _len_delim(4, buf.getvalue())
        val = _len_delim(1, tag.encode()) + _len_delim(4, img)  # Summary.Value.image
        body = _len_delim(5, _len_delim(1, val))
        self._w.write(_event(wall_time or time.time(), int(step), body))

    def flush(self):
        self._w._f.flush()

    def close(self):
        self._w.close()
