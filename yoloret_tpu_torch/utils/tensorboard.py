"""Minimal TensorBoard event-file writer (scalars), with no TensorFlow.
A copy of the scalar part of ``yoloret_tpu/utils/tensorboard.py``, on the
port's own protobuf wire helpers and TFRecord framing
(``data/tfrecord.py``).

Wire format: each record is an ``Event`` proto --
  Event { double wall_time = 1; int64 step = 2; Summary summary = 5; }
  Summary { repeated Value value = 1; }
  Summary.Value { string tag = 1; float simple_value = 2; }
The first record is a version banner event (file_version = "brain.Event:2").
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

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
    """Append-only scalar writer: ``add_scalar(tag, value, step)``."""

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

    def flush(self):
        self._w._f.flush()

    def close(self):
        self._w.close()
