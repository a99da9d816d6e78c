"""Annotation-list / class / anchor file IO. A copy of the JAX package's
``yoloret_tpu/data/annotations.py`` (host-only; the port imports nothing
of that package).

Formats match the reference exactly so its shipped data lists work as-is:
  * text-line annotations: ``<image path> x1,y1,x2,y2,cls x1,y1,...``
    (reference: code/yolo3/data.py:71-121 parses these; lists shipped in
    code/data_paths/*.txt),
  * dataset size encoded in the filename as ``<name>_<N>.<ext>``
    (reference: code/yolo3/data.py:169-183),
  * anchors: one CSV line of 9 (w, h) pairs
    (reference: code/yolo3/utils.py:100-104, model_data/yolo_anchors.txt),
  * classes: one name per line (reference: code/yolo3/utils.py:115-120).
"""

from __future__ import annotations

import glob as globlib
import os
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

_SIZE_RE = re.compile(r"_(\d+)\.[^.]+$")


def load_classes(path: str) -> List[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def load_anchors(path: str) -> np.ndarray:
    """[9, 2] float32 (w, h) anchor table."""
    with open(path) as f:
        vals = [float(x) for x in f.readline().split(",")]
    return np.asarray(vals, np.float32).reshape(-1, 2)


def parse_annotation_line(line: str) -> Tuple[str, np.ndarray]:
    """One text line -> (image path, [N, 5] float32 (x1, y1, x2, y2, cls)).

    Two formats are accepted:
      * the reference's shipped lists — flat space-separated quintuples
        ``path x1 y1 x2 y2 cls x1 y1 ...`` (parsed by the reference as
        ``tf.reshape(values[1:], [-1, 5])``, code/yolo3/data.py:75-76 /
        map.py:57-59; see code/data_paths/voc_train_14910.txt),
      * the classic keras-yolo3 comma format ``path x1,y1,x2,y2,cls ...``.
    """
    parts = [p for p in line.strip().split(" ") if p]
    if not parts:
        return "", np.zeros((0, 5), np.float32)
    path, rest = parts[0], parts[1:]
    boxes = []
    if any("," in tok for tok in rest):
        for tok in rest:
            vals = tok.split(",")
            boxes.append([float(v) for v in vals[:5]])
    elif rest:
        if len(rest) % 5:
            raise ValueError(f"malformed annotation line (boxes not x1 y1 x2 y2 cls): {line[:80]!r}")
        flat = [float(v) for v in rest]
        boxes = [flat[i : i + 5] for i in range(0, len(flat), 5)]
    arr = np.asarray(boxes, np.float32).reshape(-1, 5)
    return path, arr


def dataset_size_from_name(path: str) -> Optional[int]:
    """Parse the ``_<N>`` suffix convention the reference uses to avoid a
    full pass over the data (reference: code/yolo3/data.py:169-183)."""
    m = _SIZE_RE.search(os.path.basename(path))
    return int(m.group(1)) if m else None


def load_annotation_lines(pattern: str) -> Tuple[List[str], int]:
    """Expand a glob of text-annotation lists; returns (lines, count).
    Count prefers the filename convention, falling back to line count."""
    files = sorted(globlib.glob(pattern)) if any(c in pattern for c in "*?[") else [pattern]
    if not files:
        raise FileNotFoundError(f"no annotation files match {pattern!r}")
    lines: List[str] = []
    declared = 0
    have_declared = True
    for f in files:
        with open(f) as fh:
            file_lines = [l for l in fh.readlines() if l.strip()]
        lines.extend(file_lines)
        n = dataset_size_from_name(f)
        if n is None:
            have_declared = False
        else:
            declared += n
    return lines, (declared if have_declared else len(lines))


def rewrite_image_paths(lines: Sequence[str], old_root: str, new_root: str) -> List[str]:
    """Equivalent of the reference's update_voc_path.py / update_coco_path.py
    (reference: code/update_voc_path.py:1-17)."""
    out = []
    for line in lines:
        path, rest = (line.split(" ", 1) + [""])[:2]
        if path.startswith(old_root):
            path = new_root + path[len(old_root):]
        out.append((path + " " + rest).strip())
    return out
