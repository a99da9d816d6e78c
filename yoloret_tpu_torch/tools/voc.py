"""VOC dataset preparation: Pascal-VOC XML -> text annotation lists and
TFRecord shards. A copy of the JAX package's ``yoloret_tpu/tools/voc.py``
on the port's ``data/annotations.py`` and ``data/tfrecord.py``.

Reimplements the reference's two converters:
  * XML -> text lines with a random 80/10/10 train/val/test split
    (reference: code/voc_text.py:13-83),
  * XML -> TFRecord shards (reference: code/voc_annotation.py:10-82) —
    using our dependency-free TFRecord writer (data/tfrecord.py) since
    TensorFlow is not a dependency of this framework.
"""

from __future__ import annotations

import glob as globlib
import os
import random
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

VOC_CLASSES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


def parse_voc_xml(
    xml_path: str, class_names: Sequence[str], keep_difficult: bool = False
) -> Tuple[str, np.ndarray]:
    """One VOC XML -> (image filename, [N, 5] (x1, y1, x2, y2, cls))."""
    root = ET.parse(xml_path).getroot()
    fname = root.findtext("filename") or ""
    boxes = []
    for obj in root.iter("object"):
        name = obj.findtext("name")
        difficult = (obj.findtext("difficult") or "0").strip() == "1"
        if difficult and not keep_difficult:
            continue
        if name not in class_names:
            continue
        cls = class_names.index(name)
        bb = obj.find("bndbox")
        boxes.append(
            [
                float(bb.findtext("xmin")),
                float(bb.findtext("ymin")),
                float(bb.findtext("xmax")),
                float(bb.findtext("ymax")),
                cls,
            ]
        )
    return fname, np.asarray(boxes, np.float32).reshape(-1, 5)


def voc_to_lists(
    annotations_dir: str,
    images_dir: str,
    out_prefix: str,
    class_names: Sequence[str] = VOC_CLASSES,
    split: Tuple[float, float, float] = (0.8, 0.1, 0.1),
    seed: int = 0,
) -> Dict[str, str]:
    """XML dir -> {train,val,test} text lists named with the ``_<N>``
    size convention. Returns {split: path}."""
    xmls = sorted(globlib.glob(os.path.join(annotations_dir, "*.xml")))
    if not xmls:
        raise FileNotFoundError(f"no XML files in {annotations_dir}")
    lines = []
    for x in xmls:
        fname, boxes = parse_voc_xml(x, class_names)
        if not len(boxes):
            continue
        img = os.path.join(images_dir, fname)
        toks = [img] + [
            f"{int(b[0])},{int(b[1])},{int(b[2])},{int(b[3])},{int(b[4])}"
            for b in boxes
        ]
        lines.append(" ".join(toks))
    rng = random.Random(seed)
    rng.shuffle(lines)
    n = len(lines)
    n_train = int(n * split[0])
    n_val = int(n * split[1])
    parts = {
        "train": lines[:n_train],
        "val": lines[n_train : n_train + n_val],
        "test": lines[n_train + n_val :],
    }
    out = {}
    for name, ls in parts.items():
        path = f"{out_prefix}_{name}_{len(ls)}.txt"
        with open(path, "w") as f:
            f.write("\n".join(ls) + ("\n" if ls else ""))
        out[name] = path
    return out


def voc_to_tfrecords(
    annotation_list: str,
    out_prefix: str,
    shard_size: int = 1000,
) -> List[str]:
    """Text list -> TFRecord shards of tf.train.Example protos with the
    reference's feature keys (code/voc_annotation.py:31-60 /
    map.py:35-47): image/encoded + normalized bbox coords + label."""
    from PIL import Image

    from yoloret_tpu_torch.data.annotations import load_annotation_lines, parse_annotation_line
    from yoloret_tpu_torch.data.tfrecord import Example, TFRecordWriter

    lines, _ = load_annotation_lines(annotation_list)
    paths: List[str] = []
    writer = None
    count_in_shard = 0
    total = 0
    for line in lines:
        img_path, boxes = parse_annotation_line(line)
        with open(img_path, "rb") as f:
            encoded = f.read()
        w, h = Image.open(img_path).size
        feats = {
            "image/encoded": encoded,
            "image/object/bbox/xmin": (boxes[:, 0] / w).tolist(),
            "image/object/bbox/ymin": (boxes[:, 1] / h).tolist(),
            "image/object/bbox/xmax": (boxes[:, 2] / w).tolist(),
            "image/object/bbox/ymax": (boxes[:, 3] / h).tolist(),
            "image/object/bbox/label": boxes[:, 4].astype(int).tolist(),
        }
        if writer is None or count_in_shard >= shard_size:
            if writer is not None:
                writer.close()
            shard_path = f"{out_prefix}_{len(paths):05d}.tfrecord"
            paths.append(shard_path)
            writer = TFRecordWriter(shard_path)
            count_in_shard = 0
        writer.write(Example(feats).serialize())
        count_in_shard += 1
        total += 1
    if writer is not None:
        writer.close()
    # rename shards to carry the size convention on the last one
    print(f"wrote {total} examples across {len(paths)} shards")
    return paths
