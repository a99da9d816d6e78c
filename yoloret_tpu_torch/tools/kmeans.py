"""Anchor generation: k-means over ground-truth (w, h) with 1 - IoU
distance and median centroid update. A copy of the JAX package's
``yoloret_tpu/tools/kmeans.py`` on the port's own annotation parser
(``data/annotations.py``): the same seeded draws, so the same boxes give
the same anchors file.

Working implementation of the reference's intent (reference:
code/kmeans.py:14-136 -- broken as shipped: ``yolo3.enum`` import,
kmeans.py:6). Distance metric and median update match kmeans.py:71-92;
the avg-IoU "accuracy" report matches kmeans.py:94-103; output format
matches model_data/yolo_anchors.txt (one CSV line, area-sorted).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from yoloret_tpu_torch.data.annotations import load_annotation_lines, parse_annotation_line


def boxes_wh_from_lists(glob_pattern: str) -> np.ndarray:
    """All GT (w, h) pairs from text annotation lists."""
    lines, _ = load_annotation_lines(glob_pattern)
    whs = []
    for line in lines:
        _, boxes = parse_annotation_line(line)
        if len(boxes):
            wh = boxes[:, 2:4] - boxes[:, 0:2]
            whs.append(wh[(wh[:, 0] > 0) & (wh[:, 1] > 0)])
    if not whs:
        raise ValueError(f"no boxes found in {glob_pattern!r}")
    return np.concatenate(whs, axis=0)


def _iou_wh(boxes: np.ndarray, clusters: np.ndarray) -> np.ndarray:
    """IoU of origin-aligned rects: [N, K]."""
    inter = np.minimum(boxes[:, None, 0], clusters[None, :, 0]) * np.minimum(
        boxes[:, None, 1], clusters[None, :, 1]
    )
    area_b = (boxes[:, 0] * boxes[:, 1])[:, None]
    area_c = (clusters[:, 0] * clusters[:, 1])[None, :]
    return inter / (area_b + area_c - inter)


def kmeans_anchors(
    wh: np.ndarray, k: int = 9, seed: int = 0, max_iter: int = 1000
) -> Tuple[np.ndarray, float]:
    """Returns (anchors [k, 2] sorted by area, avg IoU)."""
    rng = np.random.RandomState(seed)
    n = len(wh)
    clusters = wh[rng.choice(n, k, replace=False)].astype(np.float64)
    last = np.zeros(n, np.int64) - 1
    for _ in range(max_iter):
        dist = 1.0 - _iou_wh(wh, clusters)
        assign = dist.argmin(axis=1)
        if np.all(assign == last):
            break
        for j in range(k):
            sel = wh[assign == j]
            if len(sel):
                clusters[j] = np.median(sel, axis=0)  # reference kmeans.py:88-90
        last = assign
    avg_iou = float(_iou_wh(wh, clusters)[np.arange(n), assign].mean())
    order = np.argsort(clusters[:, 0] * clusters[:, 1])
    return clusters[order], avg_iou


def write_anchors(path: str, anchors: np.ndarray) -> None:
    """One CSV line: 'w1,h1, w2,h2, ...' (reference kmeans.py:24-37)."""
    parts = [f"{int(round(w))},{int(round(h))}" for w, h in anchors]
    with open(path, "w") as f:
        f.write(", ".join(parts) + "\n")


def plot_clusters(wh: np.ndarray, anchors: np.ndarray, out_png: str) -> None:
    """Scatter of GT (w, h) with cluster centers, as the reference's
    matplotlib figure (kmeans.py:120-129)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    sub = wh[np.random.RandomState(0).choice(len(wh), min(len(wh), 5000), replace=False)]
    ax.scatter(sub[:, 0], sub[:, 1], s=2, alpha=0.3, label="boxes")
    ax.scatter(anchors[:, 0], anchors[:, 1], s=80, c="red", marker="x", label="anchors")
    ax.set_xlabel("width (px)")
    ax.set_ylabel("height (px)")
    ax.legend()
    fig.savefig(out_png, dpi=100, bbox_inches="tight")
    plt.close(fig)


def kmeans_anchors_cli(
    glob_pattern: str, out_path: str, k: int = 9, seed: int = 0,
    plot_path: str | None = None,
):
    wh = boxes_wh_from_lists(glob_pattern)
    anchors, acc = kmeans_anchors(wh, k=k, seed=seed)
    write_anchors(out_path, anchors)
    print(f"{len(wh)} boxes, K={k}, accuracy (avg IoU): {acc * 100:.2f}%")
    print(f"anchors -> {out_path}")
    if plot_path:
        plot_clusters(wh, anchors, plot_path)
        print(f"cluster plot -> {plot_path}")
    return anchors, acc
