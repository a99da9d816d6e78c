"""The shared-pool postprocess in TensorFlow ops, for the SavedModel and
TFLite exports (``export/export.py::export_tf_flavor``).

The JAX package converts its ``ops/postprocess.py::detect_batch`` (exact
top-k) to TensorFlow with ``jax2tf``; the port writes the same program
in TF ops, and gives the slate of its own ``InferenceProgram``
(``export/export.py``):

1. ``shared_pool_candidates``: one exact top-M over the head positions
   ranked by sigmoid(objectness) * sigmoid(best class logit)
   (``tf.math.top_k``, sorted: the lower index first among equal scores),
   then the decode and the letterbox inversion of the M candidates, the
   boxes clipped to the image, as ``ops/postprocess.py::
   shared_pool_candidates`` and ``ops/decode.py::correct_boxes``. Each
   candidate's grid cell, grid size and anchor come from its index by
   integer arithmetic: no position table is held as a constant (a
   dynamic-range quantizer may store large constants in int8).
2. ``suppress``: greedy NMS per class over the shared pool, unrolled
   ``max_det`` times, as ``ops/nms_kernel.py::suppress_plain``: the
   highest active score, ties to the lowest index (the least index among
   the positions equal to the maximum: neither ``tf.argmax`` nor TFLite's
   ``ARG_MAX`` states an order for ties), emitted, then the pick and
   every candidate of IoU strictly above the threshold deactivated;
   candidates below the score threshold start inactive.
3. ``slate``: ``ops/nms.py::fused_result``'s (boxes [B, C * D, 4]
   (ymin, xmin, ymax, xmax), scores, classes int32, valid = score > 0).

TensorFlow is imported inside each function.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from yoloret_tpu_torch.ops.decode import anchor_masks_for


def _candidate_geometry(idx, heads: Sequence, anchors: np.ndarray):
    """For flat head positions ``idx`` [B, M] (int32): (grid_xy, grid_wh,
    anchor_wh), each [B, M, 2] float32, as ``ops/postprocess.py::
    _position_constants`` gives them for those positions."""
    import tensorflow as tf

    masks = anchor_masks_for(len(heads))
    a = int(heads[0].shape[-2])
    gh = [int(h.shape[-4]) for h in heads]
    gw = [int(h.shape[-3]) for h in heads]
    starts = np.cumsum([0] + [h * w * a for h, w in zip(gh, gw)])[:-1]
    level = tf.zeros_like(idx)
    for start in starts[1:]:
        level += tf.cast(idx >= int(start), tf.int32)

    def per_level(values):
        return tf.gather(tf.constant(np.asarray(values, np.int32)), level)

    local = idx - per_level(starts)
    cell = local // a
    level_w = per_level(gw)
    gx, gy = cell % level_w, cell // level_w
    grid_xy = tf.cast(tf.stack([gx, gy], axis=-1), tf.float32)
    grid_wh = tf.cast(tf.stack([level_w, per_level(gh)], axis=-1), tf.float32)
    anchor = per_level([m[0] for m in masks]) + local % a  # each mask is a run of anchors
    anchor_wh = tf.gather(tf.constant(np.asarray(anchors, np.float32)), anchor)
    return grid_xy, grid_wh, anchor_wh


def correct_boxes(box_xy, box_wh, input_hw: Tuple[int, int], image_hw):
    """``ops/decode.py::correct_boxes`` in TF ops: normalised (x, y) /
    (w, h) in the network frame [..., 2], image_hw [..., 2] -> [..., 4]
    (ymin, xmin, ymax, xmax) in image pixels, clipped to the image."""
    import tensorflow as tf

    def flip(v):
        return tf.concat([v[..., 1:2], v[..., 0:1]], axis=-1)

    box_yx, box_hw = flip(box_xy), flip(box_wh)
    input_shape = tf.constant(np.asarray(input_hw, np.float32))
    max_side = tf.maximum(image_hw[..., 0], image_hw[..., 1])[..., None]
    ratio = image_hw / max_side
    boxed_shape = input_shape * ratio
    offset = (input_shape - boxed_shape) / 2.0
    scale = image_hw / boxed_shape
    box_yx = (box_yx * input_shape - offset) * scale
    box_hw = box_hw * input_shape * scale
    box_mins = box_yx - box_hw / 2.0
    box_maxes = box_yx + box_hw / 2.0
    h, w = image_hw[..., 0:1], image_hw[..., 1:2]

    def clip(v, hi):
        return tf.minimum(tf.maximum(v, 0.0), hi)

    return tf.concat([clip(box_mins[..., 0:1], h), clip(box_mins[..., 1:2], w),
                      clip(box_maxes[..., 0:1], h), clip(box_maxes[..., 1:2], w)], axis=-1)


def shared_pool_candidates(heads: Sequence, anchors: np.ndarray, image_hw, *,
                           num_candidates: int):
    """Heads [B, gh, gw, A, 5+C] float32 per scale (coarsest first),
    anchors [9, 2], image_hw [B, 2] -> (boxes [B, M, 4] in image pixels,
    cls_scores [B, C, M]), M = min(num_candidates, positions)."""
    import tensorflow as tf

    b = int(heads[0].shape[0])
    raw_flat = tf.concat([tf.reshape(h, [b, -1, int(h.shape[-1])]) for h in heads], axis=1)
    m = min(num_candidates, int(raw_flat.shape[1]))
    shared_score = tf.sigmoid(raw_flat[..., 4]) * tf.sigmoid(
        tf.reduce_max(raw_flat[..., 5:], axis=-1))
    idx = tf.math.top_k(shared_score, m, sorted=True).indices  # [B, M]
    cand = tf.gather(raw_flat, idx, batch_dims=1)  # [B, M, 5+C]
    cls_scores = tf.transpose(tf.sigmoid(cand[..., 4:5]) * tf.sigmoid(cand[..., 5:]), [0, 2, 1])
    grid_xy, grid_wh, anchor_wh = _candidate_geometry(idx, heads, anchors)
    input_hw = (int(heads[0].shape[-4]) * 32, int(heads[0].shape[-3]) * 32)
    wh_in = tf.constant(np.asarray([input_hw[1], input_hw[0]], np.float32))
    xy = (tf.sigmoid(cand[..., :2]) + grid_xy) / grid_wh
    wh = tf.exp(cand[..., 2:4]) * anchor_wh / wh_in
    return correct_boxes(xy, wh, input_hw, image_hw[:, None, :]), cls_scores


def box_iou(b1, b2):
    """``ops/boxes.py::iou`` in TF ops: broadcasted IoU of (ymin, xmin,
    ymax, xmax) boxes, 0 where the union is 0."""
    import tensorflow as tf

    def pos(v):
        return tf.maximum(v, 0.0)

    y1a, x1a, y2a, x2a = tf.unstack(b1, axis=-1)
    y1b, x1b, y2b, x2b = tf.unstack(b2, axis=-1)
    area_a = pos(x2a - x1a) * pos(y2a - y1a)
    area_b = pos(x2b - x1b) * pos(y2b - y1b)
    inter = (pos(tf.minimum(x2a, x2b) - tf.maximum(x1a, x1b))
             * pos(tf.minimum(y2a, y2b) - tf.maximum(y1a, y1b)))
    union = area_a + area_b - inter
    nz = tf.not_equal(union, 0.0)
    return tf.where(nz, inter / tf.where(nz, union, tf.ones_like(union)), tf.zeros_like(inter))


def suppress(boxes, scores, *, max_det: int, iou_threshold: float, score_threshold: float):
    """Greedy per-class NMS over a shared pool: boxes [B, M, 4], scores
    [B, C, M] -> (boxes [B, C, max_det, 4], scores [B, C, max_det]);
    empty slots get a zero box and score 0."""
    import tensorflow as tf

    m = int(scores.shape[-1])
    neg_inf = tf.constant(-np.inf, tf.float32)
    lane = tf.range(m, dtype=tf.int32)
    active = tf.where(scores >= score_threshold, scores, neg_inf)
    out_b, out_s = [], []
    for _ in range(max_det):
        top = tf.reduce_max(active, axis=-1, keepdims=True)
        best = tf.reduce_min(tf.where(tf.equal(active, top), lane, m), axis=-1)  # [B, C]
        best_score = tf.gather(active, best, batch_dims=2)  # the pick's own bits (-0 stays -0)
        best_box = tf.gather(boxes, best, batch_dims=1)  # [B, C, 4]
        picked = best_score > neg_inf
        out_b.append(tf.where(picked[..., None], best_box, 0.0))
        out_s.append(tf.where(picked, best_score, 0.0))
        kill = (box_iou(best_box[:, :, None, :], boxes[:, None, :, :]) > iou_threshold) | (
            tf.equal(lane, best[..., None]))
        active = tf.where(picked[..., None] & kill, neg_inf, active)
    return tf.stack(out_b, axis=2), tf.stack(out_s, axis=2)


def slate(out_boxes, out_scores):
    """[B, C, D] suppression outputs -> (boxes [B, C * D, 4], scores,
    classes int32, valid = score > 0), ``ops/nms.py::fused_result``'s."""
    import tensorflow as tf

    b, c, d = (int(v) for v in out_scores.shape)
    scores = tf.reshape(out_scores, [b, c * d])
    classes = tf.constant(np.broadcast_to(np.repeat(np.arange(c, dtype=np.int32), d), (b, c * d)))
    return tf.reshape(out_boxes, [b, c * d, 4]), scores, classes, scores > 0.0


def detect(heads: Sequence, anchors: np.ndarray, image_hw, *, score_threshold: float,
           iou_threshold: float, num_candidates: int = 256, max_det: int = 20):
    """Raw heads and image_hw [B, 2] -> the slate (boxes, scores, classes,
    valid) of the shared pool, as the port's ``InferenceProgram``."""
    boxes, cls_scores = shared_pool_candidates(heads, anchors, image_hw,
                                               num_candidates=num_candidates)
    return slate(*suppress(boxes, cls_scores, max_det=max_det, iou_threshold=iou_threshold,
                           score_threshold=score_threshold))
