"""Detection postprocess: raw multi-scale heads -> per-class detections
in original-image pixels. Port of ``yoloret_tpu/ops/postprocess.py``
(``detect_batch`` with its two candidate pools, the zoom-in ensemble and
``use_pallas``; every pool runs the suppression kernel).

Shared pool (the serving path and the default):
1. ``shared_pool_candidates``: ONE exact top-M over all head positions,
   ranked by their best class score (max_c sigmoid(obj) * sigmoid(l_c) =
   sigmoid(obj) * sigmoid(max_c l_c), so no [B, N, C] score tensor is
   built before the gather), then box decode and letterbox inversion for
   the M candidates only.
2. ``shared_pool_suppress``: greedy per-class NMS over that shared pool,
   through the suppression kernel (``ops/nms_kernel.py``).

Per-class pools (the reference's candidate semantics; with K = the grid
size, ``--exact_nms``, the reference's NMS exactly):
1. ``per_class_candidates``: per class, the top-K positions by score,
   then their boxes.
2. ``per_class_suppress``: greedy NMS in each class's own pool, through
   the same kernel (its large-pool variant above 512 candidates).

The zoom-in ensemble (``zoom_outputs``: the heads of a second pass over
the centre crop of the network input) adds the crop's positions to the
per-class pools, their boxes mapped into the primary input's frame
(``gather_boxes_and_scores``); it takes the per-class pools, as the JAX
package forces it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from yoloret_tpu_torch.ops.decode import anchor_masks_for, correct_boxes, make_grid, pair
from yoloret_tpu_torch.ops.nms import NMSResult, fused_result, picked_result
from yoloret_tpu_torch.ops.nms_kernel import suppress


def _position_constants(outputs: Sequence[torch.Tensor], anchors: torch.Tensor):
    """Per flattened head position: (grid_xy [N, 2], grid_wh [N, 2],
    anchor_wh [N, 2]), in the order of the concatenated heads. ``anchors``
    [9, 2] must be on the heads' device: everything here is built by
    kernels, with no host-to-device copy that would stall the stream."""
    dev = outputs[0].device
    masks = anchor_masks_for(len(outputs))
    gxs, gws, aws = [], [], []
    for level, o in enumerate(outputs):
        gh, gw, a = o.shape[-4], o.shape[-3], o.shape[-2]
        grid = make_grid(gh, gw, dev).expand(gh, gw, a, 2).reshape(-1, 2)
        gxs.append(grid)
        gws.append(pair(gw, gh, dev).expand(grid.shape))
        lo = masks[level][0]  # each mask is a run of consecutive anchors
        anc = anchors[lo:lo + a].float().reshape(1, 1, a, 2).expand(gh, gw, a, 2)
        aws.append(anc.reshape(-1, 2))
    return torch.cat(gxs), torch.cat(gws), torch.cat(aws)


def _decode_at(raw_box: torch.Tensor, idx: torch.Tensor, outputs: Sequence[torch.Tensor],
               anchors: torch.Tensor, image_hw: torch.Tensor) -> torch.Tensor:
    """Boxes [B, M, 4] in image pixels of the positions ``idx`` [B, M] of
    the concatenated heads, from their raw box logits ``raw_box`` [B, M,
    4] (float32), image_hw [B, 2]."""
    input_hw = (outputs[0].shape[-4] * 32, outputs[0].shape[-3] * 32)
    grid_xy, grid_wh, anchor_wh = _position_constants(outputs, anchors)
    wh_in = pair(input_hw[1], input_hw[0], idx.device)
    xy = (torch.sigmoid(raw_box[..., :2]) + grid_xy[idx]) / grid_wh[idx]
    wh = torch.exp(raw_box[..., 2:4]) * anchor_wh[idx] / wh_in
    return correct_boxes(xy, wh, input_hw, image_hw[:, None, :])


def shared_pool_candidates(
    outputs: Sequence[torch.Tensor],
    anchors: torch.Tensor,
    num_classes: int,
    image_hw: torch.Tensor,
    *,
    num_candidates: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Heads [B, gh, gw, A, 5+C] per scale (coarsest first), image_hw
    [B, 2] -> (boxes [B, M, 4] in image pixels, cls_scores [B, C, M]).

    The concat keeps the head dtype; the cast to float32 comes after the
    M-row gather (exact: float32(bf16) is lossless and max commutes with
    the cast). Ranking sigmoids run in float32."""
    b = outputs[0].shape[0]
    dt = outputs[0].dtype
    for o in outputs[1:]:
        dt = torch.promote_types(dt, o.dtype)
    raw_flat = torch.cat([o.to(dt).reshape(b, -1, o.shape[-1]) for o in outputs], dim=1)
    n = raw_flat.shape[1]
    m = min(num_candidates, n)

    best_logit = raw_flat[..., 5:].amax(dim=-1).float()  # [B, N]
    obj_logit = raw_flat[..., 4].float()
    shared_score = torch.sigmoid(obj_logit) * torch.sigmoid(best_logit)
    idx = torch.topk(shared_score, m, dim=1).indices  # [B, M], exact

    cand_raw = torch.gather(raw_flat, 1, idx[..., None].expand(b, m, raw_flat.shape[-1]))
    cand_raw = cand_raw.float()  # [B, M, 5+C]
    cls_scores = (torch.sigmoid(cand_raw[..., 4:5]) * torch.sigmoid(cand_raw[..., 5:]))
    cls_scores = cls_scores.transpose(1, 2).contiguous()  # [B, C, M]
    boxes = _decode_at(cand_raw[..., :4], idx, outputs, anchors, image_hw)
    return boxes.contiguous(), cls_scores


def shared_pool_suppress(
    boxes: torch.Tensor,
    cls_scores: torch.Tensor,
    *,
    max_det_per_class: int = 20,
    score_threshold: float = 0.6,
    iou_threshold: float = 0.5,
) -> NMSResult:
    """Per-class greedy NMS over the shared candidates (boxes [B, M, 4],
    cls_scores [B, C, M])."""
    out_boxes, out_scores = suppress(
        boxes, cls_scores, max_det=max_det_per_class,
        iou_threshold=iou_threshold, score_threshold=score_threshold)
    return fused_result(out_boxes, out_scores)


def _interleave(main: Sequence[torch.Tensor], zoom: Sequence[torch.Tensor]):
    """[main 0, zoom 0, main 1, zoom 1, ...]."""
    return [t for both in zip(main, zoom) for t in both]


def gather_boxes_and_scores(
    outputs: Sequence[torch.Tensor],
    anchors: torch.Tensor,
    num_classes: int,
    image_hw: torch.Tensor,
    zoom_outputs: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every head position decoded: heads [B, gh, gw, A, 5+C] per scale
    (coarsest first), image_hw [B, 2] -> (boxes [B, N, 4] in image pixels,
    scores [B, N, C]). The batched ``gather_boxes_and_scores`` of the JAX
    package.

    With ``zoom_outputs`` (the heads of the centre crop), each scale's
    crop positions follow its own positions (scale 0, its crop, scale 1,
    ...), their centres and sizes mapped into the input's frame as
    ``zxy * ratio + (1 - ratio) / 2``, ``zwh * ratio`` (ratio = crop /
    input, per axis) before the letterbox inversion. The crop's size comes
    from its coarsest grid (x 32), not from each scale's."""
    b = outputs[0].shape[0]
    input_hw = (outputs[0].shape[-4] * 32, outputs[0].shape[-3] * 32)

    def decode(heads, hw):
        raw = [o.float().reshape(b, -1, o.shape[-1]) for o in heads]
        grid_xy, grid_wh, anchor_wh = _position_constants(heads, anchors)
        flat = torch.cat(raw, dim=1)
        xy = (torch.sigmoid(flat[..., :2]) + grid_xy) / grid_wh
        wh = torch.exp(flat[..., 2:4]) * anchor_wh / pair(hw[1], hw[0], flat.device)
        sizes = [r.shape[1] for r in raw]
        return xy.split(sizes, 1), wh.split(sizes, 1), raw

    xy, wh, raw = decode(outputs, input_hw)
    if zoom_outputs is not None:
        zoom_hw = (zoom_outputs[0].shape[-4] * 32, zoom_outputs[0].shape[-3] * 32)
        zxy, zwh, zraw = decode(zoom_outputs, zoom_hw)
        ratio = pair(zoom_hw[1] / input_hw[1], zoom_hw[0] / input_hw[0], image_hw.device)
        offset = (1.0 - ratio) / 2.0
        xy = _interleave(xy, [z * ratio + offset for z in zxy])
        wh = _interleave(wh, [z * ratio for z in zwh])
        raw = _interleave(raw, zraw)
    flat = torch.cat(raw, dim=1)
    scores = torch.sigmoid(flat[..., 4:5]) * torch.sigmoid(flat[..., 5:])  # [B, N, C]
    boxes = correct_boxes(torch.cat(xy, 1), torch.cat(wh, 1), input_hw, image_hw[:, None, :])
    return boxes, scores


def per_class_candidates(
    outputs: Sequence[torch.Tensor],
    anchors: torch.Tensor,
    num_classes: int,
    image_hw: torch.Tensor,
    *,
    num_candidates: int,
    zoom_outputs: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Heads [B, gh, gw, A, 5+C] per scale, image_hw [B, 2] -> (boxes [B,
    C, K, 4] in image pixels, cls_scores [B, C, K]): per class, the K
    highest-scoring positions (of the crop too, with ``zoom_outputs``),
    K = min(num_candidates, N).

    The selection is a stable descending sort, so tied scores keep the
    order of their positions, as ``lax.top_k`` keeps it (``torch.topk``
    promises no order). Boxes are decoded once per position and gathered:
    bit for bit the candidate-only decode of the JAX package, in N decodes
    instead of C * K."""
    boxes, scores = gather_boxes_and_scores(outputs, anchors, num_classes, image_hw,
                                            zoom_outputs)
    b, n, _ = boxes.shape
    k = min(num_candidates, n)
    cls_scores, cls_idx = torch.sort(scores.transpose(1, 2), dim=-1, descending=True,
                                     stable=True)
    cls_scores, cls_idx = cls_scores[..., :k].contiguous(), cls_idx[..., :k]
    cls_boxes = torch.gather(boxes[:, None].expand(b, num_classes, n, 4), 2,
                             cls_idx[..., None].expand(b, num_classes, k, 4))
    return cls_boxes.contiguous(), cls_scores


def per_class_suppress(
    cls_boxes: torch.Tensor,
    cls_scores: torch.Tensor,
    *,
    max_det_per_class: int = 20,
    score_threshold: float = 0.6,
    iou_threshold: float = 0.5,
) -> NMSResult:
    """Greedy NMS in each class's own pool (cls_boxes [B, C, K, 4],
    cls_scores [B, C, K]). The slate is ``class_aware_nms``'s: a slot is
    valid when it holds a pick."""
    out_boxes, out_scores = suppress(
        cls_boxes, cls_scores, max_det=max_det_per_class, iou_threshold=iou_threshold,
        score_threshold=score_threshold, empty_score=float("-inf"))
    return picked_result(out_boxes, out_scores)


def detect_batch(
    outputs: Sequence[torch.Tensor],
    anchors: torch.Tensor,
    num_classes: int,
    image_hw: torch.Tensor,
    *,
    max_det_per_class: int = 20,
    score_threshold: float = 0.6,
    iou_threshold: float = 0.5,
    num_candidates: int = 256,
    zoom_outputs: Optional[Sequence[torch.Tensor]] = None,
    use_pallas: Optional[bool] = None,
    pool: Optional[str] = None,
) -> NMSResult:
    """Batched postprocess (the JAX package's ``detect_batch`` with exact
    top-k): heads [B, gh, gw, A, 5+C] per scale, image_hw [B, 2] ->
    NMSResult with a leading batch dim. ``pool``: ``"shared"`` or
    ``"per_class"``; None is ``"per_class"`` with ``zoom_outputs`` or
    ``use_pallas``, else ``"shared"``, as in the JAX package, which
    refuses the shared pool with either. ``use_pallas=True`` without
    zoom is the JAX package's per-class kernel path: its slate holds the
    picks of score above 0 (``fused_result``); the zoom ensemble and the
    plain per-class pool give ``class_aware_nms``'s slate (every pick)."""
    per_class_only = bool(use_pallas) or zoom_outputs is not None
    if pool is None:
        pool = "per_class" if per_class_only else "shared"
    elif pool == "shared" and per_class_only:
        raise ValueError("pool='shared' is incompatible with use_pallas=True / zoom_outputs: "
                         "both consume the per-class candidate structure")
    kw = dict(max_det_per_class=max_det_per_class, score_threshold=score_threshold,
              iou_threshold=iou_threshold)
    if pool == "shared":
        boxes, cls_scores = shared_pool_candidates(
            outputs, anchors, num_classes, image_hw, num_candidates=num_candidates)
        return shared_pool_suppress(boxes, cls_scores, **kw)
    if pool == "per_class":
        boxes, cls_scores = per_class_candidates(
            outputs, anchors, num_classes, image_hw, num_candidates=num_candidates,
            zoom_outputs=zoom_outputs)
        if use_pallas and zoom_outputs is None:
            out_boxes, out_scores = suppress(
                boxes, cls_scores, max_det=max_det_per_class, iou_threshold=iou_threshold,
                score_threshold=score_threshold)
            return fused_result(out_boxes, out_scores)
        return per_class_suppress(boxes, cls_scores, **kw)
    raise ValueError(f"pool must be 'shared' or 'per_class', not {pool!r}")
