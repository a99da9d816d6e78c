"""Greedy class-aware suppression: the CUDA kernel's wrapper and its
plain PyTorch version.

Kernel: ``csrc/nms.cu``, built for sm_90a on first use. It replaces the
TPU kernel ``yoloret_tpu/ops/nms_pallas.py::_nms_kernel`` and, on the
serving path, the XLA loop ``_suppress_lax_shared`` of
``yoloret_tpu/ops/postprocess.py``.

What bounds it on the card: the loop's operations (rounds x candidates
x one IoU), with its inputs read once. One warp per (image, class) holds
its candidates in registers for every round; each round is a shuffle
argmax, a shuffle broadcast of the pick's box and one IoU per candidate,
with no memory traffic (see the note at the top of the CUDA source).

Per (image, class), ``max_det`` rounds: take the highest active score
(ties to the lowest index), emit it with its box, deactivate the pick and
every candidate with IoU > ``iou_threshold``. Scores below
``score_threshold`` start inactive; empty slots are zeros.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from yoloret_tpu_torch.ops import _build
from yoloret_tpu_torch.ops.boxes import iou as box_iou

_vp, _ci = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {
    "yrt_nms": ([_vp] * 4 + [_ci] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_float] * 2 + [_vp],
                _ci),
    "yrt_nms_max_candidates": ([], _ci),
    "yrt_error_string": ([_ci], ctypes.c_char_p),
}


def _lib() -> ctypes.CDLL:
    return _build.load("nms", _PROTOTYPES)


def suppress_plain(boxes: torch.Tensor, scores: torch.Tensor, *, max_det: int,
                   iou_threshold: float, score_threshold: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the batched loop of the JAX package's
    ``_suppress_lax`` (per-class boxes [B, C, K, 4]) and
    ``_suppress_lax_shared`` (shared boxes [B, K, 4]). Scores [B, C, K].
    Returns (boxes [B, C, D, 4], scores [B, C, D])."""
    b, c, k = scores.shape
    if boxes.dim() == 3:
        boxes = boxes[:, None].expand(b, c, k, 4)
    neg_inf = float("-inf")
    active = torch.where(scores >= score_threshold, scores, neg_inf)
    lane = torch.arange(k, device=scores.device)
    out_b = torch.zeros((b, c, max_det, 4), dtype=torch.float32, device=scores.device)
    out_s = torch.zeros((b, c, max_det), dtype=torch.float32, device=scores.device)
    for i in range(max_det):
        best = torch.argmax(active, dim=-1)  # first maximum: ties to the lowest index
        best_score = torch.gather(active, -1, best[..., None])[..., 0]
        best_box = torch.gather(boxes, 2, best[..., None, None].expand(b, c, 1, 4))[:, :, 0]
        picked = best_score > neg_inf
        out_b[:, :, i] = torch.where(picked[..., None], best_box, 0.0)
        out_s[:, :, i] = torch.where(picked, best_score, 0.0)
        kill = (box_iou(best_box[:, :, None, :], boxes) > iou_threshold) | (
            lane == best[..., None])
        active = torch.where(picked[..., None] & kill, neg_inf, active)
    return out_b, out_s


def suppress(boxes: torch.Tensor, scores: torch.Tensor, *, max_det: int = 20,
             iou_threshold: float = 0.5, score_threshold: float = 0.6
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy per-class NMS over a shared pool (boxes [B, K, 4]) or
    per-class pools (boxes [B, C, K, 4]); scores [B, C, K] float32.
    Returns (boxes [B, C, D, 4], scores [B, C, D]), zeros in empty slots.

    A CPU tensor takes the plain version. A CUDA tensor launches the
    kernel (and adds one to ``suppress.launches``), or raises."""
    b, c, k = scores.shape
    shared = boxes.dim() == 3
    want = (b, k, 4) if shared else (b, c, k, 4)
    if tuple(boxes.shape) != want:
        raise ValueError(f"boxes {tuple(boxes.shape)} do not fit scores {tuple(scores.shape)}")
    if scores.device.type == "cpu":
        return suppress_plain(boxes, scores, max_det=max_det, iou_threshold=iou_threshold,
                              score_threshold=score_threshold)
    if scores.device.type != "cuda":
        raise ValueError(f"suppress runs on CPU or CUDA tensors, not {scores.device}")
    for t in (boxes, scores):
        if t.device != scores.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("suppress needs contiguous float32 tensors on one device")
    lib = _lib()
    if k > lib.yrt_nms_max_candidates():
        raise ValueError(f"{k} candidates exceed the kernel's {lib.yrt_nms_max_candidates()}")
    out_b = torch.empty((b, c, max_det, 4), dtype=torch.float32, device=scores.device)
    out_s = torch.empty((b, c, max_det), dtype=torch.float32, device=scores.device)
    if out_s.numel() == 0:
        return out_b, out_s
    stream = torch.cuda.current_stream(scores.device).cuda_stream
    rc = lib.yrt_nms(scores.data_ptr(), boxes.data_ptr(), out_b.data_ptr(), out_s.data_ptr(),
                     b, c, k, max_det, k * 4 if shared else c * k * 4, 0 if shared else k * 4,
                     iou_threshold, score_threshold, stream)
    if rc != 0:
        raise RuntimeError(f"nms kernel launch failed: {lib.yrt_error_string(rc).decode()}")
    suppress.launches += 1
    return out_b, out_s


suppress.launches = 0
