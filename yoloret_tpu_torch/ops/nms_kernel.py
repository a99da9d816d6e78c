"""Greedy class-aware suppression: the CUDA kernels' wrapper, their launch
plan and their plain PyTorch version.

Kernels: ``csrc/nms.cu``, built for sm_90a on first use. They replace the
TPU kernel ``yoloret_tpu/ops/nms_pallas.py::_nms_kernel`` and, on the
serving path, the XLA loop ``_suppress_lax_shared`` of
``yoloret_tpu/ops/postprocess.py``. ``plan_nms`` picks the variant from
the class stride of the boxes:

- ``shared`` (boxes [B, M, 4], the serving path): one CTA per image. All
  warps build the image's M x M suppression mask (IoU > threshold) once
  in shared memory, then one warp per class runs the greedy rounds on it:
  an argmax by warp reductions and one mask-row load per round, no IoU.
- ``per_class`` (boxes [B, C, K, 4], the TPU kernel's own contract): one
  warp per (image, class), candidates in registers, one IoU per
  candidate per round.
- ``per_class_large`` (pools above 512 candidates, per-class or shared;
  the exact-NMS evaluation's whole-grid pools, sorted by score): two
  kernels. The walk, one CTA per (image, class), reads the class's scores
  once and tests whether they are in order; on a sorted pool one warp
  walks the candidates in index order (the next pick is the first active
  candidate no earlier pick kills) and stops at the last pick, so only
  the boxes up to it are read. The rounds, persistent CTAs, take the
  pools the walk flags as unsorted: keys and boxes staged in shared
  memory (where they fit), a block-wide argmax with one barrier and one
  IoU per active candidate a round.

Per (image, class), ``max_det`` rounds: take the highest active score
(ties to the lowest index), emit it with its box, deactivate the pick and
every candidate with IoU > ``iou_threshold``. Scores below
``score_threshold`` start inactive; empty slots get a zero box and
``empty_score``.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple, Tuple

import torch

from yoloret_tpu_torch.ops import _build
from yoloret_tpu_torch.ops.boxes import iou as box_iou

MAX_CANDIDATES = 512  # of the register kernels: 16 per lane
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
MAX_WARPS = 32
# csrc/nms.cu's large-pool kernels: the walk's warps, and the rounds' warps
# with their boxes staged in shared memory or read from device memory
WALK_WARPS = 4
ROUNDS_WARPS, ROUNDS_WARPS_GLOBAL = 32, 16
VARIANTS = ("per_class", "shared", "per_class_large")  # csrc/nms.cu's numbering

_vp, _ci = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {
    "yrt_nms": ([_vp] * 4 + [_ci] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_float] * 3
                + [_ci] * 4 + [_vp, _vp], _ci),
    "yrt_error_string": ([_ci], ctypes.c_char_p),
}


def _lib() -> ctypes.CDLL:
    return _build.load("nms", _PROTOTYPES)


class NMSPlan(NamedTuple):
    variant: str  # one of VARIANTS
    npl: int  # candidates per lane (1, 2, 4, 8 or 16; per thread of the rounds, large)
    warps: int  # warps per CTA (of the rounds in per_class_large; the walk: WALK_WARPS)
    classes_per_pass: int  # classes whose scores sit in shared memory at once
    smem: int  # bytes of dynamic shared memory


def shared_smem_bytes(npl: int, k: int, classes_per_pass: int, warps: int, max_det: int) -> int:
    """Dynamic shared memory of the shared-pool kernel: boxes [32 npl] as
    float4, the mask [32 npl][npl] words, areas, the scores of one pass
    [cs, K] (16-byte rounded) and a buffer of picked indices per class
    warp. ``csrc/nms.cu::shared_smem_bytes`` computes the same."""
    mp = 32 * npl
    return (16 * mp + 4 * mp * npl + 4 * mp + 16 * -(-classes_per_pass * k // 4)
            + 4 * min(warps, classes_per_pass) * max_det)


def large_staged_bytes(k: int) -> int:
    """Dynamic shared memory of the large-pool rounds with the boxes
    staged: boxes [K] (float4), keys [K] (16-byte rounded), two buffers of
    the ROUNDS_WARPS warp winners' keys and indices."""
    return 16 * k + 16 * -(-k // 4) + 16 * ROUNDS_WARPS


def large_smem_bytes(k: int) -> int:
    """Dynamic shared memory of the large-pool rounds: staged where that
    fits in SMEM_LIMIT, else the keys and the winners of
    ROUNDS_WARPS_GLOBAL warps (boxes read from device memory).
    ``csrc/nms.cu::large_smem_bytes`` computes the same."""
    staged = large_staged_bytes(k)
    return staged if staged <= SMEM_LIMIT else 16 * -(-k // 4) + 16 * ROUNDS_WARPS_GLOBAL


def walk_smem_bytes(max_det: int) -> int:
    """Dynamic shared memory of the large-pool walk: the picks' boxes and
    scores. ``csrc/nms.cu::walk_smem_bytes`` computes the same."""
    return 20 * max_det


def plan_nms(c: int, k: int, max_det: int, shared: bool) -> NMSPlan:
    """Launch plan for ``c`` classes of ``k`` candidates. Pools above
    ``MAX_CANDIDATES``, shared or not, take the large-pool kernels: the
    walk (WALK_WARPS warps per (image, class), ``walk_smem_bytes``), then
    the rounds (ROUNDS_WARPS warps with the boxes staged, else
    ROUNDS_WARPS_GLOBAL; ``large_smem_bytes``). A shared
    pool takes one CTA per image with enough warps for the mask's 32 x 32
    tiles and one warp per class (8 to 32); its scores sit in shared
    memory in as few passes as fit. Per-class pools (and a shared pool
    whose pick buffers alone overflow shared memory, max_det in the tens
    of thousands) take the warp-per-(image, class) kernel."""
    if k < 1:
        raise ValueError(f"{k} candidates: the kernels take at least 1")
    if k > MAX_CANDIDATES:
        smem = large_smem_bytes(k)
        if smem > SMEM_LIMIT:
            raise ValueError(f"{k} candidates: their keys do not fit in shared memory "
                             f"({smem} > {SMEM_LIMIT} bytes)")
        if walk_smem_bytes(max_det) > SMEM_LIMIT:
            raise ValueError(f"max_det {max_det}: the picks do not fit in shared memory "
                             f"({walk_smem_bytes(max_det)} > {SMEM_LIMIT} bytes)")
        warps = ROUNDS_WARPS if smem == large_staged_bytes(k) else ROUNDS_WARPS_GLOBAL
        return NMSPlan("per_class_large", -(-k // (32 * warps)), warps, c, smem)
    npl = next(n for n in (1, 2, 4, 8, 16) if 32 * n >= k)
    per_class = NMSPlan("per_class", npl, 4, c, 0)
    if not shared or c < 1:
        return per_class
    tiles = -(-k // 32)
    warps = min(MAX_WARPS, max(8, c, tiles * (tiles + 1) // 2))
    for cs in range(c, 0, -1):
        smem = shared_smem_bytes(npl, k, cs, warps, max_det)
        if smem <= SMEM_LIMIT:
            return NMSPlan("shared", npl, warps, cs, smem)
    return per_class


def suppress_plain(boxes: torch.Tensor, scores: torch.Tensor, *, max_det: int,
                   iou_threshold: float, score_threshold: float, empty_score: float = 0.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the batched loop of the JAX package's
    ``_suppress_lax`` (per-class boxes [B, C, K, 4]) and
    ``_suppress_lax_shared`` (shared boxes [B, K, 4]); with ``empty_score``
    -inf, the loop of ``class_aware_nms``. Scores [B, C, K]. Returns
    (boxes [B, C, D, 4], scores [B, C, D])."""
    b, c, k = scores.shape
    if boxes.dim() == 3:
        boxes = boxes[:, None].expand(b, c, k, 4)
    neg_inf = float("-inf")
    active = torch.where(scores >= score_threshold, scores, neg_inf)
    lane = torch.arange(k, device=scores.device)
    out_b = torch.zeros((b, c, max_det, 4), dtype=torch.float32, device=scores.device)
    out_s = torch.full((b, c, max_det), empty_score, dtype=torch.float32, device=scores.device)
    for i in range(max_det):
        best = torch.argmax(active, dim=-1)  # first maximum: ties to the lowest index
        best_score = torch.gather(active, -1, best[..., None])[..., 0]
        best_box = torch.gather(boxes, 2, best[..., None, None].expand(b, c, 1, 4))[:, :, 0]
        picked = best_score > neg_inf
        out_b[:, :, i] = torch.where(picked[..., None], best_box, 0.0)
        out_s[:, :, i] = torch.where(picked, best_score, empty_score)
        kill = (box_iou(best_box[:, :, None, :], boxes) > iou_threshold) | (
            lane == best[..., None])
        active = torch.where(picked[..., None] & kill, neg_inf, active)
    return out_b, out_s


def suppress(boxes: torch.Tensor, scores: torch.Tensor, *, max_det: int = 20,
             iou_threshold: float = 0.5, score_threshold: float = 0.6,
             empty_score: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy per-class NMS over a shared pool (boxes [B, K, 4]) or
    per-class pools (boxes [B, C, K, 4]); scores [B, C, K] float32.
    Returns (boxes [B, C, D, 4], scores [B, C, D]); empty slots get a zero
    box and ``empty_score``.

    A CPU tensor takes the plain version. A CUDA tensor launches the
    kernel that ``plan_nms`` picks (and adds one to ``suppress.launches``
    and to ``suppress.variant_launches[variant]``), or raises."""
    b, c, k = scores.shape
    shared = boxes.dim() == 3
    want = (b, k, 4) if shared else (b, c, k, 4)
    if tuple(boxes.shape) != want:
        raise ValueError(f"boxes {tuple(boxes.shape)} do not fit scores {tuple(scores.shape)}")
    if scores.device.type == "cpu":
        return suppress_plain(boxes, scores, max_det=max_det, iou_threshold=iou_threshold,
                              score_threshold=score_threshold, empty_score=empty_score)
    if scores.device.type != "cuda":
        raise ValueError(f"suppress runs on CPU or CUDA tensors, not {scores.device}")
    for t in (boxes, scores):
        if t.device != scores.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("suppress needs contiguous float32 tensors on one device")
    plan = plan_nms(c, k, max_det, shared)
    lib = _lib()
    out_b = torch.empty((b, c, max_det, 4), dtype=torch.float32, device=scores.device)
    out_s = torch.empty((b, c, max_det), dtype=torch.float32, device=scores.device)
    if out_s.numel() == 0:
        return out_b, out_s
    # the large-pool walk's flags of unsorted pools, read by the rounds
    flags = (torch.empty(b * c, dtype=torch.int32, device=scores.device)
             if plan.variant == "per_class_large" else None)
    stream = torch.cuda.current_stream(scores.device).cuda_stream
    rc = lib.yrt_nms(scores.data_ptr(), boxes.data_ptr(), out_b.data_ptr(), out_s.data_ptr(),
                     b, c, k, max_det, k * 4 if shared else c * k * 4, 0 if shared else k * 4,
                     iou_threshold, score_threshold, empty_score, VARIANTS.index(plan.variant),
                     plan.warps, plan.classes_per_pass, plan.smem,
                     None if flags is None else flags.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"nms kernel launch failed: {lib.yrt_error_string(rc).decode()}")
    suppress.launches += 1
    suppress.variant_launches[plan.variant] += 1
    return out_b, out_s


suppress.launches = 0
suppress.variant_launches = Counter()
