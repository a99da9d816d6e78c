"""The two Hopper kernels as PyTorch operators, so that a traced program
(``torch.export``, the EXPORT bundle of ``export/export.py``) carries them
as nodes instead of their plain versions unrolled:

  * ``yoloret::mbconv``: one fused inverted-residual block
    (``ops/mbconv.py``);
  * ``yoloret::nms``: greedy class-aware suppression over a shared pool
    (boxes [B, K, 4]) or per-class pools (boxes [B, C, K, 4])
    (``ops/nms_kernel.py``).

Each has three implementations. On CUDA tensors the existing wrapper
(``fused_mbconv``, ``suppress``): the one launch path, whose launch
counters keep counting. On CPU tensors the plain version
(``reference_mbconv``, ``suppress_plain``). A fake implementation gives
the output shapes and dtypes to the tracer, which reads no data and no
pointer. Neither operator has a backward, as no TPU kernel has one.

The arguments are tensors, ints, floats and bools, so that the schema
serialises. A block's ``PackedMBConv`` goes in as its packed tensor; its
ints (Cin, Ce, Cout, paddings, chunks) follow from the weights' shapes
(``ops/mbconv.py::packed_like``).

Importing this module registers both operators; ``torch.export.load``
of a program that holds them needs it imported first. The serving path
(``Predictor``) calls the wrappers directly, without the dispatcher's
host cost.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from yoloret_tpu_torch.ops.mbconv import fused_mbconv, packed_like, reference_mbconv
from yoloret_tpu_torch.ops.nms_kernel import suppress, suppress_plain

Tensor = torch.Tensor


@torch.library.custom_op("yoloret::mbconv", mutates_args=(), device_types="cpu")
def mbconv(x: Tensor, we: Optional[Tensor], be: Optional[Tensor], wd: Tensor, bd: Tensor,
           wp: Tensor, bp: Tensor, packed: Optional[Tensor], stride: int,
           residual: bool) -> Tensor:
    """One fused block, [B, H, W, Cin] -> [B, H/stride, W/stride, Cout]
    (layouts as ``fused_mbconv``'s; ``packed`` the weights packed for the
    kernel of x's dtype, or None). On the CPU: the plain version."""
    return reference_mbconv(x, we, be, wd, bd, wp, bp, stride=stride, residual=residual)


@mbconv.register_kernel("cuda")
def _mbconv_cuda(x, we, be, wd, bd, wp, bp, packed, stride, residual):
    return fused_mbconv(x, we, be, wd, bd, wp, bp, stride=stride, residual=residual,
                        packed=None if packed is None else packed_like(packed, we, wd, wp))


@mbconv.register_fake
def _mbconv_fake(x, we, be, wd, bd, wp, bp, packed, stride, residual):
    b, h, w, _ = x.shape
    return x.new_empty((b, -(-h // stride), -(-w // stride), wp.shape[-1]))


@torch.library.custom_op("yoloret::nms", mutates_args=(), device_types="cpu")
def nms(boxes: Tensor, scores: Tensor, max_det: int, iou_threshold: float,
        score_threshold: float, empty_score: float) -> Tuple[Tensor, Tensor]:
    """Greedy per-class NMS (``suppress``'s contract): scores [B, C, K],
    boxes [B, K, 4] or [B, C, K, 4] -> (boxes [B, C, D, 4], scores [B, C,
    D]). On the CPU: the plain version."""
    return suppress_plain(boxes, scores, max_det=max_det, iou_threshold=iou_threshold,
                          score_threshold=score_threshold, empty_score=empty_score)


@nms.register_kernel("cuda")
def _nms_cuda(boxes, scores, max_det, iou_threshold, score_threshold, empty_score):
    return suppress(boxes, scores, max_det=max_det, iou_threshold=iou_threshold,
                    score_threshold=score_threshold, empty_score=empty_score)


@nms.register_fake
def _nms_fake(boxes, scores, max_det, iou_threshold, score_threshold, empty_score):
    b, c, _ = scores.shape
    return (scores.new_empty((b, c, max_det, 4)), scores.new_empty((b, c, max_det)))


def mbconv_block(x, we, be, wd, bd, wp, bp, *, stride=1, residual=False, packed=None):
    """``fused_mbconv``'s signature over the ``yoloret::mbconv`` operator
    (the ``block`` of ``nn/fused_infer.mobilenetv2_fused_features``)."""
    return torch.ops.yoloret.mbconv(x, we, be, wd, bd, wp, bp,
                                    None if packed is None else packed.w, stride, residual)
