"""Fused-backbone inference: MobileNetV2 through the fused MBConv kernel
with BatchNorm folded into the conv weights. Port of
``yoloret_tpu/nn/fused_infer.py`` (``fold_bn``, ``_block_args``,
``_block_meta``, ``mobilenetv2_fused_features``, ``fused_detector_apply``).

For a MobileNetV2 backbone (``mobilenetv2x75``/``x10``/``x14``) it
rebuilds the stock forward of ``nn.detector.YoloReT`` from the same
module weights:

  * inference BN is the affine z*s + t with s = gamma/sqrt(var+eps),
    t = beta - mean*s, folded into each conv's kernel and a bias;
  * the stem is one ``F.conv2d`` with the folded BN;
  * all 16 inverted-residual blocks (block_0..block_15, the stride-2
    blocks 1/3/6/13 included) run as one kernel launch each
    (``ops/mbconv.py``), on weights packed once here for the kernel of
    the model's dtype (``pack_mbconv`` for the bf16 kernel's
    shared-memory layout, ``pack_mbconv_f32`` for the float32 kernel's
    chunks);
  * RFCR, neck and the head split stay the stock modules.

A kernel or its planner that refuses a block's shape raises; a
MobileNetV2 model never falls back to the stock forward. Every other
backbone (EfficientNet, DarkNet-53, the legacy bodies) has no fused
kernel and takes the stock forward, as the JAX package's
``fused_detector_apply`` does. This is the forward the Predictor runs.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from yoloret_tpu_torch.nn.detector import YoloReT
from yoloret_tpu_torch.nn.layers import conv2d_same, fold_bn, relu6
from yoloret_tpu_torch.nn.mobilenetv2 import _TAP_BLOCKS, InvertedResidual, MobileNetV2
from yoloret_tpu_torch.ops.mbconv import (PackedMBConv, fused_mbconv, pack_mbconv,
                                          pack_mbconv_f32)


class BlockMeta(NamedTuple):
    block_id: int
    stride: int
    residual: bool
    args: Tuple  # (we, be, wd, bd, wp, bp) in the kernel's layouts
    packed: Optional[PackedMBConv]  # the weights packed for the kernel of the dtype


class FusedParams(NamedTuple):
    stem: Tuple[torch.Tensor, torch.Tensor]  # folded kernel [O, I, 3, 3], bias [O]
    blocks: List[BlockMeta]


def _block_args(block: InvertedResidual, dtype: torch.dtype):
    """(we, be, wd, bd, wp, bp) for one block, BN folded: we [Cin, Ce],
    wd [3, 3, Ce], wp [Ce, Cout] in ``dtype``; biases [C] float32."""
    if block.expand is not None:
        ke, be = fold_bn(block.expand.conv.weight, block.expand.bn)
        we = ke[:, :, 0, 0].t().to(dtype).contiguous()  # [Ce, Cin, 1, 1] -> [Cin, Ce]
        be = be.float().contiguous()
    else:
        we = be = None
    kd, bd = fold_bn(block.depthwise.dwconv.weight, block.depthwise.bn)
    wd = kd[:, 0].permute(1, 2, 0).to(dtype).contiguous()  # [Ce, 1, 3, 3] -> [3, 3, Ce]
    kp, bp = fold_bn(block.project.conv.weight, block.project.bn)
    wp = kp[:, :, 0, 0].t().to(dtype).contiguous()  # [Cout, Ce, 1, 1] -> [Ce, Cout]
    return we, be, wd, bd.float().contiguous(), wp, bp.float().contiguous()


def _block_meta(body: MobileNetV2, dtype: torch.dtype) -> List[BlockMeta]:
    """One entry per block, 0..last tap, BN folded; the weights are also
    packed, once, for the kernel of ``dtype`` (bf16: the Hopper kernel's
    layout; float32: ``mbconv_f32``'s chunks)."""
    meta = []
    for block_id, name in enumerate(body.block_names):
        block = getattr(body, name)
        args = _block_args(block, dtype)
        packed = (pack_mbconv if dtype == torch.bfloat16 else pack_mbconv_f32)(*args[:5])
        meta.append(BlockMeta(block_id, block.stride, block.residual, args, packed))
    return meta


def is_fused(model: YoloReT) -> bool:
    """Whether the model's backbone runs on the fused MBConv kernel."""
    return model.kind == "mobilenetv2"


@torch.no_grad()
def fused_params(model: YoloReT) -> Optional[FusedParams]:
    """The folded stem and block weights (and the packed weights),
    computed once per model; None for a backbone without a fused path."""
    if not is_fused(model):
        return None
    body = model.body
    ks, bs = fold_bn(body.stem.conv.weight, body.stem.bn)
    return FusedParams((ks.to(model.dtype), bs.float()), _block_meta(body, model.dtype))


def mobilenetv2_fused_features(x: torch.Tensor, params: FusedParams, block=fused_mbconv
                               ) -> Dict[str, torch.Tensor]:
    """Pyramid features {c2, c3, c4, c5}: stem conv, then every block
    through the fused kernel (``block``: ``fused_mbconv``, or a callable
    with its signature, e.g. ``ops/library.mbconv_block``, the operator
    an exported program holds). ``x`` [B, H, W, 3] in the compute dtype."""
    ks, bs = params.stem
    x = relu6(conv2d_same(x, ks, bs, stride=2)).contiguous()
    feats: Dict[str, torch.Tensor] = {}
    for block_id, stride, residual, args, packed in params.blocks:
        x = block(x, *args, stride=stride, residual=residual, packed=packed)
        if block_id in _TAP_BLOCKS:
            feats[_TAP_BLOCKS[block_id]] = x
    return feats


@torch.no_grad()
def fused_detector_apply(model: YoloReT, images: torch.Tensor,
                         params: Optional[FusedParams] = None):
    """Inference forward equal to ``model(images)``, with a MobileNetV2
    backbone on the fused kernel (any other backbone takes the stock
    forward). Heads [B, gh, gw, A, 5+C] in the compute dtype."""
    if not is_fused(model):
        return model(images)
    model.check_input(images)
    if params is None:
        params = fused_params(model)
    feats = mobilenetv2_fused_features(images.to(model.dtype), params)
    return model.neck_heads(feats)
