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
MobileNetV2 model never falls back to the stock forward.

On a row shard (``parallel/spatial.py``) the stem convolves its rows
with their halo (``conv2d_same``), and each block runs the kernel on a
slab of real rows of the whole map (``slab_window``), then keeps the
shard's own output rows. The kernel pads the depthwise with zeros in
the expanded space, after the expand's ReLU6, so a zero row given as a
halo would come out of the expand as ReLU6(bias), not zero: the slab
holds only rows of the map, and it is cut so that the kernel's own
``"SAME"`` padding falls where the whole map's does. Every other
backbone (EfficientNet, DarkNet-53, the legacy bodies) has no fused
kernel and takes the stock forward, as the JAX package's
``fused_detector_apply`` does. This is the forward the Predictor runs.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from yoloret_tpu_torch.nn.detector import YoloReT
from yoloret_tpu_torch.nn.layers import conv2d_same, fold_bn, relu6
from yoloret_tpu_torch.nn.mobilenetv2 import _TAP_BLOCKS, InvertedResidual, MobileNetV2
from yoloret_tpu_torch.ops.mbconv import (PackedMBConv, fused_mbconv, pack_mbconv,
                                          pack_mbconv_f32)
from yoloret_tpu_torch.parallel.spatial import current as spatial_shard


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


def slab_window(first: int, rows: int, height: int, stride: int) -> Tuple[int, int, int]:
    """(a, b, skip): the block's input rows [a, b) of a ``height``-row map
    for its output rows [first, first + rows) (of the output map), such
    that the kernel's ``"SAME"`` padding of the slab falls where the
    whole map's does; the wanted rows start at output row ``skip`` of the
    slab's output.

    Stride 1: [first - 1, first + rows + 1) clipped to the map, skipping
    the halo's output row above. Stride 2 (even maps, padded (0, 1)):
    [2 first, 2 (first + rows) + 2), or to the map's end at the bottom,
    an even length, so the slab too is padded (0, 1); its last output row
    is dropped where it is not the map's."""
    if stride == 1:
        a = max(first - 1, 0)
        return a, min(first + rows + 1, height), first - a
    if height % 2:
        raise ValueError(f"the stride-2 block needs an even map, got {height} rows")
    a = 2 * first
    return a, min(2 * (first + rows) + 2, height), 0


def block_on_slab(block, x: torch.Tensor, *args, stride: int, **kw) -> torch.Tensor:
    """``block`` (``fused_mbconv``'s signature) for this row shard's
    output rows: the kernel on the slab of ``slab_window``, gathered from
    the shards that own its rows, then the shard's rows of its output."""
    shard = spatial_shard()
    first, n, h = shard.level(x.shape[1], stride)
    a, b, skip = slab_window(first // stride, n // stride, h, stride)
    y = block(shard.rows(x, a, b), *args, stride=stride, **kw)
    return y[:, skip:skip + n // stride]


def mobilenetv2_fused_features(x: torch.Tensor, params: FusedParams, block=fused_mbconv
                               ) -> Dict[str, torch.Tensor]:
    """Pyramid features {c2, c3, c4, c5}: stem conv, then every block
    through the fused kernel (``block``: ``fused_mbconv``, or a callable
    with its signature, e.g. ``ops/library.mbconv_block``, the operator
    an exported program holds). ``x`` [B, H, W, 3] in the compute dtype."""
    ks, bs = params.stem
    x = relu6(conv2d_same(x, ks, bs, stride=2)).contiguous()
    feats: Dict[str, torch.Tensor] = {}
    run = block if spatial_shard() is None else functools.partial(block_on_slab, block)
    for block_id, stride, residual, args, packed in params.blocks:
        x = run(x, *args, stride=stride, residual=residual, packed=packed)
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
