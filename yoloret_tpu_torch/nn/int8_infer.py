"""W8A8 int8 inference for the MobileNetV2 and EfficientNet backbones.
Port of ``yoloret_tpu/nn/int8_infer.py``: the same calibration, weight
quantization, block schema and forward, read from the port's own module
weights (BatchNorm folded as ``nn/fused_infer.py`` folds it).

Quantization scheme (the JAX package's):
  * weights: symmetric per-output-channel int8 of the BN-folded kernels
    (``_quant_w``: ``round(w / ws)``, ``ws = max(amax, 1e-8) / 127``);
  * activations: symmetric per-tensor int8, scale ``amax / 127`` (a Python
    float) from an amax calibration pass over representative batches;
  * SAME padding of the depthwise convs is exact (padded zeros are real
    zeros: no zero point);
  * the stem (3 input channels), RFCR and the neck stay in the model's
    dtype; EfficientNet's squeeze-excite runs in float32 on the pooled
    vector; the taps c2..c5 are dequantized to the model's dtype.

Every tensor between backbone convs is ``torch.int8``. The arithmetic:
  * 1x1 convs (expand, project): int8 x int8 -> exact int32 products over
    the flattened NHWC rows by ``torch._int_mm`` (``int_mm``), the JAX
    package's ``conv_general_dilated(..., preferred_element_type=int32)``.
    float32 is not exact here: x1.4's project has K = 1,344 and
    1,344 * 127^2 > 2^24.
  * kxk depthwise (k = 3, or 5 in EfficientNet): a float32 grouped
    convolution of the int8 codes (``_dw_i8``), exact (see there).
  * epilogues: float32 elementwise ops, each separate and in the JAX
    order, so that no code flips at .5 (rounding is half to even in
    both frameworks).

On a row shard (``parallel/spatial.py``) the same forward runs on the
shard's rows: the stem and the depthwise take their halo rows through
``conv2d_same``, the 1x1 convs and the epilogues are local to a row, and
EfficientNet's squeeze-excite mean sums the group's codes
(``layers.mean_hw`` of the codes), so the codes are one device's bit for bit.

``int8_detector_apply`` is the forward ``Predictor(use_int8=True)`` runs:
no hand kernel of the port on the backbone (the JAX package's int8 path
runs no Pallas kernel either; its convs are XLA's), the NMS kernel after
it.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from yoloret_tpu_torch.nn.detector import YoloReT
from yoloret_tpu_torch.nn.efficientnet import _TAP_STAGES, EfficientNet
from yoloret_tpu_torch.nn.layers import conv2d_same, mean_hw, relu6, swish
from yoloret_tpu_torch.nn.mobilenetv2 import _TAP_BLOCKS, MobileNetV2

Params = Dict[str, Any]


def supports_int8(backbone: str) -> bool:
    """Whether ``backbone`` has the int8 path (MobileNetV2, EfficientNet)."""
    return backbone.startswith(("mobilenetv2", "efficientnetb"))


def _require_int8(model: YoloReT) -> None:
    if not supports_int8(model.backbone):
        raise ValueError(f"the int8 path supports mobilenetv2* / efficientnetb*, not "
                         f"{model.backbone!r}")


# -- the int8 arithmetic -----------------------------------------------------


def check_mm_shape(m: int, k: int, n: int) -> None:
    """Raise unless ``torch._int_mm`` on CUDA takes [M, K] x [K, N]: K and
    N positive multiples of 8. (M > 16 is its third condition; ``int_mm``
    pads the rows for it.) Held on every device, so that a shape the card
    would refuse fails on the CPU too."""
    if m < 1 or k < 1 or n < 1 or k % 8 or n % 8:
        raise ValueError(f"int8 matmul [{m}, {k}] x [{k}, {n}]: torch._int_mm needs K and N "
                         "positive multiples of 8")


def int_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] int8 @ w [K, N] int8 -> [M, N] int32, exact. ``w`` is
    kept column-major (``[N, K]`` storage), cuBLASLt's int8 layout. Rows
    are zero-padded to 17 where M <= 16 (the card's third condition) and
    cut off again."""
    m, k = x.shape
    check_mm_shape(m, k, w.shape[1])
    if k != w.shape[0]:
        raise ValueError(f"int8 matmul [{m}, {k}] x {list(w.shape)}: inner sizes differ")
    if m <= 16:
        return torch._int_mm(F.pad(x, (0, 0, 0, 17 - m)), w)[:m]
    return torch._int_mm(x.contiguous(), w)


def _conv1x1_i8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC int8 [B, H, W, Cin] x [Cin, Cout] int8 -> int32 [B, H, W, Cout]."""
    b, h, wd, c = x.shape
    return int_mm(x.reshape(-1, c), w).reshape(b, h, wd, w.shape[1])


def _dw_i8(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """Depthwise kxk SAME conv of int8 codes x [B, H, W, C] with int8
    weights w [C, 1, k, k] -> float32 holding the exact int32 sums.

    A float32 grouped convolution (``conv2d_same``, TF's asymmetric SAME
    padding), exact: every operand is an integer of at most 127 in
    magnitude (exact in float32, and in TF32's 10-bit mantissa on the
    card), every product at most 127^2 and every partial sum, in any
    order, at most k^2 * 127^2 = 403,225 (k = 5) < 2^24, so each is an
    integer that float32 holds exactly."""
    return conv2d_same(x.float(), w.float(), None, stride, groups=x.shape[-1])


def _quant_w(w: torch.Tensor):
    """Symmetric per-output-channel int8. w [..., Cout] float32 ->
    (w_q int8, w_s float32 [Cout]); divides, as the JAX package does
    (eagerly: its ``/ 127.0`` is a true division). The 127 is a tensor:
    CUDA divides by a Python scalar as a product with its float32
    reciprocal, one ulp off the quotient at times."""
    ws = w.abs().amax(dim=tuple(range(w.dim() - 1)))
    ws = torch.clamp(ws, min=1e-8) / torch.full_like(ws, 127.0)
    wq = torch.clamp(torch.round(w / ws), -127, 127).to(torch.int8)
    return wq, ws.float()


def _column_major(w: torch.Tensor) -> torch.Tensor:
    """[K, N] with [N, K] storage (``int_mm``'s weight layout)."""
    return w.t().contiguous().t()


def _q(y: torch.Tensor, s: float) -> torch.Tensor:
    return torch.clamp(torch.round(y * (1.0 / s)), -127, 127).to(torch.int8)


def _act(y: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "relu6":
        return relu6(y)
    if kind == "swish":
        return swish(y)
    raise ValueError(kind)


def _requant_folded(acc: torch.Tensor, deq: torch.Tensor, bias: torch.Tensor, out_s: float,
                    act: Optional[str], extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scale-folded requant epilogue, in output-scale units: ``acc *
    (deq * inv) + bias * inv`` with both vectors formed first, then the
    pre-scaled residual ``extra``, then relu6 as clip(y, 0, 6 * inv)."""
    inv = 1.0 / out_s
    y = acc.float() * (deq * inv) + bias * inv
    if extra is not None:
        y = y + extra
    if act == "relu6":
        y = torch.clamp(y, 0.0, 6.0 * inv)
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


def _int8_block(xq: torch.Tensor, blk: Params, folded: bool = False) -> torch.Tensor:
    """One quantized MBConv / inverted-residual block, int8 in and out.
    ``folded`` takes the scale-folded epilogues where the block is
    relu6 without squeeze-excite. ``blk``: see ``quantize_mobilenetv2`` /
    ``quantize_efficientnet``."""
    act = blk.get("act", "relu6")
    use_fold = folded and act == "relu6" and "se_reduce_w" not in blk
    y = xq
    if "we_q" in blk:
        e = _conv1x1_i8(y, blk["we_q"])
        if use_fold:
            y = _requant_folded(e, blk["e_deq"], blk["e_bias"], blk["e_s"], act)
        else:
            y = _q(_act(e.float() * blk["e_deq"] + blk["e_bias"], act), blk["e_s"])
    d = _dw_i8(y, blk["wd_q"], blk["stride"])
    if use_fold:
        d_q = _requant_folded(d, blk["d_deq"], blk["d_bias"], blk["d_s"], act)
        p = _conv1x1_i8(d_q, blk["wp_q"])
        extra = None
        if blk["residual"]:
            extra = xq.float() * (blk["in_s"] / blk["out_s"])
        return _requant_folded(p, blk["p_deq"], blk["p_bias"], blk["out_s"], None, extra=extra)
    d = _act(d * blk["d_deq"] + blk["d_bias"], act)
    y = _q(d, blk["d_s"])
    if "se_reduce_w" in blk:
        # float32 on the pooled vector; the expanded tensor is read as int8
        m = mean_hw(y, keepdim=True) * blk["d_s"]
        s = swish(torch.matmul(m, blk["se_reduce_w"]) + blk["se_reduce_b"])
        s = torch.sigmoid(torch.matmul(s, blk["se_excite_w"]) + blk["se_excite_b"])
        y = _q(y.float() * (blk["d_s"] * s), blk["p_in_s"])
    p = _conv1x1_i8(y, blk["wp_q"])
    p = p.float() * blk["p_deq"] + blk["p_bias"]
    if blk["residual"]:
        p = p + xq.float() * blk["in_s"]
    return _q(p, blk["out_s"])


# -- calibration -------------------------------------------------------------


def _fold_bn(weight: torch.Tensor, bn) -> Tuple[torch.Tensor, torch.Tensor]:
    """``layers.fold_bn`` in float32, op for op as the JAX package folds,
    but with the square root taken in float64 and rounded once: that is
    the correctly rounded float32 root on every device, where CUDA's
    float32 ``sqrt`` differs from the CPU's in the last bit on some
    values. So the folded weights, and with them the calibration and
    every int8 code, are the same on the card and on the CPU."""
    s = bn.weight.float() / torch.sqrt((bn.running_var.float() + bn.eps).double()).float()
    return (weight.float() * s.reshape(-1, *([1] * (weight.dim() - 1))),
            bn.bias.float() - bn.running_mean.float() * s)


class _Block(NamedTuple):
    stride: int
    residual: bool
    tap: Optional[str]  # the pyramid key of the block's output, if it is a tap
    args: tuple  # (we [Cin, Ce] or None, be, wd [k, k, Ce], bd, wp [Ce, Cout], bp), folded
    se: Optional[Params]  # {reduce_w [Ce, R], reduce_b, excite_w [R, Ce], excite_b}


def _meta(body) -> List[_Block]:
    """The backbone's blocks up to the last tap, BN folded (``_fold_bn``),
    in the int8 path's layouts: MobileNetV2's inverted residuals and
    EfficientNet's MBConvs (stages 0..last tap) alike."""
    if isinstance(body, MobileNetV2):
        blocks = [(getattr(body, n), _TAP_BLOCKS.get(i)) for i, n in enumerate(body.block_names)]
    else:
        blocks = [(getattr(body, n), _TAP_STAGES.get(si) if r == len(names) - 1 else None)
                  for si, names in body.stage_blocks if si <= max(_TAP_STAGES)
                  for r, n in enumerate(names)]
    out = []
    for blk, tap in blocks:
        we = be = None
        if blk.expand is not None:
            we, be = _fold_bn(blk.expand.conv.weight, blk.expand.bn)
            we = we[:, :, 0, 0].t()
        wd, bd = _fold_bn(blk.depthwise.dwconv.weight, blk.depthwise.bn)
        wp, bp = _fold_bn(blk.project.conv.weight, blk.project.bn)
        se = getattr(blk, "se", None)
        if se is not None:
            se = dict(reduce_w=se.reduce.weight[:, :, 0, 0].t().contiguous(),
                      reduce_b=se.reduce.bias.clone(),
                      excite_w=se.excite.weight[:, :, 0, 0].t().contiguous(),
                      excite_b=se.excite.bias.clone())
        out.append(_Block(blk.depthwise.dwconv.stride, blk.residual, tap,
                          (we, be, wd[:, 0].permute(1, 2, 0), bd, wp[:, :, 0, 0].t(), bp), se))
    return out


def _mm(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(y, w.to(y.dtype))


def _block_float(x: torch.Tensor, m: _Block, act: str):
    """The float forward of one block in ``x``'s dtype: (e, d, p_in,
    out), the calibration taps (e None without expand; p_in, the project
    conv's input, is d without SE)."""
    we, be, wd, bd, wp, bp = m.args
    y, e = x, None
    if we is not None:
        e = y = _act(_mm(y, we) + be, act)
    d = y = _act(conv2d_same(y, wd.permute(2, 0, 1)[:, None], None, m.stride,
                             groups=wd.shape[-1]) + bd, act)
    if m.se is not None:
        t = swish(_mm(y.mean(dim=(1, 2), keepdim=True), m.se["reduce_w"]) + m.se["reduce_b"])
        y = y * torch.sigmoid(_mm(t, m.se["excite_w"]) + m.se["excite_b"])
    out = _mm(y, wp) + bp
    return e, d, y, (out + x if m.residual else out)


@torch.no_grad()
def _calibrate(body, batches, act: str, p_in: bool) -> Params:
    """Per-tensor amax scales, ``float(amax) / 127.0``, of the stem and of
    each block's expand output ("e", where it expands), depthwise output
    ("d"), project input ("p_in", with ``p_in``) and output ("out"), over
    ``batches`` [B, H, W, 3] in [0, 1]. The forward runs in float64 on
    the folded float32 weights: its amaxes are the float32 forward's to a
    few ulps (the JAX package's are its float32 forward's, summed in
    XLA's order) and do not depend on the device's summation order."""
    meta = _meta(body)
    ks, bs = _fold_bn(body.stem.conv.weight, body.stem.bn)
    acc = None
    for b in batches:
        x = torch.as_tensor(np.asarray(b, np.float64), device=ks.device)
        x = _act(conv2d_same(x, ks, None, stride=2) + bs, act)
        vals = [x.abs().amax()]
        for m in meta:
            e, d, y, x = _block_float(x, m, act)
            vals += [t.abs().amax() for t in (e, d, y if p_in else None, x) if t is not None]
        vals = torch.stack(vals)
        acc = vals if acc is None else torch.maximum(acc, vals)
    scales = iter(float(v) / 127.0 for v in acc.cpu().numpy())
    out: Params = {"stem": next(scales), "blocks": []}
    for m in meta:
        keys = (["e"] if m.args[0] is not None else []) + ["d"] + (["p_in"] if p_in else [])
        out["blocks"].append({k: next(scales) for k in keys + ["out"]})
    return out


def calibrate_mobilenetv2(body: MobileNetV2, batches: Sequence[np.ndarray]) -> Params:
    """Per-tensor activation amax scales from representative batches
    [B, H, W, 3] in [0, 1]: {"stem": s, "blocks": [{"e", "d", "out"}...]}
    ("e" only where the block expands)."""
    return _calibrate(body, batches, "relu6", p_in=False)


def calibrate_efficientnet(body: EfficientNet, batches: Sequence[np.ndarray]) -> Params:
    """As ``calibrate_mobilenetv2``; the blocks also get ``p_in``, the
    project conv's input after SE."""
    return _calibrate(body, batches, "swish", p_in=True)


# -- weight quantization -----------------------------------------------------


def _quant_1x1(w: torch.Tensor):
    """(int8 [Cin, Cout] column-major, scales) of a folded 1x1 kernel
    [Cin, Cout]; raises where ``torch._int_mm`` would refuse the shape."""
    check_mm_shape(1, *w.shape)
    wq, ws = _quant_w(w)
    return _column_major(wq), ws


def _quant_dw(wd: torch.Tensor):
    """(int8 [C, 1, k, k], scales) of a folded depthwise kernel [k, k, C]."""
    k, _, c = wd.shape
    wq, ws = _quant_w(wd.reshape(k * k, c))
    return wq.t().reshape(c, 1, k, k).contiguous(), ws


@torch.no_grad()
def _quantize(body, scales: Params, act: str) -> Params:
    """The int8 tree from the folded float32 weights and the scales: per
    conv one per-channel float32 dequant factor (input scale x weight
    scale) and the folded float32 bias. EfficientNet's (swish) blocks also
    carry ``act``, their SE weights and ``p_in_s``, and the tree ``taps``
    {block index: key}, as the JAX package's do."""
    ks, bs = _fold_bn(body.stem.conv.weight, body.stem.bn)
    effnet = act == "swish"
    qp: Params = {"stem": dict(kernel=ks, bias=bs, out_s=scales["stem"]), "blocks": []}
    if effnet:
        qp["stem"]["act"], qp["taps"] = act, {}
    in_s = scales["stem"]
    for bi, (m, sc) in enumerate(zip(_meta(body), scales["blocks"])):
        we, be, wd, bd, wp, bp = m.args
        blk: Params = dict(stride=m.stride, residual=m.residual, in_s=in_s, out_s=sc["out"])
        if effnet:
            blk["act"] = act
        d_in_s = in_s
        if we is not None:
            blk["we_q"], ws = _quant_1x1(we)
            blk["e_deq"] = in_s * ws
            blk["e_bias"] = be
            blk["e_s"] = d_in_s = sc["e"]
        blk["wd_q"], ws = _quant_dw(wd)
        blk["d_deq"] = d_in_s * ws
        blk["d_bias"] = bd
        blk["d_s"] = p_in_s = sc["d"]
        if m.se is not None:
            blk.update({f"se_{k}": v for k, v in m.se.items()})
            blk["p_in_s"] = p_in_s = sc["p_in"]
        blk["wp_q"], ws = _quant_1x1(wp)
        blk["p_deq"] = p_in_s * ws
        blk["p_bias"] = bp
        qp["blocks"].append(blk)
        if effnet and m.tap:
            qp["taps"][bi] = m.tap
        in_s = sc["out"]
    return qp


def quantize_mobilenetv2(body: MobileNetV2, scales: Params) -> Params:
    """The int8 parameter tree of the MobileNetV2 backbone (the JAX
    package's schema: stride, residual, in_s, out_s; we_q, e_deq, e_bias,
    e_s where it expands; wd_q, d_deq, d_bias, d_s; wp_q, p_deq, p_bias)."""
    return _quantize(body, scales, "relu6")


def quantize_efficientnet(body: EfficientNet, scales: Params) -> Params:
    """The int8 parameter tree of the EfficientNet backbone: the schema of
    ``quantize_mobilenetv2`` plus ``act``, the SE fields and ``p_in_s``,
    and ``taps``."""
    return _quantize(body, scales, "swish")


@torch.no_grad()
def quantize_from_data(model: YoloReT, sample_images, batch: int = 8) -> Params:
    """Calibrate and quantize in one call. ``sample_images`` [N, H, W, 3]
    float in [0, 1] (a few dozen representative images), in batches of
    ``batch``, on the model's device."""
    _require_int8(model)
    arr = np.asarray(sample_images, np.float32)
    batches = [arr[i:i + batch] for i in range(0, len(arr), batch)]
    if model.kind == "mobilenetv2":
        return quantize_mobilenetv2(model.body, calibrate_mobilenetv2(model.body, batches))
    return quantize_efficientnet(model.body, calibrate_efficientnet(model.body, batches))


# -- the int8 forward --------------------------------------------------------


def _stem_i8(st: Params, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The stem conv in ``dtype`` (float32: in float64, rounded once to
    float32, so that its codes do not depend on the device's summation
    order), float32 bias and activation, int8 codes."""
    if dtype == torch.float32:
        y = conv2d_same(x.double(), st["kernel"].double(), None, stride=2).float()
    else:
        y = conv2d_same(x.to(dtype), st["kernel"].to(dtype), None, stride=2).float()
    return _q(_act(y + st["bias"], st.get("act", "relu6")), st["out_s"])


def _tap(xq: torch.Tensor, out_s: float, dtype: torch.dtype) -> torch.Tensor:
    return (xq.float() * out_s).to(dtype)


def mobilenetv2_int8_features(qp: Params, x: torch.Tensor, dtype: torch.dtype = torch.bfloat16,
                              folded: bool = False) -> Dict[str, torch.Tensor]:
    """Pyramid features {c2..c5}, dequantized to ``dtype``, with the
    backbone's conv chain on int8. ``x`` [B, H, W, 3] in [0, 1];
    ``folded``: the scale-folded epilogues (``_requant_folded``)."""
    xq = _stem_i8(qp["stem"], x, dtype)
    feats: Dict[str, torch.Tensor] = {}
    for bid, blk in enumerate(qp["blocks"]):
        xq = _int8_block(xq, blk, folded=folded)
        if bid in _TAP_BLOCKS:
            feats[_TAP_BLOCKS[bid]] = _tap(xq, blk["out_s"], dtype)
    return feats


def efficientnet_int8_features(qp: Params, x: torch.Tensor, dtype: torch.dtype = torch.bfloat16
                               ) -> Dict[str, torch.Tensor]:
    """Pyramid features {c2..c5} with the EfficientNet conv chain on int8
    (SE pools and scales in float32)."""
    xq = _stem_i8(qp["stem"], x, dtype)
    feats: Dict[str, torch.Tensor] = {}
    for bi, blk in enumerate(qp["blocks"]):
        xq = _int8_block(xq, blk)
        if bi in qp["taps"]:
            feats[qp["taps"][bi]] = _tap(xq, blk["out_s"], dtype)
    return feats


@torch.no_grad()
def int8_detector_apply(model: YoloReT, qp: Params, images: torch.Tensor, folded: bool = True):
    """The inference forward of ``model(images)`` with the backbone on the
    int8 path; RFCR and the neck are the model's own modules. Heads [B,
    gh, gw, A, 5+C] in the compute dtype. ``folded`` (on by default, as in
    the JAX package) takes the scale-folded epilogues in the relu6
    blocks; swish and SE blocks keep the unfolded chain."""
    _require_int8(model)
    model.check_input(images)
    if model.kind == "mobilenetv2":
        feats = mobilenetv2_int8_features(qp, images, model.dtype, folded=folded)
    else:
        feats = efficientnet_int8_features(qp, images, model.dtype)
    return model.neck_heads(feats)
