"""Fused inverted-residual (MBConv) block: the CUDA kernel's wrapper and
its plain PyTorch version.

Kernel: ``csrc/mbconv.cu``, built for sm_90a on first use. It replaces
the TPU kernels ``yoloret_tpu/ops/mbconv_pallas.py::_kernel_s1`` /
``_kernel_s2`` (stride 1 and 2, NHWC row tiles) and
``yoloret_tpu/ops/mbconv_pallas2.py::_cp_kernel`` (stride 1 in the TPU's
channels-major lane layout, which is TPU plumbing and not ported).

What bounds it on the card: device-memory bytes. Unfused, every block
writes and re-reads its 6x-expanded tensor; the kernel moves only the
block's input and output, and keeps the expanded channels in shared
memory, 32 at a time, for one tile of output pixels per thread block
(see the note at the top of the CUDA source). The kernel takes
Cout % 8 == 0 and Cin a multiple of 16 bytes of its dtype (every block
of MobileNetV2 x0.75 does).

Block semantics, BN folded into the weights (``nn/fused_infer.fold_bn``):
expand 1x1 + ReLU6 -> depthwise 3x3 "SAME" + ReLU6 -> project 1x1
[+ residual]. Stride-2 "SAME" pads (0, 1) on an even input. Arithmetic is
float32, rounded to the input dtype after the expand, after the
depthwise and at the output, as the JAX kernel rounds.

Layouts, as in the JAX kernel: x [B, H, W, Cin]; we [Cin, Ce] (None
without expand); wd [3, 3, Ce]; wp [Ce, Cout] in x's dtype; biases be
[Ce], bd [Ce], bp [Cout] (or [1, C]) float32.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from yoloret_tpu_torch.nn.layers import relu6, same_padding
from yoloret_tpu_torch.ops import _build

_vp, _ci = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {
    "yrt_mbconv": ([_vp] * 8 + [_ci] * 10 + [_vp], _ci),
    "yrt_mbconv_tile": ([_ci] * 6, _ci),
    "yrt_error_string": ([_ci], ctypes.c_char_p),
}


def _lib() -> ctypes.CDLL:
    return _build.load("mbconv", _PROTOTYPES)


def reference_mbconv(x, we, be, wd, bd, wp, bp, *, stride: int = 1, residual: bool = False):
    """Plain PyTorch version: the three convs of the JAX package's
    ``reference_mbconv`` in float32, rounded to ``x.dtype`` at the same
    three points as the kernel."""
    dt = x.dtype
    y = x
    if we is not None:
        y = relu6(torch.matmul(y.float(), we.float()) + be.reshape(-1).float()).to(dt)
    ce = wd.shape[-1]
    ph = same_padding(y.shape[1], 3, stride)
    pw = same_padding(y.shape[2], 3, stride)
    yc = F.pad(y.float().permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    yc = F.conv2d(yc, wd.float().permute(2, 0, 1).reshape(ce, 1, 3, 3), stride=stride,
                  groups=ce)
    y = relu6(yc.permute(0, 2, 3, 1) + bd.reshape(-1).float()).to(dt)
    y = torch.matmul(y.float(), wp.float()) + bp.reshape(-1).float()
    if residual:
        y = y + x.float()
    return y.to(dt)


def _check(x, we, be, wd, bd, wp, bp, stride, residual):
    b, h, w, cin = x.shape
    ce, cout = wd.shape[-1], wp.shape[-1]
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if residual and (stride != 1 or cin != cout):
        raise ValueError("residual needs stride 1 and Cin == Cout")
    if we is None:
        if ce != cin:
            raise ValueError("a block without expand runs the depthwise over Cin")
    elif tuple(we.shape) != (cin, ce) or be is None or be.numel() != ce:
        raise ValueError(f"expand weights {tuple(we.shape)} do not fit Cin={cin}, Ce={ce}")
    if tuple(wd.shape) != (3, 3, ce) or bd.numel() != ce:
        raise ValueError(f"depthwise weights {tuple(wd.shape)} do not fit Ce={ce}")
    if tuple(wp.shape) != (ce, cout) or bp.numel() != cout:
        raise ValueError(f"project weights {tuple(wp.shape)} do not fit Ce={ce}")


def fused_mbconv(
    x: torch.Tensor,
    we: Optional[torch.Tensor],
    be: Optional[torch.Tensor],
    wd: torch.Tensor,
    bd: torch.Tensor,
    wp: torch.Tensor,
    bp: torch.Tensor,
    *,
    stride: int = 1,
    residual: bool = False,
) -> torch.Tensor:
    """One fused block, [B, H, W, Cin] -> [B, H/stride, W/stride, Cout].

    A CPU tensor takes the plain version. A CUDA tensor launches the
    kernel (and adds one to ``fused_mbconv.launches``), or raises."""
    _check(x, we, be, wd, bd, wp, bp, stride, residual)
    if x.device.type == "cpu":
        return reference_mbconv(x, we, be, wd, bd, wp, bp, stride=stride, residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mbconv runs on CPU or CUDA tensors, not {x.device}")
    b, h, w, cin = x.shape
    ce, cout = wd.shape[-1], wp.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_mbconv takes float32 or bfloat16, not {x.dtype}")
    if stride == 2 and (h % 2 or w % 2):
        raise ValueError(f"the stride-2 kernel needs an even input, got {h}x{w}")
    weights = [t for t in (we, wd, wp) if t is not None]
    biases = [t for t in (be, bd, bp) if t is not None]
    for t in [x] + weights + biases:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("fused_mbconv needs contiguous tensors on one device")
    if any(t.dtype != x.dtype for t in weights) or any(t.dtype != torch.float32 for t in biases):
        raise TypeError("weights must have the input's dtype and biases float32")
    vec = 16 // x.element_size()  # the input tile loads 16 bytes at a time
    if cin % vec or cout % 8:
        raise ValueError(f"the kernel needs Cin % {vec} == 0 and Cout % 8 == 0 for {x.dtype}, "
                         f"got Cin={cin}, Cout={cout}")
    lib = _lib()
    out = torch.empty((b, h // stride, w // stride, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.yrt_mbconv(
        x.data_ptr(), None if we is None else we.data_ptr(),
        None if be is None else be.data_ptr(), wd.data_ptr(), bd.data_ptr(),
        wp.data_ptr(), bp.data_ptr(), out.data_ptr(),
        b, h, w, cin, ce, cout, stride, int(we is not None), int(residual),
        int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"mbconv kernel launch failed: {lib.yrt_error_string(rc).decode()}")
    fused_mbconv.launches += 1
    return out


fused_mbconv.launches = 0


def tile_shape(h_out: int, w_out: int, stride: int, cin: int, cout: int,
               dtype: torch.dtype):
    """(rows, cols, pixels per project thread) of the output tile the
    kernel picks for these sizes (asks the built library)."""
    code = _lib().yrt_mbconv_tile(h_out, w_out, stride, cin, cout,
                                  int(dtype == torch.bfloat16))
    return code // 10000, code // 100 % 100, code % 100
