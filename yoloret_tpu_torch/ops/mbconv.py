"""Fused inverted-residual (MBConv) block: the CUDA kernels' wrapper, the
tile plan and weight packing of the Hopper kernel, and the plain PyTorch
version.

Kernels: ``csrc/mbconv.cu``, built for sm_90a on first use. They replace
the TPU kernels ``yoloret_tpu/ops/mbconv_pallas.py::_kernel_s1`` /
``_kernel_s2`` (stride 1 and 2, NHWC row tiles) and
``yoloret_tpu/ops/mbconv_pallas2.py::_cp_kernel`` (stride 1 in the TPU's
channels-major lane layout, which is TPU plumbing and not ported).

What bounds a block on the card: unfused, every block writes and re-reads
its 6x-expanded tensor; fused, it moves only its input, output and
weights. At b128@320 that leaves blocks 0-6 (the 160x160 to 40x40 maps)
bound by device-memory bytes and blocks 7-15 (20x20, 10x10, Ce up to 720)
by tensor-core operations.

bfloat16, the serving path (``mbconv_wgmma``): a persistent,
warp-specialised Hopper kernel. A producer warp loads the input tile and
its halo by TMA and the weights by 1-D bulk copy into mbarrier rings;
one to three consumer warpgroups run the expand on ``wgmma``, the
depthwise on the CUDA cores straight into the register A fragments of the
project ``wgmma``, and keep the project sums in registers across chunks of
48 expanded channels. The weights are packed once per model
(``pack_mbconv``, from ``nn/fused_infer.fused_params``) into the kernel's
shared-memory layout, so a chunk is one contiguous copy: this removes the
first version's (commit 46a8f8c) per-tile scalar gathers and transposes, its four block-wide
barriers per chunk, its f32 expanded chunk and its depthwise round trip
through shared memory (see the note at the top of the CUDA source).
``plan_tile`` chooses the output tile, the warpgroups, the pipeline
stages and the persistent grid, and checks shared memory against the
227 KB a block may use.

float32 (``mbconv_f32``, for checks against the plain version): the same
steps as fp32 FMAs on the CUDA cores; its tile is chosen in the CUDA source.

Block semantics, BN folded into the weights (``nn/fused_infer.fold_bn``):
expand 1x1 + ReLU6 -> depthwise 3x3 "SAME" + ReLU6 -> project 1x1
[+ residual]. Stride-2 "SAME" pads (0, 1) on an even input. Arithmetic is
float32, rounded to the input dtype after the expand, after the
depthwise and at the output, as the JAX kernel rounds. The kernels take
Cin and Cout multiples of 8 (bfloat16; float32 Cin % 4), Cout <= 264 in
bfloat16; every block of MobileNetV2 x0.75 fits.

Layouts, as in the JAX kernel: x [B, H, W, Cin]; we [Cin, Ce] (None
without expand); wd [3, 3, Ce]; wp [Ce, Cout] in x's dtype; biases be
[Ce], bd [Ce], bp [Cout] (or [1, C]) float32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from yoloret_tpu_torch.nn.layers import relu6, same_padding
from yoloret_tpu_torch.ops import _build

_vp, _ci = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {
    "yrt_mbconv_f32": ([_vp] * 8 + [_ci] * 9 + [_vp], _ci),
    "yrt_mbconv_bf16": ([_vp] * 4 + [_ci] * 17 + [_vp], _ci),
    "yrt_error_string": ([_ci], ctypes.c_char_p),
}

# The Hopper kernel's constants (csrc/mbconv.cu).
CH = 48  # expanded channels per chunk: the expand wgmma's N, the project's K
NBW = 24  # project wgmma N per instruction; Cout is padded to a multiple
MAX_NB = 11  # project accumulator blocks: Cout <= 264
SMEM_LIMIT = 232448  # 227 KB, what one block may use on sm_90
SM_SHARED = 233472  # 228 KB of shared memory per SM, 1 KB reserved per block
BAR_BYTES = 128


def _lib() -> ctypes.CDLL:
    return _build.load("mbconv", _PROTOTYPES)


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def _mbconv_sum(x, we, be, wd, bd, wp, bp, stride):
    """The block up to the project sum (float32, before the residual),
    rounded to ``x.dtype`` after the expand and after the depthwise."""
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
    return torch.matmul(y.float(), wp.float()) + bp.reshape(-1).float()


def reference_mbconv(x, we, be, wd, bd, wp, bp, *, stride: int = 1, residual: bool = False):
    """Plain PyTorch version: the three convs of the JAX package's
    ``reference_mbconv`` in float32, rounded to ``x.dtype`` at the same
    three points as the kernel."""
    y = _mbconv_sum(x, we, be, wd, bd, wp, bp, stride)
    if residual:
        y = y + x.float()
    return y.to(x.dtype)


# -- weight packing ----------------------------------------------------------


class PackedMBConv(NamedTuple):
    """One block's weights in the Hopper kernel's shared-memory layout:
    ``w`` is uint8 [nchunks, chunk_bytes], chunk c holding, for expanded
    channels [48c, 48c + 48):

    - the expand weights (only with expand) as the wgmma B operand
      [kpad/8][48/8][8 channels][8 inputs] (K-major 8x8 core matrices);
    - the project weights [48/8][coutp/8][8 outputs][8 channels], each
      k16 step's channels in ``K_ORDER`` (so that the four A-fragment
      columns a thread holds are four neighbouring expanded channels);
    - the depthwise weights [9 taps][48], float32 (bf16 values kept
      exact; the kernel reads them without unpacking);
    - the expand and depthwise biases, float32 [48] each.

    Inputs are padded to kpad = Cin rounded up to 16 (the wgmma K), Ce to
    a multiple of 48 and Cout to a multiple of 24, all with zero weights
    and biases: a padded expanded channel is relu6(0) = 0 and adds
    nothing to the project."""

    w: torch.Tensor
    cin: int
    ce: int
    cout: int
    kpad: int
    coutp: int
    nchunks: int
    expand: bool
    dtype: torch.dtype


# Row k of a k16 step of the project's B operand is expanded channel
# K_ORDER[k] of the step: a thread's A-fragment columns 2t, 2t+1, 2t+8, 2t+9
# are channels 4t .. 4t+3, which the depthwise reads in one 8-byte load.
K_ORDER = [0, 1, 4, 5, 8, 9, 12, 13, 2, 3, 6, 7, 10, 11, 14, 15]
_K_ROWS = [16 * s + k for s in range(CH // 16) for k in K_ORDER]
_K_INV = [_K_ROWS.index(i) for i in range(CH)]


def _cores(m: torch.Tensor) -> torch.Tensor:
    """[n, N, K] -> [n, K/8, N/8, 8, 8]: each chunk's B operand as K-major
    8x8 core matrices, K groups outermost."""
    n, rows, cols = m.shape
    return m.reshape(n, rows // 8, 8, cols // 8, 8).permute(0, 3, 1, 2, 4)


def _bytes(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.contiguous().view(torch.uint8).reshape(n, -1)


def pack_mbconv(we, be, wd, bd, wp) -> PackedMBConv:
    """Pack one block's folded weights (layouts as ``fused_mbconv``'s) once,
    in their dtype, on their device."""
    ce, cout = wd.shape[-1], wp.shape[-1]
    cin = we.shape[0] if we is not None else ce
    dt, dev = wd.dtype, wd.device
    kpad, coutp = _round_up(cin, 16), _round_up(cout, NBW)
    n = -(-ce // CH)
    cep = n * CH

    def padded(t, shape, dtype=dt):
        out = torch.zeros(shape, dtype=dtype, device=dev)
        out[tuple(slice(0, s) for s in t.shape)] = t.to(dtype)
        return out

    parts = []
    if we is not None:
        we_p = padded(we, (kpad, cep)).t().reshape(n, CH, kpad)  # [chunk][N=48][K=kpad]
        parts.append(_bytes(_cores(we_p), n))
    wp_p = padded(wp, (cep, coutp)).reshape(n, CH, coutp)[:, _K_ROWS]
    wp_p = wp_p.transpose(1, 2)  # [chunk][N=coutp][K=48, in K_ORDER]
    parts.append(_bytes(_cores(wp_p), n))
    wd_p = padded(wd.reshape(9, ce), (9, cep), torch.float32).reshape(9, n, CH).transpose(0, 1)
    parts.append(_bytes(wd_p, n))
    zeros = torch.zeros(ce, dtype=torch.float32, device=dev)
    for b in (be if be is not None else zeros, bd):
        parts.append(_bytes(padded(b.reshape(-1), (cep,), torch.float32).reshape(n, CH), n))
    return PackedMBConv(torch.cat(parts, 1).reshape(-1), cin, ce, cout, kpad, coutp, n,
                        we is not None, dt)


def unpack_mbconv(p: PackedMBConv):
    """The padded weights back from the packed form: we [kpad, cep] (None
    without expand), be [cep], wd [3, 3, cep], bd [cep], wp [cep, coutp]."""
    n, kpad, coutp, dt = p.nchunks, p.kpad, p.coutp, p.dtype
    el = torch.empty((), dtype=dt).element_size()
    w = p.w.reshape(n, -1)
    off = 0

    def take(nbytes, dtype, shape):
        nonlocal off
        t = w[:, off:off + nbytes].contiguous().view(dtype).reshape(n, *shape)
        off += nbytes
        return t

    def uncores(t, rows, cols):  # [n, K/8, N/8, 8, 8] -> [n, N, K]
        return t.permute(0, 2, 3, 1, 4).reshape(n, rows, cols)

    we = None
    if p.expand:
        we = uncores(take(CH * kpad * el, dt, (kpad // 8, CH // 8, 8, 8)), CH, kpad)
        we = we.reshape(n * CH, kpad).t()
    wp = uncores(take(coutp * CH * el, dt, (CH // 8, coutp // 8, 8, 8)), coutp, CH)
    wp = wp.transpose(1, 2)[:, _K_INV].reshape(n * CH, coutp)
    wd = take(9 * CH * 4, torch.float32, (9, CH)).transpose(0, 1).reshape(9, n * CH)
    wd = wd.reshape(3, 3, -1).to(dt)
    be = take(CH * 4, torch.float32, (CH,)).reshape(-1)
    bd = take(CH * 4, torch.float32, (CH,)).reshape(-1)
    return we, (be if p.expand else None), wd, bd, wp


def reference_mbconv_packed(x, packed: PackedMBConv, bp, *, stride: int = 1,
                            residual: bool = False):
    """Plain PyTorch version over the packed weights, with all of the
    kernel's zero padding (Cin to kpad, Ce to whole chunks, Cout to a
    multiple of 24): the arithmetic of ``reference_mbconv`` on the padded
    problem, cut back to Cout."""
    we, be, wd, bd, wp = unpack_mbconv(packed)
    width = packed.kpad if packed.expand else wd.shape[-1]
    xin = F.pad(x, (0, width - packed.cin))
    bpp = F.pad(bp.reshape(-1).float(), (0, packed.coutp - packed.cout))
    y = _mbconv_sum(xin, we, be, wd, bd, wp, bpp, stride)[..., :packed.cout]
    if residual:
        y = y + x.float()
    return y.to(x.dtype)


# -- tile plan ---------------------------------------------------------------


def chunk_bytes(kpad: int, coutp: int, expand: bool, elem: int = 2) -> int:
    """Bytes of one packed chunk (``PackedMBConv``) with ``elem``-byte weights."""
    return (CH * kpad * elem if expand else 0) + coutp * CH * elem + 9 * CH * 4 + 2 * CH * 4


class KernelLayout(NamedTuple):
    kpad: int
    coutp: int
    hin: int
    win: int
    pin: int  # halo pixels of a tile: the expand GEMM's rows
    pinp: int  # ... padded to the wgmma M of 64
    x_bytes: int  # one input stage
    chunk_bytes: int
    smem: int  # dynamic shared memory of the launch


def kernel_layout(stride: int, th: int, tw: int, cin: int, cout: int, expand: bool,
                  xst: int, wst: int) -> KernelLayout:
    """Shared-memory layout of the bf16 kernel for a th x tw output tile
    (the same formulas as ``h_layout`` in csrc/mbconv.cu): barriers, xst
    input stages [kpad/8][pinp][8], wst weight stages, two expanded
    chunks [pin][CH + 8 (stride 1) or CH + 4 (stride 2)] bf16, and 128
    bytes to align the base."""
    kpad, coutp = _round_up(cin, 16), _round_up(cout, NBW)
    hin, win = (th - 1) * stride + 3, (tw - 1) * stride + 3
    pin = hin * win
    pinp = _round_up(pin, 64)
    x_bytes = kpad * pinp * 2
    cb = chunk_bytes(kpad, coutp, expand)
    smem = (BAR_BYTES + xst * x_bytes + wst * _round_up(cb, 128)
            + 2 * _round_up(pin * (CH + 8 if stride == 1 else CH + 4) * 2, 128) + 128)
    return KernelLayout(kpad, coutp, hin, win, pin, pinp, x_bytes, cb, smem)


class TilePlan(NamedTuple):
    th: int  # output tile rows
    tw: int  # output tile columns
    nc: int  # consumer warpgroups (64 output pixels each)
    xst: int  # input-tile stages
    wst: int  # weight-chunk stages
    smem: int  # dynamic shared memory, bytes
    items: int  # (image, tile) work items
    grid: int  # persistent CTAs
    ctas_per_sm: int


_STAGES = ((2, 3), (2, 2), (1, 2))  # (input, weight) stages, most first
# plan_tile's time model, in units of one 64-row expand block
EXPAND_COST, DEPTHWISE_COST, ITEM_COST, ONE_STAGE_COST = 1.0, 2.5, 2.0, 4.0


@functools.lru_cache(maxsize=None)
def plan_tile(h_out: int, w_out: int, stride: int, cin: int, ce: int, cout: int,
              expand: bool, batch: int, num_sms: int = 132) -> TilePlan:
    """The bf16 kernel's launch for one block shape: the output tile with
    the least modelled time per image, the most pipeline stages that fit
    227 KB of shared memory, and a persistent grid of as many CTAs as fit
    on ``num_sms`` SMs (by shared memory, registers and threads), at most
    one per work item.

    The model, fitted to a sweep of tiles at the 16 block shapes of
    MobileNetV2 x0.75 at b128 on an H100: the consumer warpgroups meet
    once per chunk, so a chunk takes as long as the warpgroup with the
    most 64-row expand blocks (``EXPAND_COST`` each) plus one depthwise
    and project (``DEPTHWISE_COST``); an item adds a fixed ``ITEM_COST``,
    and ``ONE_STAGE_COST`` more when only one input stage fits (the next
    tile's load then waits for this one); ties go to the smaller halo."""
    nchunks = -(-ce // CH)
    max_nc = max_warpgroups(cout)
    best, best_key = None, None
    for th in range(1, min(h_out, 64) + 1):
        # even widths: a thread's two GEMM rows are neighbouring pixels
        for tw in range(2, min(_round_up(w_out, 2), 64) + 1, 2):
            pout = th * tw
            if pout > 64 * max_nc:
                break
            nc = -(-pout // 64)
            for xst, wst in _STAGES:
                lay = kernel_layout(stride, th, tw, cin, cout, expand, xst, wst)
                if lay.smem <= SMEM_LIMIT and lay.win <= 256 and lay.hin <= 256:
                    break
            else:
                continue
            rounds = -(-(lay.pinp // 64) // nc) if expand else 0
            per_chunk = rounds * EXPAND_COST + DEPTHWISE_COST
            tiles = -(-h_out // th) * -(-w_out // tw)
            item = nchunks * per_chunk + ITEM_COST + (ONE_STAGE_COST if xst == 1 else 0.0)
            key = (tiles * item, lay.pin)
            if best_key is None or key < best_key:
                best, best_key = (th, tw, nc, xst, wst, lay.smem, tiles), key
    if best is None:
        raise ValueError(f"no tile of the bf16 kernel fits {h_out}x{w_out}, Cin={cin}, "
                         f"Cout={cout} in {SMEM_LIMIT} bytes of shared memory")
    th, tw, nc, xst, wst, smem, tiles = best
    threads = 128 * (nc + 1)  # consumer warpgroups and the producer warpgroup
    regs = 65536 // (128 * (max_nc + 1))  # per thread at launch, as compiled
    per_sm = max(1, min(SM_SHARED // (smem + 1024), 65536 // (threads * regs),
                        2048 // threads))
    items = batch * tiles
    return TilePlan(th, tw, nc, xst, wst, smem, items, min(items, num_sms * per_sm), per_sm)


def max_warpgroups(cout: int) -> int:
    """Consumer warpgroups the bf16 kernel takes: four while its project
    sums are small (Cout <= 48), else three (``max_nc`` in the source)."""
    return 4 if _round_up(cout, NBW) <= 2 * NBW else 3


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# -- the wrapper -------------------------------------------------------------


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
    packed: Optional[PackedMBConv] = None,
) -> torch.Tensor:
    """One fused block, [B, H, W, Cin] -> [B, H/stride, W/stride, Cout].

    A CPU tensor takes the plain version. A CUDA tensor launches a kernel
    (and adds one to ``fused_mbconv.launches``), or raises: bfloat16 the
    Hopper kernel, on ``packed`` (``pack_mbconv`` of these weights) or on
    weights packed for this call; float32 the CUDA-core kernel."""
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
    vec = 8 if x.dtype == torch.bfloat16 else 4
    if cin % vec or cout % 8:
        raise ValueError(f"the kernel needs Cin % {vec} == 0 and Cout % 8 == 0 for {x.dtype}, "
                         f"got Cin={cin}, Cout={cout}")
    if x.dtype == torch.bfloat16 and _round_up(cout, NBW) > NBW * MAX_NB:
        raise ValueError(f"the bf16 kernel takes Cout <= {NBW * MAX_NB}, got {cout}")
    lib = _lib()
    out = torch.empty((b, h // stride, w // stride, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.bfloat16:
        expand = we is not None
        if packed is None:
            packed = pack_mbconv(we, be, wd, bd, wp)
        elif ((packed.cin, packed.ce, packed.cout, packed.expand, packed.dtype)
              != (cin, ce, cout, expand, x.dtype) or packed.w.device != x.device):
            raise ValueError("packed weights do not belong to this block")
        plan = plan_tile(h // stride, w // stride, stride, cin, ce, cout, expand, b,
                         _num_sms(x.device.index if x.device.index is not None
                                  else torch.cuda.current_device()))
        rc = lib.yrt_mbconv_bf16(
            x.data_ptr(), packed.w.data_ptr(), bp.data_ptr(), out.data_ptr(), b, h, w, cin, ce,
            cout, packed.nchunks, stride, int(expand), int(residual), plan.th, plan.tw,
            plan.nc, plan.xst, plan.wst, plan.grid, plan.smem, stream)
    else:
        rc = lib.yrt_mbconv_f32(
            x.data_ptr(), None if we is None else we.data_ptr(),
            None if be is None else be.data_ptr(), wd.data_ptr(), bd.data_ptr(),
            wp.data_ptr(), bp.data_ptr(), out.data_ptr(),
            b, h, w, cin, ce, cout, stride, int(we is not None), int(residual), stream)
    if rc != 0:
        raise RuntimeError(f"mbconv kernel launch failed: {lib.yrt_error_string(rc).decode()}")
    fused_mbconv.launches += 1
    return out


fused_mbconv.launches = 0
