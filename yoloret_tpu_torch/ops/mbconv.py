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
227 KB a block may use. Past Cout 120 an instance holds exactly the
launch's accumulator blocks, two or three warpgroups fit the register
file, and a tile's chunks may be split among groups of warpgroups whose
partial sums are added in a fixed order (``_plan_wide``, ``wide_cost``).

float32 (``mbconv_f32``), the port's exact mode: the float32 evaluation
path (the self-check's verdict, the accuracy gate, the top-k study, every
``--no-bf16`` run). The same steps as fp32 FMAs with fp32 sums on the CUDA
cores, on weights packed once per model (``pack_mbconv_f32``, chunks of 32
expanded channels) and staged by ``cp.async`` a pipeline step ahead, one
barrier a step. ``plan_tile_f32`` chooses the output tile, the pixels per
thread and, where the (tile, image) pairs leave SMs idle, a thread-block
cluster of up to 8 CTAs per pair: each runs the expand and depthwise of a
share of the chunks, then the project of a slice of Cout over all chunks,
in order, so every plan gives the same bits.

Block semantics, BN folded into the weights (``nn/fused_infer.fold_bn``):
expand 1x1 + ReLU6 -> depthwise 3x3 "SAME" + ReLU6 -> project 1x1
[+ residual]. Stride-2 "SAME" pads (0, 1) on an even input. Arithmetic is
float32, rounded to the input dtype after the expand, after the
depthwise and at the output, as the JAX kernel rounds. The kernels take
Cin and Cout multiples of 8 (bfloat16; float32 Cin % 4), Cout <= 264 in
bfloat16; every block of MobileNetV2 x0.75, x1.0 and x1.4 fits.

Layouts, as in the JAX kernel: x [B, H, W, Cin]; we [Cin, Ce] (None
without expand); wd [3, 3, Ce]; wp [Ce, Cout] in x's dtype; biases be
[Ce], bd [Ce], bp [Cout] (or [1, C]) float32.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from collections import Counter
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from yoloret_tpu_torch.device import on_device
from yoloret_tpu_torch.nn.layers import relu6, same_padding
from yoloret_tpu_torch.ops import _build

_vp, _ci = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {
    "yrt_mbconv_f32": ([_vp] * 4 + [_ci] * 16 + [_vp], _ci),
    "yrt_mbconv_bf16": ([_vp] * 4 + [_ci] * 18 + [_vp], _ci),
    "yrt_error_string": ([_ci], ctypes.c_char_p),
}

# The Hopper kernel's constants (csrc/mbconv.cu).
CH = 48  # expanded channels per chunk: the expand wgmma's N, the project's K
NBW = 24  # project wgmma N per instruction; Cout is padded to a multiple
MAX_NB = 11  # project accumulator blocks: Cout <= 264
WIDE_NB = 6  # from here on an instance holds exactly the launch's blocks
SMEM_LIMIT = 232448  # 227 KB, what one block may use on sm_90
SM_SHARED = 233472  # 228 KB of shared memory per SM, 1 KB reserved per block
BAR_BYTES = 128
# The float32 kernel's constants.
F32_CH = 32  # expanded channels per chunk
F32_NT = 256  # threads per CTA
F32_DS = F32_CH + 1  # row stride of the depthwise chunk
F32_MAX_TILE = 16  # output tile side
F32_MAX_CLUSTER = 8  # CTAs of a cluster (the portable limit)
F32_BG = 4  # chunks a step of a cluster's project
F32_MAX_UNITS = 4  # project units (1 pixel x 4 channels) a thread, with a cluster


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
    layout: str = "wgmma"  # "wgmma": the bf16 kernel's; "f32": pack_mbconv_f32's


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
    return _packed_wgmma(torch.cat(parts, 1).reshape(-1), we, wd, wp)


def _packed_wgmma(w, we, wd, wp) -> PackedMBConv:
    ce, cout = wd.shape[-1], wp.shape[-1]
    cin = we.shape[0] if we is not None else ce
    return PackedMBConv(w, cin, ce, cout, _round_up(cin, 16), _round_up(cout, NBW),
                        -(-ce // CH), we is not None, wd.dtype)


def pack_mbconv_f32(we, be, wd, bd, wp) -> PackedMBConv:
    """Pack one block's float32 folded weights once, on their device, for
    ``mbconv_f32``: ``w`` is uint8 [nchunks, chunk bytes], chunk c holding,
    for expanded channels [32c, 32c + 32), float32 each and in this order:
    the expand weights [Cin][32] and bias [32] (only with expand), the
    depthwise weights [9 taps][32] and bias [32], and the project weights
    [32][Cout]. Ce is padded to whole chunks with zero weights and biases
    (a padded channel is relu6(0) = 0 and adds nothing to the project);
    Cin and Cout are not padded. Each part is a multiple of 16 bytes, so
    the kernel stages a chunk's parts by 16-byte copies."""
    ce, cout = wd.shape[-1], wp.shape[-1]
    cin = we.shape[0] if we is not None else ce
    dev = wd.device
    n = -(-ce // F32_CH)

    def chunked(t, rows):  # [rows, ce] -> [n, rows * 32], Ce padded with zeros
        out = torch.zeros((rows, n * F32_CH), dtype=torch.float32, device=dev)
        out[:, :ce] = t.reshape(rows, ce).float()
        return out.reshape(rows, n, F32_CH).transpose(0, 1).reshape(n, -1)

    parts = [chunked(we, cin), chunked(be, 1)] if we is not None else []
    parts += [chunked(wd, 9), chunked(bd, 1), chunked(wp.t(), cout).reshape(n, cout, F32_CH)
              .transpose(1, 2).reshape(n, -1)]
    w = torch.cat(parts, 1).contiguous().view(torch.uint8).reshape(-1)
    return packed_like(w, we, wd, wp)


def packed_like(w: torch.Tensor, we, wd, wp) -> PackedMBConv:
    """The ``PackedMBConv`` of the packed bytes ``w`` of the block whose
    weights are (we, wd, wp): its ints follow from their shapes, its
    layout from their dtype (float32: ``pack_mbconv_f32``'s; else
    ``pack_mbconv``'s)."""
    if wd.dtype != torch.float32:
        return _packed_wgmma(w, we, wd, wp)
    ce, cout = wd.shape[-1], wp.shape[-1]
    cin = we.shape[0] if we is not None else ce
    return PackedMBConv(w, cin, ce, cout, cin, cout, -(-ce // F32_CH), we is not None,
                        torch.float32, "f32")


def _unpack_f32(p: PackedMBConv):
    n, cin, cout = p.nchunks, p.cin, p.cout
    w = p.w.view(torch.float32).reshape(n, -1)
    off = 0

    def take(rows):  # [n, rows * 32] -> [rows, n * 32]
        nonlocal off
        t = w[:, off:off + rows * F32_CH].reshape(n, rows, F32_CH)
        off += rows * F32_CH
        return t.transpose(0, 1).reshape(rows, n * F32_CH)

    we = be = None
    if p.expand:
        we, be = take(cin), take(1).reshape(-1)
    wd = take(9).reshape(3, 3, -1)
    bd = take(1).reshape(-1)
    wp = w[:, off:].reshape(n * F32_CH, cout)  # [32][Cout] a chunk
    return we, be, wd, bd, wp


def unpack_mbconv(p: PackedMBConv):
    """The padded weights back from the packed form: we [kpad, cep] (None
    without expand), be [cep], wd [3, 3, cep], bd [cep], wp [cep, coutp]
    (the float32 layout pads only Ce: kpad = Cin, coutp = Cout)."""
    if p.layout == "f32":
        return _unpack_f32(p)
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
                  xst: int, wst: int, ks: int = 1) -> KernelLayout:
    """Shared-memory layout of the bf16 kernel for a th x tw output tile
    (the same formulas as ``h_layout`` in csrc/mbconv.cu): barriers, xst
    input stages [kpad/8][pinp][8], wst weight stages, expanded chunks
    [pin][CH + 8 (stride 1) or CH + 4 (stride 2)] bf16 (two, or with ks > 1
    chunk groups one a group), and 128 bytes to align the base."""
    kpad, coutp = _round_up(cin, 16), _round_up(cout, NBW)
    hin, win = (th - 1) * stride + 3, (tw - 1) * stride + 3
    pin = hin * win
    pinp = _round_up(pin, 64)
    x_bytes = kpad * pinp * 2
    cb = chunk_bytes(kpad, coutp, expand)
    smem = (BAR_BYTES + xst * x_bytes + wst * _round_up(cb, 128)
            + max(2, ks) * _round_up(pin * (CH + 8 if stride == 1 else CH + 4) * 2, 128) + 128)
    return KernelLayout(kpad, coutp, hin, win, pin, pinp, x_bytes, cb, smem)


def red_bytes(nc: int, ks: int, cout: int) -> int:
    """Bytes of the partial sums of chunk groups 1..ks-1, which the
    reduction writes over the weight ring (``red_bytes`` in the source)."""
    return (ks - 1) * (nc // ks) * 128 * (_round_up(cout, NBW) // NBW) * 12 * 4


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
    ks: int = 1  # chunk groups: nc // ks warpgroups each, a share of the chunks


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
    tile's load then waits for this one); ties go to the smaller halo.
    Past Cout 120 (``WIDE_NB`` accumulator blocks) ``_plan_wide`` plans."""
    if _round_up(cout, NBW) // NBW >= WIDE_NB:
        return _plan_wide(h_out, w_out, stride, cin, ce, cout, expand, batch, num_sms)
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
    per_sm = _ctas_per_sm(smem, nc, max_nc)
    items = batch * tiles
    return TilePlan(th, tw, nc, xst, wst, smem, items, min(items, num_sms * per_sm), per_sm)


# _plan_wide's time model of one launch, in units of 0.30 us, fitted to the
# block times of every plan of x1.4 @224's and x1.0 @320's wide blocks at
# b128 on an H100 (tools/mbconv_ablation.py --plans; 653 launches,
# log-error 8.2% rms): a group's chunk takes its rounds of 64-row expand
# blocks (WIDE_EXPAND_K per k16 step of one) and the depthwise and project
# (WIDE_CHUNK); the consumer warpgroups of a CTA share one SM, so each
# further one slows every chunk by WIDE_SHARE; an item adds WIDE_ITEM, and
# WIDE_ONE_STAGE with one input stage when the CTA takes more than one
# item. A launch takes its CTAs' rounds of items. (The project's width and
# the chunk groups' reduction fitted to no cost.) It picks the fastest
# measured plan at four of the six shapes, and one within 1.6% and 3.5% of
# it on the 14x14 maps, where the best five plans lie within 4%.
WIDE_EXPAND_K, WIDE_CHUNK, WIDE_SHARE, WIDE_ITEM, WIDE_ONE_STAGE = 0.268, 3.73, 0.358, 25.2, 16.5


def wide_cost(h_out: int, w_out: int, stride: int, cin: int, ce: int, cout: int, expand: bool,
              batch: int, th: int, tw: int, nc: int, ks: int, xst: int, wst: int,
              num_sms: int = 132) -> float:
    """``_plan_wide``'s modelled time of one launch under a plan."""
    lay = kernel_layout(stride, th, tw, cin, cout, expand, xst, wst, ks)
    rounds = -(-(lay.pinp // 64) // (nc // ks)) if expand else 0
    chunk = (rounds * WIDE_EXPAND_K * lay.kpad / 16 + WIDE_CHUNK) * (1 + WIDE_SHARE * (nc - 1))
    items = batch * -(-h_out // th) * -(-w_out // tw)
    per_cta = -(-items // min(items, num_sms * _ctas_per_sm(lay.smem, nc, max_warpgroups(cout))))
    nchunks = -(-ce // CH)
    item = (-(-nchunks // ks) * chunk + WIDE_ITEM
            + (WIDE_ONE_STAGE if xst == 1 and per_cta > 1 else 0.0))
    return per_cta * item


def wide_plans(h_out: int, w_out: int, stride: int, cin: int, ce: int, cout: int, expand: bool,
               batch: int, num_sms: int = 132):
    """Every launch the wide instances take for one block shape, with its
    ``wide_cost``: (cost, plan) for each tile, warpgroups and chunk groups,
    with the most pipeline stages that fit (with chunk groups, no more
    weight stages than chunks, and room in them for the groups' partial
    sums)."""
    nchunks = -(-ce // CH)
    max_nc = max_warpgroups(cout)
    for th in range(1, min(h_out, 64) + 1):
        for tw in range(2, min(_round_up(w_out, 2), 64) + 1, 2):
            nm = -(-(th * tw) // 64)
            if nm > max_nc:
                break
            for ks in range(1, min(max_nc // nm, nchunks) + 1):
                nc = nm * ks
                for xst, wst in ((2, 3), (1, 3), (2, 2), (1, 2)):
                    lay = kernel_layout(stride, th, tw, cin, cout, expand, xst, wst, ks)
                    if (lay.smem <= SMEM_LIMIT and lay.win <= 256 and lay.hin <= 256
                            and (ks == 1 or (wst <= nchunks and red_bytes(nc, ks, cout)
                                             <= wst * _round_up(lay.chunk_bytes, 128)))):
                        break
                else:
                    continue
                items = batch * -(-h_out // th) * -(-w_out // tw)
                per_sm = _ctas_per_sm(lay.smem, nc, max_nc)
                yield (wide_cost(h_out, w_out, stride, cin, ce, cout, expand, batch, th, tw, nc,
                                 ks, xst, wst, num_sms),
                       TilePlan(th, tw, nc, xst, wst, lay.smem, items,
                                min(items, num_sms * per_sm), per_sm, ks))


def _plan_wide(h_out, w_out, stride, cin, ce, cout, expand, batch, num_sms) -> TilePlan:
    """``plan_tile`` past Cout 120: the instance holds exactly the launch's
    accumulator blocks and at most ``max_warpgroups(cout)`` consumer
    warpgroups, which may split the tile's chunks among ks groups (each
    group nc / ks warpgroups of 64 rows; the partial sums added in group
    order). Of ``wide_plans`` the least ``wide_cost``, then the smaller
    halo, then the fewer warpgroups."""
    def key(cp):
        cost, p = cp
        return cost, ((p.th - 1) * stride + 3) * ((p.tw - 1) * stride + 3), p.nc

    best = min(wide_plans(h_out, w_out, stride, cin, ce, cout, expand, batch, num_sms), key=key,
               default=None)
    if best is None:
        raise ValueError(f"no tile of the bf16 kernel fits {h_out}x{w_out}, Cin={cin}, "
                         f"Cout={cout} in {SMEM_LIMIT} bytes of shared memory")
    return best[1]


def _ctas_per_sm(smem: int, nc: int, max_nc: int) -> int:
    """CTAs of a launch one SM holds, by shared memory, registers (each
    thread has what the instance was compiled for: the register file over
    its most threads) and threads."""
    threads = 128 * (nc + 1)  # consumer warpgroups and the producer warpgroup
    regs = 65536 // (128 * (max_nc + 1))
    return max(1, min(SM_SHARED // (smem + 1024), 65536 // (threads * regs), 2048 // threads))


def max_warpgroups(cout: int) -> int:
    """Consumer warpgroups the bf16 kernel takes: four while its project
    sums are small (Cout <= 48), three up to Cout 144, else two (``max_nc``
    in the source: the register file holds no more accumulators)."""
    nb = _round_up(cout, NBW) // NBW
    return 4 if nb <= 2 else 3 if nb <= WIDE_NB else 2


class F32Layout(NamedTuple):
    win: int
    hin: int
    pin: int  # halo pixels of a tile
    pout: int
    poutp: int  # ... padded to whole rq groups
    xs: int  # row stride of the input tile in floats, = 8 (mod 16)
    chunk_bytes: int  # one packed chunk (``pack_mbconv_f32``)
    nloc: int  # with a cluster: the chunks a CTA holds at most
    slice: int  # with a cluster: the project channels a CTA takes at most
    smem: int  # dynamic shared memory of the launch


def kernel_layout_f32(stride: int, th: int, tw: int, rq: int, cin: int, cout: int,
                      expand: bool, cluster: int, nchunks: int = 1) -> F32Layout:
    """Shared-memory layout of ``mbconv_f32`` for a th x tw output tile (the
    same formulas as ``f_layout`` in csrc/mbconv.cu). Without a cluster:
    the input tile [pin][xs], two expanded chunks [pin][32], two
    depthwise chunks [poutp][33] and two stages of each weight part
    (expand, depthwise, project). With one: the input tile, the CTA's
    depthwise chunks [nloc][poutp][32] (read by the whole cluster), two
    expanded chunks and the expand and depthwise rings; the project's two
    stages of F32_BG depthwise chunks [pout][32] and project-weight slices
    [32][slice] alias everything after the depthwise chunks."""
    win, hin = (tw - 1) * stride + 3, (th - 1) * stride + 3
    pin, pout = hin * win, th * tw
    poutp = _round_up(pout, rq)
    xs = cin + (24 - cin % 16) % 16
    e_part = (cin + 1) * F32_CH if expand else 0
    d_part, p_part = 10 * F32_CH, F32_CH * cout
    nloc = -(-nchunks // cluster)
    slice_ = -(-(cout // 8) // cluster) * 8
    x_end = _round_up(pin * xs * 4, 16)
    if cluster == 1:
        d = x_end + 2 * pin * F32_CH * 4
        total = _round_up(d + 2 * poutp * F32_DS * 4, 16) + 2 * 4 * (e_part + d_part + p_part)
    else:
        e = x_end + nloc * poutp * F32_CH * 4
        rings_end = e + 2 * pin * F32_CH * 4 + 2 * 4 * (e_part + d_part)
        b_end = e + 2 * F32_BG * pout * F32_CH * 4 + 2 * F32_BG * F32_CH * slice_ * 4
        total = max(rings_end, b_end)
    return F32Layout(win, hin, pin, pout, poutp, xs, 4 * (e_part + d_part + p_part), nloc,
                     slice_, total)


class F32Plan(NamedTuple):
    th: int  # output tile rows
    tw: int  # output tile columns
    rq: int  # project pixels per thread
    px: int  # expand pixels per thread
    cluster: int  # CTAs per (tile, image), each a share of the chunks
    smem: int  # dynamic shared memory, bytes
    tiles: int  # tiles per image
    ctas: int  # the grid: batch x tiles x cluster
    ctas_per_sm: int


# plan_tile_f32's time model, fitted to the kernel's block times at the
# four float32 shapes of tools/mbconv_f32_bench.py on an H100 (63 blocks;
# log-error 1.21x rms): cycles per instruction of a CTA's busiest thread
# (latency, few warps an SM), cycles per shared-memory wavefront of all
# its warps (throughput: a warp's 16-byte load takes four), instructions
# of a pipeline step's barrier and copies, of a cluster's barriers and
# first remote reads. Plans it ranks within ~10% of each other are a toss
# (it ranks 13 of 24 measured pairs right)
F32_LAT, F32_LSU, F32_STEP_COST, F32_CLUSTER_COST = 5.35, 1.14, 847, 1504


def _rq(pout: int, cout: int) -> Optional[int]:
    """The fewest project pixels per thread whose owners fit the CTA."""
    for rq in (1, 2, 4):
        if _round_up(pout, rq) // rq * (cout // 8) <= F32_NT:
            return rq
    return None


def f32_units(th: int, tw: int, cout: int, cluster: int) -> int:
    """Project units (1 pixel x 4 channels) of the busiest CTA of a cluster."""
    return th * tw * -(-(cout // 8) // cluster) * 2


def f32_cycles(h_out: int, w_out: int, stride: int, cin: int, ce: int, cout: int, expand: bool,
               batch: int, th: int, tw: int, rq: int, px: int, cluster: int,
               num_sms: int = 132) -> float:
    """``plan_tile_f32``'s modelled cycles of one launch under a plan.

    A CTA runs ceil(chunks / cluster) pipeline steps and one or two to
    drain. Each step's busiest thread runs its rounds of expand items (px
    pixels x 4 channels: per 4 inputs, 4 + px 16-byte loads and 16 px
    FMAs), of depthwise pixels and, without a cluster, one owner's
    project (32 channels x (2 + 9 rq)); with one, the project follows in
    steps of F32_BG chunks over all chunks, ceil(units / 256) units (32 x
    (2 loads + 4 FMAs) a chunk) a thread. All of a CTA's warps together
    issue the shared-memory wavefronts of those loads (a 16-byte load of a
    warp is four). An SM holding k CTAs (up to two, by shared memory)
    takes the larger of the busiest thread's instructions x F32_LAT and k
    x the wavefronts x F32_LSU; the launch takes its waves of CTAs over
    ``num_sms`` SMs."""
    n = -(-ce // F32_CH)
    lay = kernel_layout_f32(stride, th, tw, rq, cin, cout, expand, cluster, n)
    steps = -(-n // cluster)
    npix = min(lay.hin, h_out * stride) * min(lay.win, w_out * stride)
    items = -(-npix // px) * 8
    if expand:
        e_inst = -(-items // F32_NT) * (cin / 4 * (4 + 17 * px) + 30)
        e_lsu = -(-items // 32) * cin / 4 * (16 + 4 * px)
    else:
        e_inst, e_lsu = -(-items // F32_NT) * 20, -(-items // 32) * 10
    d_inst, d_lsu = -(-lay.poutp // 8) * 25, lay.poutp * 11
    if cluster == 1:
        p_inst = F32_CH * (2 + 9 * rq)
        p_lsu = -(-(lay.poutp // rq * (cout // 8)) // 32) * F32_CH * (8 + rq)
        inst = steps * (e_inst + d_inst + p_inst + F32_STEP_COST) + 2 * (
            d_inst + p_inst + F32_STEP_COST)
        lsu = steps * (e_lsu + d_lsu + p_lsu + F32_STEP_COST) + 2 * (
            d_lsu + p_lsu + F32_STEP_COST)
    else:
        units = f32_units(th, tw, cout, cluster)
        b_steps = -(-n // F32_BG)
        inst = (steps * (e_inst + d_inst + F32_STEP_COST) + d_inst + F32_STEP_COST
                + F32_CLUSTER_COST + b_steps * (-(-units // F32_NT) * F32_BG * F32_CH * 6
                                                + F32_STEP_COST))
        lsu = (steps * (e_lsu + d_lsu + F32_STEP_COST) + d_lsu + F32_STEP_COST
               + F32_CLUSTER_COST + b_steps * (-(-units // 32) * F32_BG * F32_CH * 5
                                               + F32_STEP_COST))
    ctas = batch * -(-h_out // th) * -(-w_out // tw) * cluster
    per_sm = min(2, SM_SHARED // (lay.smem + 1024))
    k, waves = min(per_sm, -(-ctas // num_sms)), -(-ctas // (num_sms * per_sm))
    return waves * max(inst * F32_LAT, k * lsu * F32_LSU)


@functools.lru_cache(maxsize=None)
def plan_tile_f32(h_out: int, w_out: int, stride: int, cin: int, ce: int, cout: int,
                  expand: bool, batch: int, num_sms: int = 132) -> F32Plan:
    """The float32 kernel's launch for one block shape: the output tile
    (sides up to 16), the project pixels per thread (without a cluster the
    fewest whose owners fit 256 threads; with one, 1), the expand pixels
    per thread (1, 2 or 4) and the cluster, with the fewest modelled
    cycles (``f32_cycles``); ties go to the smaller halo, then the fewer
    pixels per thread.

    The cluster fills the card: where batch x tiles (tile, image) pairs
    are fewer than ``num_sms``, each pair takes ceil(num_sms / pairs) CTAs,
    at most 8 and at most one per chunk of 32 expanded channels, each a
    contiguous share of the chunks and a slice of Cout; with enough pairs
    it is 1. A tile whose slices take more than F32_MAX_UNITS project
    units a thread is left out."""
    n = -(-ce // F32_CH)
    best, best_key = None, None
    for th in range(1, min(h_out, F32_MAX_TILE) + 1):
        for tw in range(1, min(w_out, F32_MAX_TILE) + 1):
            tiles = -(-h_out // th) * -(-w_out // tw)
            cluster = max(1, min(F32_MAX_CLUSTER, n, -(-num_sms // (batch * tiles))))
            if cluster == 1:
                rq = _rq(th * tw, cout)
                if rq is None:
                    continue
            else:
                rq = 1
                if f32_units(th, tw, cout, cluster) > F32_MAX_UNITS * F32_NT:
                    continue
            lay = kernel_layout_f32(stride, th, tw, rq, cin, cout, expand, cluster, n)
            if lay.smem > SMEM_LIMIT:
                continue
            for px in (1, 2, 4):
                key = (f32_cycles(h_out, w_out, stride, cin, ce, cout, expand, batch, th, tw, rq,
                                  px, cluster, num_sms), lay.pin, px)
                if best_key is None or key < best_key:
                    best_key = key
                    best = F32Plan(th, tw, rq, px, cluster, lay.smem, tiles,
                                   batch * tiles * cluster,
                                   min(2, SM_SHARED // (lay.smem + 1024)))
    if best is None:
        raise ValueError(f"no tile of the float32 kernel fits {h_out}x{w_out}, Cin={cin}, "
                         f"Cout={cout} in {SMEM_LIMIT} bytes of shared memory")
    return best


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
    (and adds one to ``fused_mbconv.launches`` and to
    ``fused_mbconv.kernel_launches`` under the kernel's name), or raises:
    bfloat16 the Hopper kernel ``mbconv_wgmma``, float32 the CUDA-core
    kernel ``mbconv_f32``, each on ``packed`` (``pack_mbconv`` /
    ``pack_mbconv_f32`` of these weights) or on weights packed for this
    call."""
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
    expand = we is not None
    layout = "wgmma" if x.dtype == torch.bfloat16 else "f32"
    if packed is None:
        packed = (pack_mbconv if layout == "wgmma" else pack_mbconv_f32)(we, be, wd, bd, wp)
    elif ((packed.cin, packed.ce, packed.cout, packed.expand, packed.dtype, packed.layout)
          != (cin, ce, cout, expand, x.dtype, layout) or packed.w.device != x.device):
        raise ValueError("packed weights do not belong to this block")
    num_sms = _num_sms(x.device.index if x.device.index is not None
                       else torch.cuda.current_device())
    if x.dtype == torch.bfloat16:
        plan = plan_tile(h // stride, w // stride, stride, cin, ce, cout, expand, b, num_sms)
        with on_device(x.device):
            rc = lib.yrt_mbconv_bf16(
                x.data_ptr(), packed.w.data_ptr(), bp.data_ptr(), out.data_ptr(), b, h, w, cin,
                ce, cout, packed.nchunks, stride, int(expand), int(residual), plan.th, plan.tw,
                plan.nc, plan.ks, plan.xst, plan.wst, plan.grid, plan.smem, stream)
    else:
        plan = plan_tile_f32(h // stride, w // stride, stride, cin, ce, cout, expand, b,
                             num_sms)
        with on_device(x.device):
            rc = lib.yrt_mbconv_f32(
                x.data_ptr(), packed.w.data_ptr(), bp.data_ptr(), out.data_ptr(), b, h, w, cin,
                ce, cout, packed.nchunks, stride, int(expand), int(residual), plan.th, plan.tw,
                plan.rq, plan.px, plan.cluster, plan.smem, stream)
    if rc != 0:
        raise RuntimeError(f"mbconv kernel launch failed: {lib.yrt_error_string(rc).decode()}")
    with _count_lock:  # row shards launch from threads of their own
        fused_mbconv.launches += 1
        fused_mbconv.kernel_launches["mbconv_wgmma" if x.dtype == torch.bfloat16
                                     else "mbconv_f32"] += 1
    return out


_count_lock = threading.Lock()
fused_mbconv.launches = 0
fused_mbconv.kernel_launches = Counter()
