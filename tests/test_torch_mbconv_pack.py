"""Weight packing and tile plan of the Hopper MBConv kernel, on the CPU.

The bf16 kernel (``csrc/mbconv.cu``) reads weights packed once per model
(``pack_mbconv``) and takes its launch from ``plan_tile``; both are plain
Python and are held here without a GPU. The packed form must compute
what the unpacked weights compute: the plain version over the packed
weights, with all of the kernel's zero padding (Cin to 16, Ce to chunks
of 48, Cout to 24), equals ``reference_mbconv`` bit for bit. Maps are
small; channel widths are those of the real blocks.
"""

import numpy as np
import pytest
import torch

from yoloret_tpu_torch.nn import fused_infer
from yoloret_tpu_torch.nn.detector import YoloReT
from yoloret_tpu_torch.nn.mobilenetv2 import block_specs
from yoloret_tpu_torch.ops import mbconv as M

torch.set_num_threads(1)

PACK_CASES = [
    # (h, w, cin, ce, cout, stride, expand, residual)
    (6, 6, 24, 144, 24, 1, True, True),  # Ce 144: 3 chunks; Cin 24 -> kpad 32
    (6, 8, 24, 144, 48, 2, True, False),
    (5, 5, 72, 432, 72, 1, True, True),  # Ce 432: 9 chunks; Cin 72 -> kpad 80
    (6, 6, 72, 432, 120, 2, True, False),  # Cout 120
    (4, 4, 120, 720, 120, 1, True, True),  # Ce 720: 15 chunks; Cin 120 -> kpad 128
    (7, 5, 24, 24, 16, 1, False, False),  # no expand: Ce 24 is half a chunk; Cout 16 -> 24
    (6, 6, 16, 96, 24, 2, True, False),
    (5, 7, 8, 40, 8, 1, True, False),  # Ce 40: one ragged chunk
    # MobileNetV2 x1.4 (blocks 10, 13, 14): Cout 136 -> 144 and 224 -> 240
    (4, 4, 88, 528, 136, 1, True, False),
    (3, 3, 136, 816, 224, 2, True, False),  # Ce 816: 17 chunks
    (3, 3, 224, 1344, 224, 1, True, True),  # Ce 1344: 28 chunks
]


def _block(case, dtype, seed=0):
    h, w, cin, ce, cout, stride, expand, residual = case
    rs = np.random.RandomState(seed)

    def r(*shape, dt=dtype):
        return torch.from_numpy((rs.randn(*shape) * 0.2).astype(np.float32)).to(dt)

    x = torch.from_numpy(rs.rand(2, h * stride, w * stride, cin).astype(np.float32) - 0.5)
    we = r(cin, ce) if expand else None
    be = r(ce, dt=torch.float32) if expand else None
    return (x.to(dtype), we, be, r(3, 3, ce), r(ce, dt=torch.float32), r(ce, cout),
            r(cout, dt=torch.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PACK_CASES)
def test_packed_plain_version_equals_reference(case, dtype):
    stride, residual = case[5], case[7]
    x, we, be, wd, bd, wp, bp = _block(case, dtype)
    packed = M.pack_mbconv(we, be, wd, bd, wp)
    got = M.reference_mbconv_packed(x, packed, bp, stride=stride, residual=residual)
    want = M.reference_mbconv(x, we, be, wd, bd, wp, bp, stride=stride, residual=residual)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", PACK_CASES)
def test_packing_round_trips_and_pads_with_zeros(case):
    cin, ce, cout, expand = case[2], case[3], case[4], case[6]
    _, we, be, wd, bd, wp, _ = _block(case, torch.bfloat16)
    p = M.pack_mbconv(we, be, wd, bd, wp)
    assert p.w.dtype == torch.uint8 and p.nchunks == -(-ce // M.CH)
    assert (p.kpad, p.coutp) == (-(-cin // 16) * 16, -(-cout // M.NBW) * M.NBW)
    assert p.w.numel() == p.nchunks * M.chunk_bytes(p.kpad, p.coutp, expand)
    assert M.chunk_bytes(p.kpad, p.coutp, expand) % 16 == 0  # one bulk copy per chunk
    we2, be2, wd2, bd2, wp2 = M.unpack_mbconv(p)
    cep = p.nchunks * M.CH
    assert torch.equal(wd2[..., :ce], wd) and not wd2[..., ce:].any()
    assert torch.equal(bd2[:ce], bd) and not bd2[ce:].any()
    assert wp2.shape == (cep, p.coutp)
    assert torch.equal(wp2[:ce, :cout], wp) and not wp2[ce:].any() and not wp2[:, cout:].any()
    if expand:
        assert we2.shape == (p.kpad, cep)
        assert torch.equal(we2[:cin, :ce], we) and not we2[cin:].any() and not we2[:, ce:].any()
        assert torch.equal(be2[:ce], be) and not be2[ce:].any()
    else:
        assert we2 is None and be2 is None


def test_project_weights_follow_the_fragment_order():
    """Row k of each k16 step of the packed project operand is channel
    K_ORDER[k] of the step: a thread's A-fragment columns 2t, 2t+1, 2t+8,
    2t+9 are channels 4t..4t+3."""
    order = M.K_ORDER
    for t in range(4):
        assert [order[2 * t], order[2 * t + 1], order[2 * t + 8], order[2 * t + 9]] == \
            [4 * t, 4 * t + 1, 4 * t + 2, 4 * t + 3]
    ce, cout = 48, 24
    wp = torch.arange(ce * cout, dtype=torch.float32).reshape(ce, cout)
    p = M.pack_mbconv(None, None, torch.zeros(3, 3, ce), torch.zeros(ce), wp)
    raw = p.w[:cout * ce * 4].view(torch.float32).reshape(ce // 8, cout // 8, 8, 8)
    b = raw.permute(1, 2, 0, 3).reshape(cout, ce)  # [N][K] of the packed operand
    for k in range(ce):
        step, kk = divmod(k, 16)
        assert torch.equal(b[:, k], wp[16 * step + order[kk]])


def test_fused_params_packs_once_and_forwards_do_not_repack(monkeypatch):
    calls = []
    real = M.pack_mbconv

    def counting(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(fused_infer, "pack_mbconv", counting)
    monkeypatch.setattr(M, "pack_mbconv", counting)
    torch.manual_seed(0)
    model = YoloReT(dtype=torch.bfloat16).eval()
    params = fused_infer.fused_params(model)
    assert len(calls) == len(params.blocks) == 16
    assert all(b.packed is not None and b.packed.dtype == torch.bfloat16 for b in params.blocks)
    images = torch.rand(1, 64, 64, 3)
    fused_infer.fused_detector_apply(model, images, params)
    fused_infer.fused_detector_apply(model, images, params)
    assert len(calls) == 16
    # float32 models (the card's float32 checks) run the CUDA-core kernel, unpacked
    assert all(b.packed is None for b in fused_infer.fused_params(YoloReT().eval()).blocks)


def _block_shapes(size, alpha=0.75):
    """(h_out, w_out, stride, cin, ce, cout, expand) of the 16 blocks of
    MobileNetV2 x``alpha`` at a size x size input."""
    hw, out = size // 2, []
    for _, stride, t, cin, cout in block_specs(alpha):
        out.append((hw // stride, hw // stride, stride, cin, cin * t, cout, t != 1))
        hw //= stride
    return out


@pytest.mark.parametrize("batch", [1, 128])
@pytest.mark.parametrize("size", [320, 416, 224])  # last maps 10x10, 13x13, 7x7
def test_tile_plan_fits_shared_memory_and_wgmma_granularity(size, batch):
    _check_plans(_block_shapes(size), batch)


@pytest.mark.parametrize("size", [288, 352])  # last maps 9x9, 11x11
def test_tile_plan_at_the_multi_scale_sizes(size):
    """Multi-scale training's TensorBoard detections run the blocks at
    288 and 352 with a batch of tb_images rows (4 on the card)."""
    _check_plans(_block_shapes(size), 4)


@pytest.mark.parametrize("alpha,size", [(1.4, 224), (1.0, 320)])
@pytest.mark.parametrize("batch", [1, 8, 128])
def test_tile_plan_other_widths(alpha, size, batch):
    """The 16 blocks of MobileNetV2 x1.4 @224 (the COCO config: Cout up to
    224, Ce up to 1344, 7x7 maps) and x1.0 @320 fit too; x1.4's last
    blocks take one consumer warpgroup and one 7x8 tile per image."""
    shapes = _block_shapes(size, alpha)
    _check_plans(shapes, batch)
    if alpha == 1.4:
        assert [s[3:6] for s in shapes[13:]] == [(136, 816, 224), (224, 1344, 224),
                                                 (224, 1344, 224)]
        for shape in shapes[13:]:
            p = M.plan_tile(*shape, batch)
            assert (p.th, p.tw, p.nc, p.items) == (7, 8, 1, batch)
            assert p.smem <= M.SMEM_LIMIT and M._round_up(shape[5], M.NBW) // M.NBW == 10


def _check_plans(shapes, batch):
    for ho, wo, stride, cin, ce, cout, expand in shapes:
        p = M.plan_tile(ho, wo, stride, cin, ce, cout, expand, batch)
        lay = M.kernel_layout(stride, p.th, p.tw, cin, cout, expand, p.xst, p.wst)
        assert p.smem == lay.smem <= M.SMEM_LIMIT
        assert 1 <= p.nc <= M.max_warpgroups(cout) and p.th * p.tw <= 64 * p.nc
        assert p.tw % 2 == 0 and p.th <= ho and p.tw <= wo + 1  # even: neighbouring pixel pairs
        assert lay.pinp % 64 == 0 and lay.pinp >= lay.pin  # wgmma M of the expand
        assert lay.kpad % 16 == 0 and M.CH % 16 == 0  # wgmma K of expand and project
        assert M.CH % 8 == 0 and lay.coutp % M.NBW == 0 and M.NBW % 8 == 0  # wgmma N
        assert lay.hin <= 256 and lay.win <= 256  # TMA box
        assert (lay.pinp * 16) % 128 == 0 and lay.x_bytes % 128 == 0  # TMA destinations
        assert lay.chunk_bytes % 16 == 0  # bulk copy
        tiles = -(-ho // p.th) * -(-wo // p.tw)
        assert p.items == batch * tiles
        assert 1 <= p.grid <= min(p.items, 132 * p.ctas_per_sm)
        assert 1 <= p.xst <= 2 and 2 <= p.wst <= 3
