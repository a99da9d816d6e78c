"""Weight packing and tile plan of the Hopper MBConv kernel, on the CPU.

The bf16 kernel (``csrc/mbconv.cu``) reads weights packed once per model
(``pack_mbconv``) and takes its launch from ``plan_tile``; both are plain
Python and are held here without a GPU. The packed form must compute
what the unpacked weights compute: the plain version over the packed
weights, with all of the kernel's zero padding (Cin to 16, Ce to chunks
of 48, Cout to 24), equals ``reference_mbconv`` bit for bit. Past Cout
120 a numpy model holds the chunk groups' split and fixed-order reduction
against it, and a model of the weight ring's protocol shows that the
partial sums overwrite no stage still in use. The flagship's 16 plans are
pinned. Maps are small; channel widths are those of the real blocks.
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
    # float32 models run the CUDA-core kernel on weights packed once for it
    f32 = fused_infer.fused_params(YoloReT().eval()).blocks
    assert len(calls) == 16  # (not through pack_mbconv)
    assert all(b.packed is not None and (b.packed.dtype, b.packed.layout) ==
               (torch.float32, "f32") for b in f32)


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
    blocks (Cout 224: the instance of exactly 10 accumulator blocks, two
    consumer warpgroups) split their 17 or 28 chunks between the two
    warpgroups, at b128 on one 7x8 tile per image."""
    shapes = _block_shapes(size, alpha)
    _check_plans(shapes, batch)
    if alpha == 1.4:
        assert [s[3:6] for s in shapes[13:]] == [(136, 816, 224), (224, 1344, 224),
                                                 (224, 1344, 224)]
        for shape in shapes[13:]:
            p = M.plan_tile(*shape, batch)
            assert (p.nc, p.ks) == (2, 2)
            if batch == 128:
                assert (p.th, p.tw, p.items) == (7, 8, batch)
            assert p.smem <= M.SMEM_LIMIT and M._round_up(shape[5], M.NBW) // M.NBW == 10


# MobileNetV2 x0.75 @320's 16 bf16 plans at b1, b8 and b128, as the kernel's
# first redesign chose them: (th, tw, nc, xst, wst, smem, items, grid,
# ctas_per_sm), no chunk groups. The wide blocks' plans must not move them.
FLAGSHIP_PLANS = {
    1: [
        (16, 16, 4, 2, 3, 135552, 100, 100, 1), (10, 16, 3, 2, 3, 207744, 40, 40, 1),
        (16, 16, 4, 2, 3, 144768, 25, 25, 1), (8, 20, 3, 1, 2, 205568, 10, 10, 1),
        (6, 40, 4, 2, 3, 147328, 7, 7, 1), (6, 40, 4, 2, 3, 147328, 7, 7, 1),
        (7, 20, 3, 2, 2, 229888, 3, 3, 1), (10, 20, 4, 2, 3, 155008, 2, 2, 1),
        (10, 20, 4, 2, 3, 155008, 2, 2, 1), (10, 20, 4, 2, 3, 155008, 2, 2, 1),
        (7, 20, 3, 2, 3, 135040, 3, 3, 1), (7, 20, 3, 2, 3, 177024, 3, 3, 1),
        (7, 20, 3, 2, 3, 177024, 3, 3, 1), (10, 10, 2, 1, 2, 206592, 1, 1, 1),
        (10, 10, 2, 2, 3, 208768, 1, 1, 1), (10, 10, 2, 2, 3, 208768, 1, 1, 1),
    ],
    8: [
        (16, 16, 4, 2, 3, 135552, 800, 132, 1), (10, 16, 3, 2, 3, 207744, 320, 132, 1),
        (16, 16, 4, 2, 3, 144768, 200, 132, 1), (8, 20, 3, 1, 2, 205568, 80, 80, 1),
        (6, 40, 4, 2, 3, 147328, 56, 56, 1), (6, 40, 4, 2, 3, 147328, 56, 56, 1),
        (7, 20, 3, 2, 2, 229888, 24, 24, 1), (10, 20, 4, 2, 3, 155008, 16, 16, 1),
        (10, 20, 4, 2, 3, 155008, 16, 16, 1), (10, 20, 4, 2, 3, 155008, 16, 16, 1),
        (7, 20, 3, 2, 3, 135040, 24, 24, 1), (7, 20, 3, 2, 3, 177024, 24, 24, 1),
        (7, 20, 3, 2, 3, 177024, 24, 24, 1), (10, 10, 2, 1, 2, 206592, 8, 8, 1),
        (10, 10, 2, 2, 3, 208768, 8, 8, 1), (10, 10, 2, 2, 3, 208768, 8, 8, 1),
    ],
    128: [
        (16, 16, 4, 2, 3, 135552, 12800, 132, 1), (10, 16, 3, 2, 3, 207744, 5120, 132, 1),
        (16, 16, 4, 2, 3, 144768, 3200, 132, 1), (8, 20, 3, 1, 2, 205568, 1280, 132, 1),
        (6, 40, 4, 2, 3, 147328, 896, 132, 1), (6, 40, 4, 2, 3, 147328, 896, 132, 1),
        (7, 20, 3, 2, 2, 229888, 384, 132, 1), (10, 20, 4, 2, 3, 155008, 256, 132, 1),
        (10, 20, 4, 2, 3, 155008, 256, 132, 1), (10, 20, 4, 2, 3, 155008, 256, 132, 1),
        (7, 20, 3, 2, 3, 135040, 384, 132, 1), (7, 20, 3, 2, 3, 177024, 384, 132, 1),
        (7, 20, 3, 2, 3, 177024, 384, 132, 1), (10, 10, 2, 1, 2, 206592, 128, 128, 1),
        (10, 10, 2, 2, 3, 208768, 128, 128, 1), (10, 10, 2, 2, 3, 208768, 128, 128, 1),
    ],
}


@pytest.mark.parametrize("batch", sorted(FLAGSHIP_PLANS))
def test_flagship_plans_pinned(batch):
    """The serving path's 16 bf16 launches (x0.75 @320) keep their plans:
    the instances of 2 and 5 accumulator blocks, no chunk groups."""
    got = [M.plan_tile(*shape, batch) for shape in _block_shapes(320)]
    assert [tuple(p)[:9] for p in got] == FLAGSHIP_PLANS[batch]
    assert all(p.ks == 1 for p in got)
    assert all(M._round_up(s[5], M.NBW) // M.NBW <= 5 for s in _block_shapes(320))


def _check_plans(shapes, batch):
    for ho, wo, stride, cin, ce, cout, expand in shapes:
        p = M.plan_tile(ho, wo, stride, cin, ce, cout, expand, batch)
        lay = M.kernel_layout(stride, p.th, p.tw, cin, cout, expand, p.xst, p.wst, p.ks)
        nchunks, nb = -(-ce // M.CH), lay.coutp // M.NBW
        assert p.smem == lay.smem <= M.SMEM_LIMIT
        assert 1 <= p.nc <= M.max_warpgroups(cout) and p.nc % p.ks == 0
        assert p.th * p.tw <= 64 * (p.nc // p.ks)  # each group covers the tile's rows
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
        if nb < M.WIDE_NB:
            assert p.ks == 1
        if p.ks > 1:  # the ring holds one of the last wst chunks a stage, and the partial sums
            assert nb >= M.WIDE_NB and p.wst <= nchunks and p.ks <= nchunks
            assert M.red_bytes(p.nc, p.ks, cout) <= p.wst * M._round_up(lay.chunk_bytes, 128)


# -- the wide bf16 instances: chunk groups and their reduction ------------------


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).double().numpy()


def ring_schedule(nchunks, ks, wst, items):
    """The weight ring's protocol under chunk groups, step by step: the
    producer fills stage s % wst with the CTA's s-th chunk once the chunk
    before it there is released; group g takes chunks g, g + ks, ... of
    each item in order and releases each stage when done, except the
    stages of an item's last wst chunks, which it releases after the item's
    reduction, once every group has finished the item. Returns, per item,
    the chunks the stages hold at the reduction; raises on a deadlock."""
    n = nchunks
    filled, released = 0, set()  # chunks loaded so far; chunks whose stage is free
    pos = [0] * ks  # next chunk index (within the item) of each group
    item, held, at_reduction = 0, [], []
    while item < items:
        progress = False
        while filled < items * n and (filled < wst or filled - wst in released):
            filled, progress = filled + 1, True  # the producer loads in order
        for g in range(ks):
            c = g + pos[g] * ks
            if c < n and item * n + c < filled:  # its chunk has arrived
                pos[g] += 1
                progress = True
                if c < n - wst:
                    released.add(item * n + c)
                else:
                    held.append(item * n + c)
        if all(g + pos[g] * ks >= n for g in range(ks)):  # the reduction
            assert len(held) == min(wst, n) and sorted(s % wst for s in held) == list(
                range(wst)), "a stage under the partial sums holds no chunk of this item"
            at_reduction.append(sorted(held))
            released.update(held)
            held, pos, item, progress = [], [0] * ks, item + 1, True
        if not progress:
            raise AssertionError(f"deadlock: item {item}, groups at {pos}, {filled} loaded")
    return at_reduction


def kernel_model_bf16(x, packed, bp, stride, residual, plan):
    """numpy model of the wide bf16 kernel's arithmetic under ``plan``
    (csrc/mbconv.cu): per (image, tile), the halo rows the expand computes
    (image padding zero after the ReLU6), chunk group g of the plan's ks
    summing chunks g, g + ks, ... in order into its own float32-exact
    project sums over the tile's rows (nc / ks M blocks of 64), then group
    0 adding groups 1..ks-1 in order, the bias and the residual; rounded to
    bf16 where the kernel rounds (after the expand, after the depthwise, at
    the output). Rows past the tile's pixels stay NaN, so a pixel no group
    computed shows. float64 sums."""
    we, be, wd, bd, wp = (None if t is None else t.double().numpy()
                          for t in M.unpack_mbconv(packed))
    xb = x.double().numpy()
    B, H, W, cin = xb.shape
    S, PAD, CH = stride, 1 if stride == 1 else 0, M.CH
    lay = M.kernel_layout(S, plan.th, plan.tw, cin, packed.cout, packed.expand, plan.xst,
                          plan.wst, plan.ks)
    nm, n = plan.nc // plan.ks, packed.nchunks
    assert plan.th * plan.tw <= 64 * nm and plan.nc % plan.ks == 0
    groups = [list(range(g, n, plan.ks)) for g in range(plan.ks)]
    assert sorted(sum(groups, [])) == list(range(n))  # each chunk summed by one group
    Ho, Wo = H // S, W // S
    tw_n, th_n = -(-Wo // plan.tw), -(-Ho // plan.th)
    out = np.full((B, Ho, Wo, packed.cout), np.nan)
    for b in range(B):
        for t in range(tw_n * th_n):
            oy0, ox0 = t // tw_n * plan.th, t % tw_n * plan.tw
            iy0, ix0 = oy0 * S - PAD, ox0 * S - PAD
            halo = np.zeros((lay.hin, lay.win, packed.kpad if packed.expand else cin))
            ys, xs_ = np.arange(lay.hin) + iy0, np.arange(lay.win) + ix0
            iny, inx = (ys >= 0) & (ys < H), (xs_ >= 0) & (xs_ < W)
            halo[np.ix_(iny, inx, np.arange(cin))] = xb[b][np.ix_(ys[iny], xs_[inx])]
            inside = np.outer(iny, inx)[..., None]
            sums = []
            for chunks in groups:
                acc = np.full((64 * nm, lay.coutp), np.nan)
                acc[:plan.th * plan.tw] = 0.0
                for c in chunks:
                    sl = slice(c * CH, (c + 1) * CH)
                    if packed.expand:
                        e = _bf16(np.clip(halo @ we[:, sl] + be[sl], 0, 6)) * inside
                    else:
                        e = np.zeros(halo.shape[:2] + (CH,))
                        k = min(CH, cin - c * CH)
                        e[..., :k] = halo[..., c * CH:c * CH + k]
                    dsum = np.zeros((plan.th, plan.tw, CH))
                    for dy in range(3):
                        for dx in range(3):
                            dsum += e[dy:dy + S * plan.th:S, dx:dx + S * plan.tw:S] * wd[dy, dx,
                                                                                         sl]
                    dw = _bf16(np.clip(dsum + bd[sl], 0, 6)).reshape(-1, CH)
                    acc[:plan.th * plan.tw] += dw @ wp[sl]
                sums.append(acc)
            total = sums[0]
            for part in sums[1:]:  # group order
                total = total + part
            for q in range(plan.th * plan.tw):
                oy, ox = oy0 + q // plan.tw, ox0 + q % plan.tw
                if oy < Ho and ox < Wo:
                    v = total[q, :packed.cout] + bp.double().numpy()
                    if residual:
                        v = v + xb[b, oy, ox]
                    out[b, oy, ox] = v
    return _bf16(out)


WIDE_CASES = [
    # (h, w, cin, ce, cout, stride, expand, residual): x1.4's and x1.0's wide
    # blocks at their real widths on small maps, and a ragged Ce
    (7, 7, 224, 1344, 224, 1, True, True),  # x1.4 blocks 14-15
    (14, 14, 136, 816, 224, 2, True, False),  # block 13
    (5, 6, 136, 816, 136, 1, True, True),  # blocks 11-12
    (6, 6, 96, 576, 160, 2, True, False),  # x1.0 block 13
    (4, 4, 160, 960, 160, 1, True, True),  # x1.0 blocks 14-15
    (3, 5, 88, 264, 264, 1, True, False),  # Cout 264 (11 blocks), Ce 264: 5.5 chunks
]


@pytest.mark.parametrize("ks", [1, 2, 3])
@pytest.mark.parametrize("case", WIDE_CASES)
def test_wide_chunk_groups_model_matches_reference(case, ks):
    """The kernel's sums under 1, 2 or 3 chunk groups (each group its share
    of the chunks in order, then the partial sums added in group order)
    give the plain version over the packed weights within atol = rtol =
    2e-2 in bf16 (the card tests' tolerance), with every output written."""
    h, w, cin, ce, cout, stride, expand, residual = case
    x, we, be, wd, bd, wp, bp = _block(case, torch.bfloat16)
    packed = M.pack_mbconv(we, be, wd, bd, wp)
    ho, wo = h // stride, w // stride
    plan = M.plan_tile(ho, wo, stride, cin, ce, cout, expand, 2)
    nm = -(-(plan.th * plan.tw) // 64)
    plan = plan._replace(nc=nm * ks, ks=ks)
    got = kernel_model_bf16(x, packed, bp, stride, residual, plan)
    want = M.reference_mbconv_packed(x, packed, bp, stride=stride, residual=residual)
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want.double().numpy(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("nchunks,ks,wst", [(28, 2, 3), (17, 2, 2), (17, 3, 3), (12, 2, 3),
                                            (3, 2, 3), (11, 4, 2), (20, 2, 3)])
def test_wide_ring_protocol_under_chunk_groups(nchunks, ks, wst):
    """Over 3 items of one CTA, the groups take their chunks without
    deadlock, and at each reduction every stage holds one of the item's
    last wst chunks, consumed and not released: the partial sums written
    over the ring overwrite nothing the producer or a group still needs."""
    held = ring_schedule(nchunks, ks, wst, 3)
    assert held == [[i * nchunks + c for c in range(nchunks - wst, nchunks)] for i in range(3)]


def test_wide_plans_at_the_real_shapes():
    """Past Cout 120 the plan takes the instance of exactly the launch's
    accumulator blocks, at most its warpgroups (3 for Cout 136, 2 past
    Cout 144), and the chunk groups only where every group's rows cover
    the tile; the partial sums fit the ring."""
    for alpha, size in ((1.4, 224), (1.0, 320)):
        wide = [s for s in _block_shapes(size, alpha) if s[5] > 120]
        assert len(wide) == {1.4: 6, 1.0: 3}[alpha]
        for batch in (1, 8, 128):
            _check_plans(wide, batch)
            for ho, wo, stride, cin, ce, cout, expand in wide:
                p = M.plan_tile(ho, wo, stride, cin, ce, cout, expand, batch)
                nb = M._round_up(cout, M.NBW) // M.NBW
                assert nb in (6, 7, 10) and M.max_warpgroups(cout) == (3 if nb == 6 else 2)
                assert p.nc <= M.max_warpgroups(cout)


# -- the float32 kernel (mbconv_f32): packing, a model of the kernel, the plan --

# x0.75's real widths at its 3x3 and 6x6 maps (the learn phase's [8, 96])
# and x1.4's Cout 448 block (Ce 1344 over 42 chunks), besides PACK_CASES
F32_CASES = PACK_CASES + [
    (3, 3, 120, 720, 120, 1, True, True),  # x0.75 blocks 14-15 at 96
    (3, 3, 72, 432, 120, 2, True, False),  # block 13: 6x6 -> 3x3
    (6, 6, 48, 288, 72, 1, True, False),  # block 10
    (6, 6, 72, 432, 72, 1, True, True),  # blocks 11-12
    (6, 6, 24, 144, 48, 2, True, False),  # block 6: 12x12 -> 6x6
    (3, 3, 224, 1344, 448, 1, True, False),  # x1.4's Cout 448
]


@pytest.mark.parametrize("case", F32_CASES)
def test_f32_packed_plain_version_equals_reference(case):
    """The float32 packed weights (``pack_mbconv_f32``), unpacked and run
    through ``reference_mbconv``, give the unpacked weights' result bit for
    bit; the padding of Ce is zeros and every chunk is whole 16-byte
    copies. (The plain version over the padded problem is not bitwise: a
    CPU GEMM blocks a K of 448 otherwise than one of 432.)"""
    stride, residual, cin, ce, cout, expand = case[5], case[7], case[2], case[3], case[4], case[6]
    x, we, be, wd, bd, wp, bp = _block(case, torch.float32)
    p = M.pack_mbconv_f32(we, be, wd, bd, wp)
    assert (p.layout, p.dtype, p.kpad, p.coutp) == ("f32", torch.float32, cin, cout)
    assert p.nchunks == -(-ce // M.F32_CH) and p.w.dtype == torch.uint8
    lay = M.kernel_layout_f32(stride, 1, 1, 1, cin, cout, expand, 1)
    assert p.w.numel() == p.nchunks * lay.chunk_bytes and lay.chunk_bytes % 16 == 0
    assert M.packed_like(p.w, we, wd, wp) == p
    we2, be2, wd2, bd2, wp2 = M.unpack_mbconv(p)
    assert torch.equal(wd2[..., :ce], wd) and not wd2[..., ce:].any()
    assert torch.equal(bd2[:ce], bd) and not bd2[ce:].any()
    assert torch.equal(wp2[:ce], wp) and not wp2[ce:].any()
    if expand:
        assert torch.equal(we2[:, :ce], we) and not we2[:, ce:].any()
        assert torch.equal(be2[:ce], be) and not be2[ce:].any()
    got = M.reference_mbconv(x, we2[:, :ce] if expand else None, be2[:ce] if expand else None,
                             wd2[..., :ce], bd2[:ce], wp2[:ce], bp, stride=stride,
                             residual=residual)
    want = M.reference_mbconv(x, we, be, wd, bd, wp, bp, stride=stride, residual=residual)
    assert torch.equal(got, want)


def kernel_model_f32(x, packed, bp, stride, residual, plan):
    """numpy model of ``mbconv_f32`` (csrc/mbconv.cu), index for index: per
    (image, tile, cluster rank) the in-image halo rectangle and its pixel
    groups, the rank's chunks, the shared-memory layout and weight rings of
    ``kernel_layout_f32`` with their two stages, the pipeline and which
    stage each step reads; without a cluster the project owners; with one,
    each rank's depthwise chunks kept, then each rank's project slice of
    Cout over all chunks, each chunk read from the rank that made it.
    Buffers start as NaN where the kernel leaves them unwritten, so a read
    of the wrong stage, rank or chunk, or of a pixel no thread computed,
    shows in the output. float64 arithmetic."""
    th, tw, rq, px, R = plan.th, plan.tw, plan.rq, plan.px, plan.cluster
    xb = x.numpy().astype(np.float64)
    B, H, W, cin = xb.shape
    cout, n, expand = packed.cout, packed.nchunks, packed.expand
    w = packed.w.view(torch.float32).numpy().astype(np.float64).reshape(n, -1)
    S, PAD, CH = stride, 1 if stride == 1 else 0, M.F32_CH
    lay = M.kernel_layout_f32(S, th, tw, rq, cin, cout, expand, R, n)
    assert plan.smem == lay.smem <= M.SMEM_LIMIT
    e_part, d_part = ((cin + 1) * CH if expand else 0), 10 * CH
    Ho, Wo = H // S, W // S
    tiles_w, tiles_h = -(-Wo // tw), -(-Ho // th)
    cgs = cout // 8
    owners = [(t // cgs * rq, t % cgs * 8) for t in range(M.F32_NT)
              if R == 1 and t < lay.poutp // rq * cgs]
    out = np.full((B, Ho, Wo, cout), np.nan)
    for b in range(B):
        for tile in range(tiles_w * tiles_h):
            oy0, ox0 = tile // tiles_w * th, tile % tiles_w * tw
            iy0, ix0 = oy0 * S - PAD, ox0 * S - PAD
            ry0, ry1 = max(0, -iy0), min(lay.hin, H - iy0)
            rx0, rx1 = max(0, -ix0), min(lay.win, W - ix0)
            rw, npix = rx1 - rx0, (ry1 - ry0) * (rx1 - rx0)
            G = -(-npix // px)
            cover = sorted(g + r * G for g in range(G) for r in range(px) if g + r * G < npix)
            assert cover == list(range(npix))  # each in-image halo pixel once
            pix = [(ry0 + m // rw) * lay.win + rx0 + m % rw for m in cover]
            x_s = np.full((lay.pin, lay.xs), np.nan)
            for m, p in zip(cover, pix):
                x_s[p, :cin] = xb[b, iy0 + ry0 + m // rw, ix0 + rx0 + m % rw]
            total = np.full((lay.pout, cout), np.nan)
            kept = []  # with a cluster: each rank's depthwise chunks
            for rank in range(R):
                c0 = rank * n // R
                nloc = (rank + 1) * n // R - c0
                assert 1 <= nloc <= lay.nloc
                e_s = np.zeros((2, lay.pin, CH))
                d_s = np.full((2 if R == 1 else nloc, lay.poutp, CH), np.nan)
                ring = {k: np.full((2, size), np.nan) for k, size in
                        (("e", e_part), ("d", d_part), ("p", CH * cout))}

                def stage(kind, slot, c):
                    off = {"e": 0, "d": e_part, "p": e_part + d_part}[kind]
                    ring[kind][slot] = w[c0 + c, off:off + ring[kind].shape[1]]

                if expand:
                    stage("e", 0, 0)
                    if nloc > 1:
                        stage("e", 1, 1)
                stage("d", 0, 0)
                acc = np.full((lay.poutp, cout), np.nan)
                for q0, co0 in owners:
                    acc[q0:q0 + rq, co0:co0 + 8] = 0.0
                for i in range(nloc + (2 if R == 1 else 1)):
                    if i < nloc:  # expand of chunk i
                        e = e_s[i & 1]
                        if expand:
                            we = ring["e"][i & 1][:cin * CH].reshape(cin, CH)
                            be = ring["e"][i & 1][cin * CH:]
                            e[pix] = np.clip(x_s[pix, :cin] @ we + be, 0, 6)
                        else:
                            ch = (c0 + i) * CH + np.arange(CH)
                            e[pix] = np.where(ch < cin, x_s[pix][:, np.minimum(ch, cin - 1)], 0)
                    if 1 <= i <= nloc:  # depthwise of chunk i - 1
                        wd = ring["d"][(i - 1) & 1]
                        e, d = e_s[(i - 1) & 1], d_s[(i - 1) & 1 if R == 1 else i - 1]
                        d[:] = 0.0
                        for q in range(lay.pout):
                            oy, ox = divmod(q, tw)
                            a = sum(e[(oy * S + di) * lay.win + ox * S + dj] * wd[(di * 3 + dj)
                                    * CH:(di * 3 + dj + 1) * CH] for di in range(3)
                                    for dj in range(3))
                            d[q] = np.clip(a + wd[9 * CH:], 0, 6)
                    if i >= 2 and R == 1:  # project of chunk i - 2
                        wp = ring["p"][i & 1].reshape(CH, cout)
                        for q0, co0 in owners:
                            acc[q0:q0 + rq, co0:co0 + 8] += d_s[i & 1][q0:q0 + rq] @ wp[:,
                                                                                      co0:co0 + 8]
                    if expand and i + 2 < nloc:
                        stage("e", i & 1, i + 2)
                    if i + 1 < nloc:
                        stage("d", (i + 1) & 1, i + 1)
                    if R == 1 and i < nloc:
                        stage("p", i & 1, i)
                if R == 1:
                    total = acc[:lay.pout]
                kept.append(d_s)
            for rank in range(R if R > 1 else 0):  # with a cluster: each rank's slice
                g0, g1 = rank * cgs // R, (rank + 1) * cgs // R
                nq4 = (g1 - g0) * 2
                assert nq4 * 4 <= lay.slice and lay.pout * nq4 <= M.F32_MAX_UNITS * M.F32_NT
                units = [(u // nq4, g0 * 8 + u % nq4 * 4) for u in range(lay.pout * nq4)]
                acc = {u: np.zeros(4) for u in units}
                for c in range(n):
                    k = ((c + 1) * R - 1) // n  # the rank whose chunks hold c
                    assert k * n // R <= c < (k + 1) * n // R
                    dc = kept[k][c - k * n // R][:lay.pout]
                    wp = w[c, e_part + d_part:].reshape(CH, cout)
                    for q, co in units:
                        acc[(q, co)] += dc[q] @ wp[:, co:co + 4]
                for (q, co), v in acc.items():
                    total[q, co:co + 4] = v
            for q in range(lay.pout):
                qy, qx = divmod(q, tw)
                oy, ox = oy0 + qy, ox0 + qx
                if oy < Ho and ox < Wo:
                    v = total[q] + bp.numpy()
                    if S == 1 and residual:
                        v = v + x_s[(qy + 1) * lay.win + qx + 1, :cout]
                    out[b, oy, ox] = v
    return out


def _forced_plan(case, batch, **kw):
    h, w, cin, ce, cout, stride, expand, _ = case
    n = -(-ce // M.F32_CH)
    p = M.plan_tile_f32(h, w, stride, cin, ce, cout, expand, batch)._replace(**kw)
    cluster = min(p.cluster, n)
    rq = M._rq(p.th * p.tw, cout) if cluster == 1 else 1
    lay = M.kernel_layout_f32(stride, p.th, p.tw, rq, cin, cout, expand, cluster, n)
    return p._replace(rq=rq, cluster=cluster, smem=lay.smem)


@pytest.mark.parametrize("variant", ["plan_b2", "plan_b1_px1", "cluster1", "ragged_tiles",
                                     "whole_map"])
@pytest.mark.parametrize("case", F32_CASES)
def test_f32_kernel_model_matches_reference(case, variant):
    """The model of the kernel, under its own plan at b2 and under forced
    ones (one pixel a thread; no cluster; tiles that overhang the map; the
    whole map as one tile, whose owners take 2 or 4 pixels), computes the
    block within atol = rtol = 1e-5 of the float32 reference."""
    stride, residual = case[5], case[7]
    x, we, be, wd, bd, wp, bp = _block(case, torch.float32)
    packed = M.pack_mbconv_f32(we, be, wd, bd, wp)
    plan = {"plan_b2": lambda: _forced_plan(case, 2),
            "plan_b1_px1": lambda: _forced_plan(case, 1, px=1),
            "cluster1": lambda: _forced_plan(case, 2, cluster=1, px=2),
            "ragged_tiles": lambda: _forced_plan(case, 2, th=min(case[0], 4), tw=min(case[1], 3),
                                                 px=4),
            "whole_map": lambda: _forced_plan(case, 2, th=case[0], tw=case[1], px=2)}[variant]()
    got = kernel_model_f32(x, packed, bp, stride, residual, plan)
    want = M.reference_mbconv(x, we, be, wd, bd, wp, bp, stride=stride, residual=residual)
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want.double().numpy(), atol=1e-5, rtol=1e-5)


def _f32_plans(shapes, batch, num_sms=132):
    for ho, wo, stride, cin, ce, cout, expand in shapes:
        p = M.plan_tile_f32(ho, wo, stride, cin, ce, cout, expand, batch, num_sms)
        n = -(-ce // M.F32_CH)
        lay = M.kernel_layout_f32(stride, p.th, p.tw, p.rq, cin, cout, expand, p.cluster, n)
        # shared memory: the layout's, within the 227 KB a block may use
        assert p.smem == lay.smem <= M.SMEM_LIMIT
        assert p.ctas_per_sm == min(2, M.SM_SHARED // (p.smem + 1024)) >= 1
        # the tiles cover every output pixel exactly once
        assert 1 <= p.th <= min(ho, M.F32_MAX_TILE) and 1 <= p.tw <= min(wo, M.F32_MAX_TILE)
        cover = np.zeros((ho, wo), int)
        for t in range(p.tiles):
            oy, ox = t // -(-wo // p.tw) * p.th, t % -(-wo // p.tw) * p.tw
            cover[oy:oy + p.th, ox:ox + p.tw] += 1
        assert p.tiles == -(-ho // p.th) * -(-wo // p.tw) and (cover == 1).all()
        # the project owners fit the CTA (a cluster: each rank's units of its
        # slice of Cout fit F32_MAX_UNITS a thread, and the slices cover Cout)
        assert p.rq in (1, 2, 4) and p.px in (1, 2, 4) and lay.poutp >= p.th * p.tw
        if p.cluster == 1:
            assert lay.poutp // p.rq * (cout // 8) <= M.F32_NT
        else:
            groups = [(k + 1) * (cout // 8) // p.cluster - k * (cout // 8) // p.cluster
                      for k in range(p.cluster)]
            assert p.rq == 1 and sum(groups) == cout // 8 and max(groups) * 8 <= lay.slice
            assert p.th * p.tw * max(groups) * 2 <= M.F32_MAX_UNITS * M.F32_NT
        # the cluster's ranks split the chunks, none left out, none empty
        assert 1 <= p.cluster <= min(M.F32_MAX_CLUSTER, n)
        shares = [(k * n // p.cluster, (k + 1) * n // p.cluster) for k in range(p.cluster)]
        assert shares[0][0] == 0 and shares[-1][1] == n
        assert all(a < b for a, b in shares) and all(s[1] == t[0] for s, t in
                                                     zip(shares, shares[1:]))
        # the grid fills the card where batch x tiles x 8 allows it
        assert p.ctas == batch * p.tiles * p.cluster
        if batch * p.tiles * min(M.F32_MAX_CLUSTER, n) >= num_sms:
            assert p.ctas >= num_sms
        if batch * p.tiles >= num_sms:
            assert p.cluster == 1  # the plain tiled path where the grid already fills the card


@pytest.mark.parametrize("alpha,size,batch", [(0.75, 96, 8), (0.75, 160, 8), (0.75, 320, 128),
                                              (0.75, 320, 2), (0.75, 320, 1), (1.4, 224, 128),
                                              (1.4, 224, 2), (0.75, 224, 128), (0.75, 416, 4)])
def test_f32_tile_plan(alpha, size, batch):
    """``plan_tile_f32`` at the float32 path's shapes: the learn phase's
    [8, 96] and [8, 160], the eval's b128 @320, the checks' b1/b2, x1.4's
    COCO shapes, the zoom crop and an odd 13x13 map."""
    _f32_plans(_block_shapes(size, alpha), batch)


def test_f32_tile_plan_wide_and_on_fewer_sms():
    """x1.4's Cout 448 (owners need 4 pixels a thread), and a card with
    fewer SMs (the cluster follows ``num_sms``)."""
    _f32_plans([(3, 3, 1, 224, 1344, 448, True), (7, 7, 1, 224, 1344, 448, True)], 8)
    _f32_plans(_block_shapes(96), 8, num_sms=66)
    p = M.plan_tile_f32(3, 3, 1, 120, 720, 120, True, 8, 132)
    assert p.cluster > 1 and p.ctas >= 64  # 8 images of a 3x3 map spread over the card
