"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``: the kernels have no CPU mode, so without a GPU these
tests skip. This file imports no JAX, so it runs on a machine that has
only PyTorch: ``python -m pytest tests/test_torch_cuda.py -m cuda``.
Float32 with TF32 off (tolerance 1e-4: summation order over at most
720 terms); bfloat16 atol = rtol = 2e-2, one bf16 step at values in
[2, 4) (the kernel rounds where the plain version rounds, so summation
order is the only difference); NMS must agree exactly (the kernels are built without FMA
contraction and copy the picked values; the shared-pool kernel divides wherever its
margin test cannot settle IoU > threshold). The NMS edge cases here are also held
against the JAX package on the CPU by tests/test_torch_nms.py; so is the large-pool
variant's plain version, on ``large_pool_case``.
"""

import numpy as np
import pytest
import torch

from yoloret_tpu_torch.ops.mbconv import fused_mbconv, reference_mbconv
from yoloret_tpu_torch.ops.nms_kernel import plan_nms, suppress, suppress_plain

MBCONV_CASES = [
    # (h, w, cin, ce, cout, stride, expand, residual)
    (16, 16, 8, 32, 16, 1, True, False),
    (20, 20, 16, 96, 16, 1, True, True),
    (16, 16, 24, 24, 16, 1, False, False),
    (12, 12, 16, 16, 16, 1, False, True),
    (16, 16, 8, 48, 24, 2, True, False),
    (10, 10, 72, 432, 120, 2, True, False),
    (10, 10, 120, 720, 120, 1, True, True),
]
# The 16 blocks of MobileNetV2 x0.75 @320 (11 distinct shapes), at batch
# 1 and 3; odd maps (416 gives 13x13 maps), a 7x7 map, a block without
# expand, and a batch of 128 whose items outnumber the persistent CTAs.
BLOCK_SHAPES = [
    (160, 160, 24, 24, 16, 1, False, False),
    (160, 160, 16, 96, 24, 2, True, False),
    (80, 80, 24, 144, 24, 1, True, True),
    (80, 80, 24, 144, 24, 2, True, False),
    (40, 40, 24, 144, 24, 1, True, True),
    (40, 40, 24, 144, 48, 2, True, False),
    (20, 20, 48, 288, 48, 1, True, True),
    (20, 20, 48, 288, 72, 1, True, False),
    (20, 20, 72, 432, 72, 1, True, True),
    (20, 20, 72, 432, 120, 2, True, False),
    (10, 10, 120, 720, 120, 1, True, True),
]
MBCONV_CASES += [s + (n,) for n in (1, 3) for s in BLOCK_SHAPES] + [
    (13, 13, 120, 720, 120, 1, True, True, 3),
    (26, 26, 72, 432, 120, 2, True, False, 3),
    (7, 7, 120, 720, 120, 1, True, True, 3),
    (14, 14, 72, 432, 120, 2, True, False, 3),
    (9, 11, 24, 24, 16, 1, False, False, 3),
    (10, 10, 120, 720, 120, 1, True, True, 128),
]
# MobileNetV2 x1.4 @224 (the COCO config; 11 distinct shapes of its 16
# blocks): Cout 136 and 224 take the NB=11 instance of the bf16 kernel,
# blocks 14-15 Ce 1344 (28 chunks) on 7x7 maps; at batch 1 and 128.
X14_BLOCK_SHAPES = [
    (112, 112, 48, 48, 24, 1, False, False),
    (112, 112, 24, 144, 32, 2, True, False),
    (56, 56, 32, 192, 32, 1, True, True),
    (56, 56, 32, 192, 48, 2, True, False),
    (28, 28, 48, 288, 48, 1, True, True),
    (28, 28, 48, 288, 88, 2, True, False),
    (14, 14, 88, 528, 88, 1, True, True),
    (14, 14, 88, 528, 136, 1, True, False),
    (14, 14, 136, 816, 136, 1, True, True),
    (14, 14, 136, 816, 224, 2, True, False),
    (7, 7, 224, 1344, 224, 1, True, True),
]
MBCONV_CASES += [s + (1,) for s in X14_BLOCK_SHAPES] + [
    s + (128,) for s in X14_BLOCK_SHAPES[-3:]] + [
    (10, 10, 160, 960, 160, 1, True, True, 8),  # x1.0 @320, blocks 14-15
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _mbconv_inputs(seed, h, w, cin, ce, cout, expand, dev, batch=3):
    rs = np.random.RandomState(seed)

    def r(*shape):
        return torch.from_numpy((rs.randn(*shape) * 0.2).astype(np.float32)).to(dev)

    x = torch.from_numpy(rs.rand(batch, h, w, cin).astype(np.float32) - 0.5).to(dev)
    return (x, r(cin, ce) if expand else None, r(ce) if expand else None, r(3, 3, ce), r(ce),
            r(ce, cout), r(cout))


@pytest.mark.cuda
@pytest.mark.parametrize("case", MBCONV_CASES)
def test_mbconv_kernel_matches_plain(cuda, case):
    h, w, cin, ce, cout, stride, expand, residual = case[:8]
    args = _mbconv_inputs(0, h, w, cin, ce, cout, expand, cuda, *case[8:])
    before = fused_mbconv.launches
    got = fused_mbconv(*args, stride=stride, residual=residual)
    assert fused_mbconv.launches == before + 1
    want = reference_mbconv(*args, stride=stride, residual=residual)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    bf = [None if a is None else a.to(torch.bfloat16) if i in (0, 1, 3, 5) else a
          for i, a in enumerate(args)]
    got = fused_mbconv(*bf, stride=stride, residual=residual)
    want = reference_mbconv(*bf, stride=stride, residual=residual)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


NMS_MAX_DET = 20
# Shared-pool cases for the edges greedy NMS must get exactly right:
# name -> (B, C, M, score threshold). tests/test_torch_nms.py holds the
# plain version against the JAX package on the same cases.
NMS_CASES = {
    "ties_c3": (2, 3, 40, 0.0),  # scores in quarter steps, +0 and -0 tied
    "ties_c20": (2, 20, 64, 0.25),
    "iou_at_threshold": (1, 3, 18, 0.0),  # pairs at IoU 0.5 (exact and by rounding)
    "identical_boxes": (2, 3, 48, 0.25),
    "zero_area": (2, 3, 40, 0.1),  # flat and inverted boxes
    "below_threshold": (2, 3, 32, 0.6),
    "b1_c20": (1, 20, 64, 0.3),
    "b1_c3_ragged": (1, 3, 33, 0.3),
}
# Pairs whose IoU is 0.5: exactly (integer sides), and within rounding.
AT_THRESHOLD = [([0, 0, 1, 2], [0, 0, 1, 1]), ([5, 5, 7, 7], [5, 5, 6, 7]),
                ([10, 10, 14, 12], [10, 10, 12, 12]), ([20, 20, 22, 21], [20, 20, 21, 21])]
AT_THRESHOLD += [([30, 30, 30 + s, 30 + 2 * s], [30, 30, 30 + s, 30 + s])
                 for s in (0.1, 0.3, 0.7, 1.1, 3.3)]


def nms_case(name):
    """(boxes [B, M, 4], scores [B, C, M], score threshold) of a named
    case of ``NMS_CASES``, float32 numpy, made from a seed."""
    b, c, m, thr = NMS_CASES[name]
    rs = np.random.RandomState(sum(map(ord, name)))

    def grid_boxes(n):  # small integer boxes on an 8 x 8 grid: many overlaps and ties
        yx = rs.randint(0, 8, (b, n, 2)).astype(np.float32)
        return np.concatenate([yx, yx + rs.randint(1, 5, (b, n, 2))], -1).astype(np.float32)

    def tied_scores():
        return (rs.randint(0, 5, (b, c, m)) / 4).astype(np.float32)

    def distinct_scores():
        return (rs.permutation(b * c * m).reshape(b, c, m) / (b * c * m)).astype(np.float32)

    if name.startswith("ties"):
        boxes, scores = grid_boxes(m), tied_scores()
        scores[(scores == 0) & (rs.rand(b, c, m) < 0.5)] = -0.0
    elif name == "iou_at_threshold":
        boxes = np.array([q for pair in AT_THRESHOLD for q in pair], np.float32)
        boxes, scores = np.repeat(boxes[None], b, 0), distinct_scores()
    elif name == "identical_boxes":
        boxes, scores = grid_boxes(6)[:, rs.randint(0, 6, m)], tied_scores()
    elif name == "zero_area":
        boxes, scores = grid_boxes(m), distinct_scores()
        boxes[..., 2] = np.where(rs.rand(b, m) < 0.5, boxes[..., 0], boxes[..., 2])
        boxes[..., 3] = np.where(rs.rand(b, m) < 0.25, boxes[..., 1] - 1, boxes[..., 3])
    elif name == "below_threshold":
        boxes, scores = grid_boxes(m), distinct_scores() * np.float32(0.5)
    else:
        boxes = rs.rand(b, m, 4).astype(np.float32) * 50
        boxes[..., 2:] = boxes[..., :2] + rs.rand(b, m, 2).astype(np.float32) * 20
        scores = distinct_scores()
    return np.ascontiguousarray(boxes), np.ascontiguousarray(scores), thr


def large_pool_case(k, b=2, c=3, shared=False, seed=0):
    """(boxes [B, C, K, 4] or [B, K, 4], scores [B, C, K]) for the
    large-pool kernel: integer boxes on a 40 x 40 grid (many overlaps and
    identical boxes), the pairs of ``AT_THRESHOLD`` (IoU 0.5, exactly and
    by rounding) at the front of every pool, scores in eighths (ties, and
    -0 beside +0), the last pool all negative (nothing to pick at a
    threshold of 0). float32 numpy, made from ``seed``."""
    rs = np.random.RandomState(seed + k)
    shape = (b, k) if shared else (b, c, k)
    yx = rs.randint(0, 40, shape + (2,)).astype(np.float32)
    boxes = np.concatenate([yx, yx + rs.randint(1, 9, shape + (2,))], -1).astype(np.float32)
    pairs = np.array([q for pair in AT_THRESHOLD for q in pair], np.float32)
    boxes[..., :len(pairs), :] = pairs
    scores = (rs.randint(0, 9, (b, c, k)) / 8).astype(np.float32)
    scores[(scores == 0) & (rs.rand(b, c, k) < 0.5)] = -0.0
    scores[-1, -1] = -0.125 - scores[-1, -1]
    return np.ascontiguousarray(boxes), scores


def _nms_exact(bt, st, **kw):
    before = suppress.launches
    got = suppress(bt, st, **kw)
    assert suppress.launches == before + 1
    want = suppress_plain(bt, st, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NMS_CASES))
def test_nms_kernel_edge_cases(cuda, name):
    boxes, scores, thr = nms_case(name)
    bt, st = torch.from_numpy(boxes).to(cuda), torch.from_numpy(scores).to(cuda)
    assert plan_nms(st.shape[1], st.shape[2], NMS_MAX_DET, True).variant == "shared"
    _nms_exact(bt, st, max_det=NMS_MAX_DET, iou_threshold=0.5, score_threshold=thr)
    # the same pools as per-class pools: the per-class kernel stays exact too
    cls = bt[:, None].expand(-1, st.shape[1], -1, -1).contiguous()
    _nms_exact(cls, st, max_det=NMS_MAX_DET, iou_threshold=0.5, score_threshold=thr)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,m,max_det", [
    (128, 20, 64, 20),  # serving
    (128, 20, 512, 20),  # MAP grade
    (8, 20, 512, 20),
    (2, 200, 512, 20),  # scores in passes of classes
    (2, 20, 512, 2000),  # pick buffers large: passes of fewer classes
    (3, 5, 200, 7),  # tiles beyond the last candidate
    (128, 80, 64, 20),  # the COCO configs: serving
    (128, 80, 512, 20),  # MAP grade
    (1, 80, 512, 20),
])
def test_nms_shared_kernel_shapes(cuda, b, c, m, max_det):
    plan = plan_nms(c, m, max_det, True)
    assert plan.variant == "shared"
    rs = np.random.RandomState(b + c + m)
    boxes = rs.rand(b, m, 4).astype(np.float32) * 300
    boxes[..., 2:] = boxes[..., :2] + rs.rand(b, m, 2).astype(np.float32) * 80
    scores = rs.rand(b, c, m).astype(np.float32)
    bt, st = torch.from_numpy(boxes).to(cuda), torch.from_numpy(scores).to(cuda)
    for thr in (0.0, 0.3):
        _nms_exact(bt, st, max_det=max_det, iou_threshold=0.5, score_threshold=thr)


@pytest.mark.cuda
def test_nms_shared_kernel_infinite_boxes(cuda):
    """Boxes with infinite corners (an overflowed exp in decode): unions of
    inf or NaN go to the division, as in the plain version; so do all pairs
    of an image with tiny nonzero areas."""
    rs = np.random.RandomState(3)
    boxes = rs.rand(2, 64, 4).astype(np.float32) * 50
    boxes[..., 2:] = boxes[..., :2] + rs.rand(2, 64, 2).astype(np.float32) * 20
    boxes[:, ::7, 3] = np.inf
    boxes[:, ::11, 2] = np.inf
    boxes[1, :32] *= np.float32(1e-19)  # areas ~1e-38: every pair of image 1 divided
    scores = rs.rand(2, 4, 64).astype(np.float32)
    bt, st = torch.from_numpy(boxes).to(cuda), torch.from_numpy(scores).to(cuda)
    for iou_thr in (0.5, 0.0, -1.0):  # 0 and below: every pair divided
        _nms_exact(bt, st, max_det=20, iou_threshold=iou_thr, score_threshold=0.2)


@pytest.mark.cuda
@pytest.mark.parametrize("k,shared", [(64, True), (512, True), (100, False), (512, False)])
def test_nms_kernel_matches_plain(cuda, k, shared):
    rs = np.random.RandomState(k)
    b, c = 4, 20
    shape = (b, k) if shared else (b, c, k)
    boxes = rs.rand(*shape, 4).astype(np.float32) * 300
    boxes[..., 2:] = boxes[..., :2] + rs.rand(*shape, 2).astype(np.float32) * 60
    scores = (rs.permutation(b * c * k).reshape(b, c, k) / (b * c * k)).astype(np.float32)
    bt, st = torch.from_numpy(boxes).to(cuda), torch.from_numpy(scores).to(cuda)
    before = suppress.launches
    got = suppress(bt, st, max_det=20, iou_threshold=0.5, score_threshold=0.3)
    assert suppress.launches == before + 1
    want = suppress_plain(bt, st, max_det=20, iou_threshold=0.5, score_threshold=0.3)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [513, 6300, 10647, 3087])
def test_nms_large_kernel_matches_plain(cuda, k):
    """Pools above 512 (the exact-NMS evaluation's whole grid at 320 and
    416): tied scores, pairs at IoU 0.5, per-class and shared pools, both
    empty scores; exact."""
    for shared in (False, True):
        boxes, scores = large_pool_case(k, shared=shared)
        bt, st = torch.from_numpy(boxes).to(cuda), torch.from_numpy(scores).to(cuda)
        assert plan_nms(st.shape[1], k, NMS_MAX_DET, shared).variant == "per_class_large"
        before = suppress.variant_launches["per_class_large"]
        for thr, empty in ((0.0, 0.0), (0.25, float("-inf")), (2.0, 0.0)):
            got = _nms_exact(bt, st, max_det=NMS_MAX_DET, iou_threshold=0.5,
                             score_threshold=thr, empty_score=empty)
            assert (got[1] > 0).any() == (thr < 1)
        assert suppress.variant_launches["per_class_large"] == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3087, 10647])
def test_nms_large_kernel_80_classes(cuda, k):
    """The exact evaluation's whole grid of the COCO configs (224: 3,087;
    416: 10,647) at 80 classes: several classes' CTAs per image."""
    boxes, scores = large_pool_case(k, b=2, c=80)
    bt, st = torch.from_numpy(boxes).to(cuda), torch.from_numpy(scores).to(cuda)
    for thr, empty in ((0.0, float("-inf")), (0.25, 0.0)):
        _nms_exact(bt, st, max_det=NMS_MAX_DET, iou_threshold=0.5, score_threshold=thr,
                   empty_score=empty)


@pytest.mark.cuda
def test_nms_large_kernel_distinct_scores(cuda):
    """Seeded random boxes and distinct scores at b4 C=20 K=6300, max_det
    100 (every round picks)."""
    rs = np.random.RandomState(1)
    b, c, k = 4, 20, 6300
    boxes = rs.rand(b, c, k, 4).astype(np.float32) * 320
    boxes[..., 2:] = boxes[..., :2] + rs.rand(b, c, k, 2).astype(np.float32) * 60
    scores = (rs.permutation(b * c * k).reshape(b, c, k) / (b * c * k)).astype(np.float32)
    bt, st = torch.from_numpy(boxes).to(cuda), torch.from_numpy(scores).to(cuda)
    _nms_exact(bt, st, max_det=100, iou_threshold=0.45, score_threshold=0.0)
