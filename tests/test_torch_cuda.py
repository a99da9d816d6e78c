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
# Multi-scale training's detection passes (--tb_images): x0.75 at 288 and
# 352 (last maps 9x9 and 11x11), batch 4. IMAGE runs 320 at batch 1
# (BLOCK_SHAPES above).
MBCONV_CASES += [(s[0] * size // 320, s[1] * size // 320) + s[2:] + (4,)
                 for size in (288, 352) for s in BLOCK_SHAPES]


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


def model_like_pool(k, b=2, c=20, seed=0):
    """(boxes [B, C, K, 4], scores [B, C, K]) like the exact evaluation's
    whole-grid pools: per image a few objects, each seen by many
    candidates (jittered copies of its box, as neighbouring anchors see
    it) scoring high in its class, the rest background boxes scoring low;
    distinct scores; every class's pool in a stable descending sort of
    its scores, as ``per_class_candidates`` orders it. float32 numpy."""
    rs = np.random.RandomState(seed + k)
    n_obj = 6
    yx = rs.rand(b, n_obj, 2) * 280
    obj = np.concatenate([yx, yx + 20 + rs.rand(b, n_obj, 2) * 100], -1)
    owner = rs.randint(-1, n_obj, (b, k))  # -1: background
    boxes = rs.rand(b, k, 4) * 300
    boxes[..., 2:] = boxes[..., :2] + rs.rand(b, k, 2) * 40
    for i in range(b):
        on = owner[i] >= 0
        boxes[i, on] = obj[i, owner[i, on]] + rs.randn(int(on.sum()), 4) * 6
    obj_cls = rs.randint(0, c, (b, n_obj))
    scores = rs.rand(b, c, k) * 0.05
    for i in range(b):
        on = np.nonzero(owner[i] >= 0)[0]
        scores[i, obj_cls[i, owner[i, on]], on] += 0.3 + 0.7 * rs.rand(len(on))
    scores = scores.astype(np.float32)
    s, idx = torch.sort(torch.from_numpy(scores), dim=-1, descending=True, stable=True)
    bx = torch.gather(torch.from_numpy(boxes.astype(np.float32))[:, None].expand(b, c, k, 4), 2,
                      idx[..., None].expand(b, c, k, 4))
    return np.ascontiguousarray(bx.numpy()), np.ascontiguousarray(s.numpy())


def reorder(boxes, scores, order, seed=0):
    """A sorted pool as it is (``sorted``), each pool's candidates in a
    seeded random order (``shuffled``), or sorted with one inversion at
    the last index (``one_inversion``, in the last pool of each image)."""
    if order == "shuffled":
        perm = np.random.RandomState(seed).permutation(scores.shape[-1])
        return np.ascontiguousarray(boxes[:, :, perm]), np.ascontiguousarray(scores[:, :, perm])
    scores = scores.copy()
    if order == "one_inversion":
        scores[:, -1, -1] = scores[:, -1, -2] + np.float32(0.5)
    return boxes, scores


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["sorted", "shuffled", "one_inversion"])
@pytest.mark.parametrize("k,c", [(6300, 20), (3087, 80), (10647, 80), (12000, 20)])
def test_nms_large_kernel_sorted_and_not(cuda, k, c, order):
    """Model-like sorted pools (the walk), the same shuffled and with one
    inversion at the last index (the rounds), at the exact evaluation's
    shapes and beyond the staging limit (12,000: boxes from device
    memory); at thresholds 0 and 0.2 and with nothing above the
    threshold; exact."""
    boxes, scores = reorder(*model_like_pool(k, c=c), order)
    bt, st = torch.from_numpy(boxes).to(cuda), torch.from_numpy(scores).to(cuda)
    for thr, empty in ((0.0, float("-inf")), (0.2, 0.0), (2.0, 0.0)):
        got = _nms_exact(bt, st, max_det=NMS_MAX_DET, iou_threshold=0.5, score_threshold=thr,
                         empty_score=empty)
        assert (got[1] > 0).any() == (thr < 1)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [700, 6300])
def test_nms_large_kernel_sorted_ties(cuda, k):
    """``large_pool_case`` in a stable descending sort: tied scores in
    eighths, -0 beside +0, pairs at IoU 0.5, an all-negative pool; the
    walk at max_det 1, 20 and 200 (fewer picks than max_det)."""
    boxes, scores = large_pool_case(k, b=2, c=3, shared=True)
    s, idx = torch.sort(torch.from_numpy(scores), dim=-1, descending=True, stable=True)
    bx = torch.gather(torch.from_numpy(boxes)[:, None].expand(2, 3, k, 4), 2,
                      idx[..., None].expand(2, 3, k, 4))
    bt, st = bx.contiguous().to(cuda), s.contiguous().to(cuda)
    for max_det in (1, 20, 200):
        for thr in (0.0, 0.25):
            _nms_exact(bt, st, max_det=max_det, iou_threshold=0.5, score_threshold=thr)


def _train_pair(stage, device, dtype=torch.float32, size=64, batch=2, classes=4):
    """One train step (TF32 off) of seeded MobileNetV2 x0.75 with
    calibrated BatchNorm, on ``device`` at ``dtype`` compute, the loss
    included (targets at ``dtype``): (metrics, gradients by leaf, state
    dict before, state dict after, labels)."""
    from yoloret_tpu_torch.nn.detector import YoloReT
    from yoloret_tpu_torch.nn.layers import calibrate_bn, init_weights
    from yoloret_tpu_torch.ops.targets import assign_targets_batch, true_corner_boxes
    from yoloret_tpu_torch.train.freeze import backbone_freeze_mask
    from yoloret_tpu_torch.train.step import StepConfig, TrainState, cosine_lr_schedule
    from yoloret_tpu_torch.train.step import step_gradients

    anchors = np.asarray([[10, 13], [16, 30], [33, 23], [30, 61], [62, 45], [59, 119],
                          [116, 90], [156, 198], [373, 326]], np.float32)
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(batch, size, size, 3).astype(np.float32))
    boxes = np.zeros((batch, 5, 5), np.float32)
    xy = rs.uniform(0, size * 0.6, (batch, 4, 2))
    boxes[:, :4, :2], boxes[:, :4, 2:4] = xy, xy + rs.uniform(6, size * 0.4, (batch, 4, 2))
    boxes[:, :4, 4] = rs.randint(0, classes, (batch, 4))
    b = torch.from_numpy(boxes)
    ys = assign_targets_batch(b, (size, size), torch.from_numpy(anchors), classes)
    gt, gv = true_corner_boxes(b, (size, size))
    data = {"images": x, "gt_boxes": gt, "gt_valid": gv,
            **{f"y_true_{l}": y for l, y in enumerate(ys)}}
    model = YoloReT("mobilenetv2x75", classes)
    init_weights(model, torch.Generator().manual_seed(0))
    calibrate_bn(model.eval(), x)
    model.dtype = dtype
    model.to(device)
    labels = (backbone_freeze_mask(n for n, _ in model.named_parameters())
              if stage == 1 else None)
    state = TrainState(model, cosine_lr_schedule(1e-3, 2, 1), labels)
    before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    data = {k: v.to(device, dtype) if k.startswith("y_true") else v.to(device)
            for k, v in data.items()}
    grads, m = step_gradients(state, data,
                              StepConfig(anchors=tuple(map(tuple, anchors.tolist())),
                                         backbone_train=stage == 2))
    state.apply_gradients(grads)
    after = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    grads = {n: g.detach().cpu().double() for n, g in zip(state.names, grads)}
    return {k: float(v) for k, v in m.items()}, grads, before, after, labels


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [2, 1])
def test_train_step_matches_cpu(cuda, stage):
    """The card's step against the CPU's. The loss within 1e-5 relative.
    The gradients against the CPU's float64 step: the card's float64 step
    within 1e-7 relative on every leaf, and the card's float32 step at
    most 30 times as far from it as the CPU's float32 step, in the median
    over the leaves (TF32 or bfloat16 compute would be many times farther;
    train-mode BatchNorms cancel most of some leaves' gradients, so their
    float32 rounding reaches ~1e-2 of them and no per-leaf float32 limit
    holds much); a leaf whose float64 gradient is below 1e-9 of the
    largest leaf's is 0 in exact arithmetic and left out. After the step
    the running statistics within 1e-4 of the larger of their leaf's
    largest magnitude and 1e-3 of the model's largest statistic of their
    kind, and 99.9% of the parameters within 1e-5 + 1e-4 relative. Stage
    1: the frozen parameters and the backbone's statistics bitwise
    unchanged on the card."""
    m_gpu, g_gpu, before, got, labels = _train_pair(stage, "cuda")
    m_cpu, g_cpu, _, want, _ = _train_pair(stage, "cpu")
    _, g64_gpu, _, _, _ = _train_pair(stage, "cuda", torch.float64)
    _, ref, _, _, _ = _train_pair(stage, "cpu", torch.float64)
    assert abs(m_gpu["loss"] - m_cpu["loss"]) <= 1e-5 * abs(m_cpu["loss"])
    top = max(float(r.norm()) for r in ref.values())
    kept = [n for n, r in ref.items() if float(r.norm()) > 1e-9 * top]

    def rel(g):
        return {n: float((g[n] - ref[n]).norm() / ref[n].norm()) for n in kept}

    def median(r):
        return sorted(r.values())[len(r) // 2]

    rel64 = rel(g64_gpu)
    worst = max(rel64, key=rel64.get)
    assert rel64[worst] <= 1e-7, (worst, rel64[worst])
    card, cpu = median(rel(g_gpu)), median(rel(g_cpu))
    assert card <= 30 * cpu, (card, cpu)
    tops = {kind: max(float(v.abs().max()) for k, v in want.items() if k.endswith(kind))
            for kind in ("running_mean", "running_var")}
    close = n = 0
    for k, w in want.items():
        d = (got[k] - w).abs()
        kind = next((x for x in tops if k.endswith(x)), None)
        if kind:
            assert float(d.max()) <= 1e-4 * max(float(w.abs().max()), 1e-3 * tops[kind]), k
            continue
        close += int((d <= 1e-5 + 1e-4 * w.abs()).sum())
        n += w.numel()
    assert close >= 0.999 * n, (close, n)
    if stage == 1:
        for k, v in before.items():
            if k.startswith("body.") and (labels.get(k) == "frozen" or "running" in k):
                assert torch.equal(got[k], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("mosaic,mixup", [(0.5, 0.5), (0.0, 0.7)])
def test_mix_batch_matches_cpu(cuda, mosaic, mixup):
    """The online mosaic and mixup on the card against the same call on
    the CPU with the same draws: images within 1e-5 (float32, TF32 off),
    boxes within 1e-4 px, ``valid`` equal."""
    from yoloret_tpu_torch.data.augment import AugmentConfig, draw_mix, mix_batch

    rs = np.random.RandomState(2)
    b, t = 8, 20
    images = torch.from_numpy(rs.rand(b, 352, 352, 3).astype(np.float32))
    lo = rs.uniform(0, 300, (b, t, 2))
    boxes = torch.from_numpy(np.concatenate(
        [lo, lo + rs.uniform(1, 120, (b, t, 2)), rs.randint(0, 20, (b, t, 1))], -1)
        .astype(np.float32))
    valid = torch.from_numpy(rs.rand(b, t) < 0.6)
    cfg = AugmentConfig(input_hw=(352, 352), mosaic_prob=mosaic, mixup_prob=mixup)
    draws = draw_mix(b, cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    want = mix_batch(images, boxes, valid, cfg, draws)
    got = mix_batch(images.to(cuda), boxes.to(cuda), valid.to(cuda), cfg,
                    {k: v.to(cuda) for k, v in draws.items()})
    torch.testing.assert_close(got[0].cpu(), want[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(got[1].cpu(), want[1], atol=1e-4, rtol=0)
    assert torch.equal(got[2].cpu(), want[2])

