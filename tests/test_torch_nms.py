"""Greedy NMS of the port vs the JAX package on the edges the shared-pool
kernel must get exactly right, and what that kernel's design rests on.

On the CPU ``suppress`` takes its plain version. Held here, exactly,
against ``_suppress_lax_shared`` and the Pallas ``nms_fused`` (interpret
mode) on the cases of ``tests/test_torch_cuda.py::NMS_CASES`` (ties,
IoU at the threshold, identical and zero-area boxes, nothing above the
score threshold, one image, 3 and 20 classes); the card tests hold the
kernel against the plain version on the same cases. Also here: the box
IoU is symmetric (the kernel computes each pair once), the kernel's
margin test decides as the division does, its algorithm (mask once,
then one mask row per round) gives the plain result, and its launch plan;
the large-pool walk's algorithm; and the per-class kernel's (order test
over its lane slots, then the walk or the rounds) under hypothesis.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from test_torch_cuda import (AT_THRESHOLD, NMS_CASES, NMS_MAX_DET, PER_CLASS_ORDERS,
                             large_pool_case, lane_group, nms_case, per_class_pools)
from yoloret_tpu.ops.nms_pallas import nms_fused
from yoloret_tpu.ops.postprocess import _suppress_lax, _suppress_lax_shared
from yoloret_tpu_torch.ops.boxes import iou
from yoloret_tpu_torch.ops.nms_kernel import (
    MAX_CANDIDATES, PER_CLASS_WARPS, ROUNDS_WARPS, ROUNDS_WARPS_GLOBAL, SMEM_LIMIT, WALK_WARPS,
    large_smem_bytes, large_staged_bytes, per_class_smem_bytes, plan_nms, shared_smem_bytes,
    suppress, suppress_plain, walk_smem_bytes)

torch.set_num_threads(1)
IOU_THR = 0.5


@pytest.mark.parametrize("ref", ["lax_shared", "pallas"])
@pytest.mark.parametrize("name", sorted(NMS_CASES))
def test_suppress_matches_jax_exactly(name, ref):
    boxes, scores, thr = nms_case(name)
    kw = dict(iou_threshold=IOU_THR, score_threshold=thr)
    before = suppress.launches
    pb, ps = suppress(torch.from_numpy(boxes), torch.from_numpy(scores), max_det=NMS_MAX_DET,
                      **kw)
    assert suppress.launches == before  # a CPU tensor takes the plain version
    if ref == "lax_shared":
        jb, js = _suppress_lax_shared(jnp.asarray(boxes), jnp.asarray(scores),
                                      max_det=NMS_MAX_DET, **kw)
    else:
        b, c, m = scores.shape
        cls_boxes = np.ascontiguousarray(np.broadcast_to(boxes[:, None], (b, c, m, 4)))
        jb, js = nms_fused(jnp.asarray(cls_boxes), jnp.asarray(scores),
                           max_det_per_class=NMS_MAX_DET, interpret=True, **kw)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    if name == "below_threshold":
        assert not ps.any()


def test_iou_at_threshold_does_not_suppress():
    """IoU exactly 0.5 is not above 0.5: both boxes of each exact pair are
    kept in every class."""
    boxes, scores, thr = nms_case("iou_at_threshold")
    pb, _ = suppress(torch.from_numpy(boxes), torch.from_numpy(scores), max_det=NMS_MAX_DET,
                     iou_threshold=IOU_THR, score_threshold=thr)
    exact = torch.tensor([q for pair in AT_THRESHOLD[:4] for q in pair], dtype=torch.float32)
    assert float(iou(exact[0], exact[1])) == IOU_THR
    for kept in pb[0]:
        assert all((kept == box).all(-1).any() for box in exact)


def test_ties_go_to_the_lowest_index():
    boxes = torch.tensor([[[0., 0, 1, 1], [0, 0, 1, 1], [5, 5, 6, 6], [5, 5, 6, 6]]])
    scores = torch.tensor([[[0.5, 0.5, 0.5, 0.5], [-0.0, 0.0, 0.0, -0.0]]])
    ob, os_ = suppress(boxes, scores, max_det=3, iou_threshold=IOU_THR, score_threshold=0.0)
    # class 0: index 0 kills 1, then index 2 kills 3; class 1 the same (-0 == +0)
    for c in range(2):
        np.testing.assert_array_equal(ob[0, c, :2].numpy(), boxes[0, [0, 2]].numpy())
        assert float(os_[0, c, 2]) == 0.0
    assert str(float(os_[0, 1, 0])) == "-0.0"  # the score of index 0, bit for bit


def _adversarial_boxes(rs, n):
    """Random boxes mixed with identical, zero-area, inverted, touching,
    huge, tiny, signed-zero, one-ulp-apart and infinite ones."""
    b = (rs.rand(n, 4) * 10).astype(np.float32)
    b[:, 2:] = b[:, :2] + (rs.rand(n, 2) * 5).astype(np.float32)
    q = n // 10
    b[:q] = b[q:2 * q]  # identical
    b[q:2 * q, 2] = b[q:2 * q, 0]  # flat
    b[2 * q:3 * q, 3] = b[2 * q:3 * q, 1] - 1  # inverted
    b[3 * q:4 * q, 0] = b[4 * q:5 * q, 2]  # touching edges
    b[5 * q:6 * q] *= np.float32(1e30)
    b[6 * q:7 * q] *= np.float32(1e-30)
    b[7 * q:8 * q, :2] = np.where(rs.rand(q, 2) < 0.5, -0.0, 0.0)
    b[8 * q:9 * q] = np.nextafter(b[9 * q:10 * q], np.float32(np.inf))
    b[9 * q, 3] = np.inf
    return torch.from_numpy(b)


@pytest.mark.parametrize("kind", ["random", "adversarial"])
def test_iou_is_symmetric_bitwise(kind):
    """iou(a, b) == iou(b, a).T bit for bit (zeros counted equal whatever
    their sign, which no comparison sees; NaN where the other is NaN):
    the shared-pool kernel computes each pair once for both rows."""
    rs = np.random.RandomState(7)
    if kind == "random":
        a = torch.from_numpy((rs.rand(300, 4) * 100).astype(np.float32))
        a[:, 2:] += a[:, :2]
    else:
        a = _adversarial_boxes(rs, 300)
    ab = iou(a[:, None], a[None, :])
    ba = iou(a[None, :], a[:, None]).T
    assert torch.equal(ab.isnan(), ba.isnan())
    ok = ~ab.isnan()
    assert torch.equal((ab[ok] + 0.0).view(torch.int32), (ba[ok] + 0.0).view(torch.int32))
    if kind == "adversarial":
        assert ab.isnan().any() and (ab[ok] == 1).any() and (ab[ok] == 0).any()


def _decide(inter, uni, thr, divide_all=False):
    """The kernel's test of iou > thr in numpy float32: inter against thr *
    (1 +- 2^-18) * union where that settles it, else the division; every
    pair divided when ``divide_all`` or thr is outside [2^-60, 2^60].
    Returns (decision, where the division was needed)."""
    f32 = np.float32
    if divide_all or not 2.0 ** -60 <= thr <= 2.0 ** 60:
        hi, lo = f32(np.inf), f32(-np.inf)
    else:
        hi, lo = f32(thr * (1 + 2.0 ** -18)), f32(thr * (1 - 2.0 ** -18))
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        above, below = inter > hi * uni, inter < lo * uni
        exact = np.where(uni != 0, inter / np.where(uni != 0, uni, f32(1)), f32(0)) > f32(thr)
    settled = above | below
    return np.where(settled, above, exact), ~settled


def _kill_mask(bx, thr):
    """The shared-pool kernel's phase 1 in numpy float32: kill[i, j] =
    iou(i, j) > thr by ``_decide`` (every pair divided in an image with an
    area in (0, 2^-58)), the diagonal set."""
    f32 = np.float32
    p, q = bx[:, None], bx[None, :]
    with np.errstate(invalid="ignore", over="ignore"):
        area = np.maximum(f32(0), bx[:, 3] - bx[:, 1]) * np.maximum(f32(0), bx[:, 2] - bx[:, 0])
        iy = np.maximum(f32(0), np.minimum(p[..., 2], q[..., 2]) - np.maximum(p[..., 0], q[..., 0]))
        ix = np.maximum(f32(0), np.minimum(p[..., 3], q[..., 3]) - np.maximum(p[..., 1], q[..., 1]))
        inter = ix * iy
        uni = area[:, None] + area[None, :] - inter
    kill, divided = _decide(inter, uni, thr,
                            divide_all=bool(((area > 0) & (area < f32(2.0 ** -58))).any()))
    np.fill_diagonal(kill, True)
    return kill, divided


def _mask_greedy(boxes, scores, max_det, iou_threshold, score_threshold):
    """The shared-pool kernel's algorithm: the mask once per image, then
    per class max_det rounds of argmax (ties to the lowest index) and one
    mask row to deactivate."""
    b, c, m = scores.shape
    out_b = np.zeros((b, c, max_det, 4), np.float32)
    out_s = np.zeros((b, c, max_det), np.float32)
    for i in range(b):
        kill, _ = _kill_mask(boxes[i], iou_threshold)
        for k in range(c):
            s = scores[i, k]
            active = (s >= score_threshold) & (s > -np.inf)
            for r in range(max_det):
                if not active.any():
                    break
                p = int(np.argmax(np.where(active, s, -np.inf)))
                out_b[i, k, r], out_s[i, k, r] = boxes[i, p], s[p]
                active &= ~kill[p]
    return out_b, out_s


@pytest.mark.parametrize("name", sorted(NMS_CASES))
def test_mask_algorithm_matches_plain(name):
    boxes, scores, thr = nms_case(name)
    kw = dict(max_det=NMS_MAX_DET, iou_threshold=IOU_THR, score_threshold=thr)
    mb, ms = _mask_greedy(boxes, scores, **kw)
    pb, ps = suppress_plain(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    np.testing.assert_array_equal(ms, ps.numpy())
    np.testing.assert_array_equal(np.signbit(ms), np.signbit(ps.numpy()))
    np.testing.assert_array_equal(mb, pb.numpy())


@pytest.mark.parametrize("thr", [0.3, 0.45, 0.5, 0.7, 0.95])
def test_margin_test_decides_as_the_division(thr):
    """Unions and intersections within 64 ulps of inter = thr * union,
    nested boxes whose IoU is within 40 ulps of thr, and adversarial
    boxes: the margin test and the division always agree, and both paths
    are taken. Where thr is not a power of two, comparing inter with
    thr * union alone, without the division, gets some of them wrong."""
    f32 = np.float32
    rs = np.random.RandomState(int(thr * 1000))
    uni = (rs.rand(100000) * 100 + 1e-3).astype(f32)
    steps = rs.randint(-64, 65, uni.size).astype(np.int32)
    inter = ((f32(thr) * uni).view(np.int32) + steps).view(f32)
    got, divided = _decide(inter, uni, thr)
    np.testing.assert_array_equal(got, inter / uni > f32(thr))
    assert divided.any() and not divided.all()
    # the sample reaches pairs where only the division decides right
    assert ((inter > f32(thr) * uni) != got).any() or thr == 0.5

    n = 400
    h = (rs.rand(n) * 50 + 1e-3).astype(f32)
    w = (rs.rand(n) * 50 + 1e-3).astype(f32)
    w2 = ((f32(thr) * w).view(np.int32) + rs.randint(-40, 41, n).astype(np.int32)).view(f32)
    y0 = (rs.rand(n) * 100).astype(f32)
    x0 = (rs.rand(n) * 100).astype(f32)
    big = np.stack([y0, x0, y0 + h, x0 + w], -1)
    small = np.stack([y0, x0, y0 + h, x0 + w2], -1)
    bx = np.concatenate([big, small, _adversarial_boxes(rs, 200).numpy()]).astype(f32)
    kill, divided = _kill_mask(bx, thr)
    want = (iou(torch.from_numpy(bx)[:, None], torch.from_numpy(bx)[None, :]) > thr).numpy()
    np.fill_diagonal(want, True)
    np.testing.assert_array_equal(kill, want)
    assert divided.any() and (~divided).sum() > divided.sum()


def test_tiny_areas_divide_every_pair():
    """An image with a nonzero area below 2^-58 (where the margin test's
    products could be subnormal) has every pair divided, and the mask is
    still the plain one."""
    rs = np.random.RandomState(11)
    bx = (rs.rand(96, 4) * 10).astype(np.float32)
    bx[:, 2:] = bx[:, :2] + (rs.rand(96, 2) * 5).astype(np.float32)
    bx[:48] *= np.float32(1e-19)  # areas ~1e-38
    kill, divided = _kill_mask(bx, IOU_THR)
    want = (iou(torch.from_numpy(bx)[:, None], torch.from_numpy(bx)[None, :]) > IOU_THR).numpy()
    np.fill_diagonal(want, True)
    np.testing.assert_array_equal(kill, want)
    assert divided.all() and want[:48, :48].sum() > 48


# -- launch plan ---------------------------------------------------------


def test_plan_serving_and_map_grade():
    """b128 C=20: serving M=64 and MAP grade M=512, max_det 20."""
    serving = plan_nms(20, 64, 20, shared=True)
    assert serving == ("shared", 2, 20, 20, 16 * 64 + 4 * 64 * 2 + 4 * 64 + 4 * 20 * 64
                       + 4 * 20 * 20)
    mapg = plan_nms(20, 512, 20, shared=True)
    assert mapg.variant == "shared" and mapg.npl == 16 and mapg.warps == 32
    assert mapg.classes_per_pass == 20 and 48 * 1024 < mapg.smem <= SMEM_LIMIT
    # the mask is M x M bits: 32 KB at M=512, 512 B at M=64
    assert 4 * 32 * 16 * 16 == 32 * 1024 and 4 * 32 * 2 * 2 == 512
    assert plan_nms(20, 512, 20, shared=False) == ("per_class", 16, 4, 20, 4 * (20 * 24 + 640))


@pytest.mark.parametrize("k", [1, 31, 32, 33, 64, 65, 100, 200, 256, 257, 511, 512])
def test_plan_fits_every_shape(k):
    for c in (1, 3, 5, 20, 80, 91, 300):
        for max_det in (1, 20, 100, 1000):
            p = plan_nms(c, k, max_det, shared=True)
            assert p.variant == "shared" and 32 * p.npl >= k and (p.npl == 1 or k > 16 * p.npl)
            assert 8 <= p.warps <= 32 and p.warps >= min(c, 32)
            tiles = -(-k // 32)
            assert p.warps >= min(32, tiles * (tiles + 1) // 2)
            assert 1 <= p.classes_per_pass <= c and p.smem <= SMEM_LIMIT
            assert p.smem == shared_smem_bytes(p.npl, k, p.classes_per_pass, p.warps, max_det)
            if p.classes_per_pass < c:  # as many classes per pass as fit
                assert shared_smem_bytes(p.npl, k, p.classes_per_pass + 1, p.warps,
                                         max_det) > SMEM_LIMIT


def test_plan_limits():
    most = (SMEM_LIMIT - 16 * ROUNDS_WARPS_GLOBAL) // 4  # keys alone fill shared memory
    assert large_smem_bytes(most) == SMEM_LIMIT
    for shared in (True, False):
        assert plan_nms(20, MAX_CANDIDATES + 1, 20, shared).variant == "per_class_large"
        assert plan_nms(20, most, 20, shared).smem == SMEM_LIMIT
        with pytest.raises(ValueError):  # keys beyond shared memory
            plan_nms(20, most + 1, 20, shared)
        with pytest.raises(ValueError):  # the walk's picks beyond shared memory
            plan_nms(20, 1000, SMEM_LIMIT // 20 + 1, shared)
    with pytest.raises(ValueError):
        plan_nms(20, 0, 20, shared=True)
    # pick buffers beyond shared memory even at one class per pass
    assert plan_nms(20, 512, 60000, shared=True).variant == "per_class"
    assert plan_nms(200, 512, 20, shared=True).classes_per_pass == 91


def test_plan_coco_shapes():
    """C=80, max_det 20: the shared pool of both COCO configs at serving
    (M=64) and MAP grade (M=512), and the exact evaluation's whole grid at
    224 (K=3,087) and 416 (K=10,647)."""
    assert plan_nms(80, 64, 20, shared=True) == ("shared", 2, 32, 80, 24832)
    assert plan_nms(80, 512, 20, shared=True) == ("shared", 16, 32, 80, 209408)
    assert shared_smem_bytes(16, 512, 80, 32, 20) == 209408 <= SMEM_LIMIT
    for shared in (False, True):
        assert plan_nms(80, 3087, 20, shared) == ("per_class_large", 4, 32, 80, 62256)
        assert plan_nms(80, 10647, 20, shared) == ("per_class_large", 11, 32, 80, 213456)
    assert large_smem_bytes(10647) == 16 * 10647 + 4 * 10648 + 16 * 32 == 213456


@pytest.mark.parametrize("k,shared,thr", [(64, True, 0.3), (512, True, 0.0),
                                          (3087, False, 0.0)])
def test_plain_matches_jax_at_80_classes(k, shared, thr):
    """Random boxes and distinct scores at C=80, exactly against
    ``_suppress_lax_shared`` / ``_suppress_lax``."""
    rs = np.random.RandomState(k)
    b, c = 2, 80
    shape = (b, k) if shared else (b, c, k)
    boxes = rs.rand(*shape, 4).astype(np.float32) * 224
    boxes[..., 2:] = boxes[..., :2] + rs.rand(*shape, 2).astype(np.float32) * 40
    scores = (rs.permutation(b * c * k).reshape(b, c, k) / (b * c * k)).astype(np.float32)
    kw = dict(max_det=NMS_MAX_DET, iou_threshold=IOU_THR, score_threshold=thr)
    ref = _suppress_lax_shared if shared else _suppress_lax
    jb, js = ref(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    pb, ps = suppress(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    assert (ps > 0).sum() > b * c


@pytest.mark.parametrize("k", [513, 1000, 6300, 10647, 30000, 58000])
def test_plan_large_pools(k):
    """Pools above 512, shared or per-class, take the large-pool kernels:
    the rounds with the boxes staged in shared memory where K x 20 B fit
    (32 warps), else the keys alone (16 warps); the walk's picks."""
    staged = large_staged_bytes(k) <= SMEM_LIMIT
    assert staged == (k <= 11596)
    for shared in (True, False):
        for max_det in (1, 20, 1000):
            p = plan_nms(20, k, max_det, shared)
            assert p.variant == "per_class_large" and p.classes_per_pass == 20
            assert p.warps == (ROUNDS_WARPS if staged else ROUNDS_WARPS_GLOBAL)
            assert 32 * p.warps * p.npl >= k > 32 * p.warps * (p.npl - 1)
            assert p.smem == large_smem_bytes(k) <= SMEM_LIMIT and p.smem >= 4 * k
            assert (p.smem >= 20 * k) == staged
            assert walk_smem_bytes(max_det) == 20 * max_det
    assert plan_nms(20, 512, 20, shared=False).variant == "per_class"


@pytest.mark.parametrize("c", [20, 80])
@pytest.mark.parametrize("k,want", [
    (513, (1, 32, 10784)), (3087, (4, 32, 62256)), (6300, (7, 32, 126512)),
    (10647, (11, 32, 213456)), (11597, (23, 16, 46656))])
def test_plan_large_pools_at_exact_shapes(c, k, want):
    """The exact evaluation's whole grid at 224 (3,087), 320 (6,300) and
    416 (10,647), the smallest large pool and the first pool whose boxes
    no longer fit beside its keys (11,597): (npl, warps, smem) of the
    rounds, the same shared or not; csrc/nms.cu refuses any other plan."""
    for shared in (False, True):
        assert plan_nms(c, k, NMS_MAX_DET, shared) == ("per_class_large", *want[:2], c, want[2])
    assert large_staged_bytes(k - 1) <= SMEM_LIMIT or k == 11597
    assert WALK_WARPS == 4 and walk_smem_bytes(NMS_MAX_DET) == 400


@pytest.mark.parametrize("k", [513, 6300])
@pytest.mark.parametrize("shared", [False, True])
def test_large_pool_plain_matches_jax(k, shared):
    """The plain version on large pools (tied scores, -0, pairs at IoU
    0.5; ``tests/test_torch_cuda.py`` holds the large-pool kernel to it)
    against ``_suppress_lax`` / ``_suppress_lax_shared``, exactly, and
    with an empty score of -inf only the empty slots differ."""
    boxes, scores = large_pool_case(k, shared=shared)
    kw = dict(max_det=NMS_MAX_DET, iou_threshold=IOU_THR, score_threshold=0.25)
    ref = _suppress_lax_shared if shared else _suppress_lax
    jb, js = ref(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    pb, ps = suppress(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    assert (ps > 0).any() and (ps == 0).any()
    _, ps_inf = suppress(torch.from_numpy(boxes), torch.from_numpy(scores),
                         empty_score=float("-inf"), **kw)
    empty = ps_inf == float("-inf")
    assert empty.any() and torch.equal(ps_inf[~empty], ps[~empty]) and not ps[empty].any()


# -- the large-pool walk: what it rests on, and its algorithm --------------


def _kills(p, q, thr):
    """The large-pool kernels' test of iou(p, q) > thr (p the pick, q [N,
    4]) in numpy float32: the margin test where the union is at least
    2^-58 and it settles the comparison, else the division."""
    f32 = np.float32
    with np.errstate(invalid="ignore", over="ignore"):
        pa = np.maximum(f32(0), p[3] - p[1]) * np.maximum(f32(0), p[2] - p[0])
        qa = np.maximum(f32(0), q[:, 3] - q[:, 1]) * np.maximum(f32(0), q[:, 2] - q[:, 0])
        iy = np.maximum(f32(0), np.minimum(p[2], q[:, 2]) - np.maximum(p[0], q[:, 0]))
        ix = np.maximum(f32(0), np.minimum(p[3], q[:, 3]) - np.maximum(p[1], q[:, 1]))
        inter = ix * iy
        uni = pa + qa - inter
    kill, _ = _decide(inter, uni, thr)
    exact, _ = _decide(inter, uni, thr, divide_all=True)
    return np.where(uni >= f32(2.0 ** -58), kill, exact)


def _walk_pool(boxes, scores, max_det, iou_threshold, score_threshold):
    """``csrc/nms.cu::nms_large_walk`` on one pool (boxes [K, 4], scores
    [K]) in numpy: None where a key is below its successor's (the pool
    goes to the rounds), else the picks' indices and the candidates read:
    chunks of 32 in index order, each candidate tested against the picks
    so far, then the chunk's survivors resolved lowest lane first; the walk
    ends at the max_det-th pick or after the chunk with the first
    inactive key."""
    active = (scores >= score_threshold) & (scores > -np.inf)
    key = np.where(active, scores, -np.inf)
    if (key[:-1] < key[1:]).any():
        return None
    picks, read = [], 0
    for base in range(0, len(scores), 32):
        if len(picks) == max_det:
            break
        live = active[base:base + 32]
        alive = live.copy()
        read = base + len(live)
        for j in picks:
            alive &= ~_kills(boxes[j], boxes[base:base + 32], iou_threshold)
        while alive.any() and len(picks) < max_det:
            lane = int(np.argmax(alive))
            picks.append(base + lane)
            alive[:lane + 1] = False
            alive &= ~_kills(boxes[base + lane], boxes[base:base + 32], iou_threshold)
        if not live.all() or len(live) < 32:
            break
    return picks, read


def _sorted_pools(boxes, scores):
    """Per-class pools [B, C, K, 4] of a shared box set [B, K, 4], each
    class's candidates in a stable descending sort of its scores, as
    ``per_class_candidates`` orders them."""
    s, idx = torch.sort(torch.from_numpy(scores), dim=-1, descending=True, stable=True)
    b, c, k = scores.shape
    bx = torch.gather(torch.from_numpy(boxes)[:, None].expand(b, c, k, 4), 2,
                      idx[..., None].expand(b, c, k, 4))
    return bx.contiguous().numpy(), s.contiguous().numpy()


@st.composite
def _pools(draw):
    """One image's sorted per-class pools: integer boxes on a small grid
    (overlaps, identical boxes), the pairs of AT_THRESHOLD (IoU 0.5
    exactly and by rounding) at random places, scores in eighths (ties,
    -0 beside +0, some negative), and a score threshold that leaves all,
    some or none of them active."""
    c, k = draw(st.integers(1, 3)), draw(st.integers(1, 200))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    rs = np.random.RandomState(seed)
    grid = draw(st.sampled_from([4, 12, 40]))
    yx = rs.randint(0, grid, (1, k, 2)).astype(np.float32)
    boxes = np.concatenate([yx, yx + rs.randint(1, 9, (1, k, 2))], -1).astype(np.float32)
    pairs = np.array([q for pair in AT_THRESHOLD for q in pair], np.float32)
    at = rs.choice(k, min(k, len(pairs)), replace=False)
    boxes[0, at] = pairs[:len(at)]
    scores = (rs.randint(-2, 9, (1, c, k)) / 8).astype(np.float32)
    scores[(scores == 0) & (rs.rand(1, c, k) < 0.5)] = -0.0
    thr = draw(st.sampled_from([0.0, 0.25, 0.5, 2.0, float("-inf")]))
    max_det = draw(st.sampled_from([1, 3, 20, 60]))
    return (*_sorted_pools(boxes, scores), thr, max_det)


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(_pools())
def test_sorted_pool_needs_only_its_prefix(pool):
    """On a pool in stable descending order, greedy NMS on the prefix up
    to the last pick gives what it gives on the whole pool (the fact the
    walk rests on); the walk's picks are greedy's, and it reads at most
    the chunk of 32 that holds the last pick, or of the first inactive
    candidate. Ties, IoU exactly 0.5, no active candidate, fewer picks
    than max_det."""
    boxes, scores, thr, max_det = pool
    kw = dict(max_det=max_det, iou_threshold=IOU_THR, score_threshold=thr)
    empty = dict(kw, empty_score=float("-inf"))  # empty slots told from picks of score 0
    for c in range(scores.shape[1]):
        bx, sc = boxes[:, c:c + 1], scores[:, c:c + 1]
        want = suppress_plain(torch.from_numpy(bx), torch.from_numpy(sc), **empty)
        walked = _walk_pool(bx[0, 0], sc[0, 0], **kw)
        assert walked is not None  # a stable descending sort passes the order test
        picks, read = walked
        assert int(torch.isfinite(want[1]).sum()) == len(picks)
        np.testing.assert_array_equal(want[1][0, 0, :len(picks)].numpy(), sc[0, 0, picks])
        np.testing.assert_array_equal(want[0][0, 0, :len(picks)].numpy(), bx[0, 0, picks])
        active = int(((sc[0, 0] >= thr) & (sc[0, 0] > -np.inf)).sum())
        assert len(picks) <= min(active, max_det)
        last = picks[-1] + 1 if picks else 0
        # never past the chunk of the last pick, or of the first inactive candidate
        end = last if len(picks) == max_det else active + 1
        assert read <= min(-(-end // 32) * 32, sc.shape[-1])
        cut = max(last, 1)
        got = suppress_plain(torch.from_numpy(np.ascontiguousarray(bx[:, :, :cut])),
                             torch.from_numpy(np.ascontiguousarray(sc[:, :, :cut])), **empty)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
            np.testing.assert_array_equal(np.signbit(g.numpy()), np.signbit(w.numpy()))
        if active == 0:
            assert picks == [] and read <= 32


def _walk_all(boxes, scores, **kw):
    """``_walk_pool`` over per-class pools [B, C, K, 4], laid out as the
    kernel's outputs (empty slots: zero box, score 0); None if any pool is
    unsorted."""
    b, c, _ = scores.shape
    out_b = np.zeros((b, c, kw["max_det"], 4), np.float32)
    out_s = np.zeros((b, c, kw["max_det"]), np.float32)
    for i in range(b):
        for j in range(c):
            walked = _walk_pool(boxes[i, j], scores[i, j], **kw)
            if walked is None:
                return None
            picks = walked[0]
            out_b[i, j, :len(picks)], out_s[i, j, :len(picks)] = boxes[i, j, picks], scores[i, j, picks]
    return out_b, out_s


@pytest.mark.parametrize("case", ["ties", "distinct", "one_inversion", "shuffled"])
def test_walk_algorithm_matches_plain(case):
    """The walk model on sorted large pools (``large_pool_case`` sorted:
    ties in eighths, pairs at IoU 0.5, an all-negative pool) equals the
    plain version exactly; one inversion at the last index, or a shuffle,
    sends the pool to the rounds."""
    boxes, scores = large_pool_case(700, b=2, c=3, shared=True)
    if case == "distinct":
        rs = np.random.RandomState(2)
        scores = (rs.permutation(scores.size).reshape(scores.shape) / scores.size).astype(
            np.float32)
    bx, sc = _sorted_pools(boxes, scores)
    if case == "one_inversion":
        sc[0, 1, -1] = sc[0, 1, 0] + 1
    elif case == "shuffled":
        perm = np.random.RandomState(3).permutation(sc.shape[-1])
        bx, sc = bx[:, :, perm], sc[:, :, perm]
    kw = dict(max_det=NMS_MAX_DET, iou_threshold=IOU_THR, score_threshold=0.25)
    walked = _walk_all(bx, sc, **kw)
    if case in ("one_inversion", "shuffled"):
        assert walked is None
        return
    want = suppress_plain(torch.from_numpy(bx), torch.from_numpy(sc), **kw)
    np.testing.assert_array_equal(walked[1], want[1].numpy())
    np.testing.assert_array_equal(np.signbit(walked[1]), np.signbit(want[1].numpy()))
    np.testing.assert_array_equal(walked[0], want[0].numpy())
    assert (want[1] > 0).any() and ((want[1] == 0).any() or case == "distinct")


# -- the per-class kernel (pools up to 512): its algorithm -------------------


def _active_keys(scores, thr):
    """``csrc/nms.cu::active_key`` in numpy: float32 scores as unsigned keys
    that order as the floats do (-0 = +0), 0 for an inactive score."""
    v = np.asarray(scores, np.float32)
    u = np.where(v == 0, np.float32(0), v).astype(np.float32).view(np.uint32)
    key = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000)).astype(np.uint32)
    return np.where((v >= thr) & (v > -np.inf), key, np.uint32(0))


def _lane_slots(k):
    """(npl, g, index [32, npl]) of ``nms_kernel<npl>``: slot u g + j of
    lane l holds candidate g (l + 32 u) + j (16-byte groups of g scores,
    group l + 32 u of lane l)."""
    npl = next(n for n in (1, 2, 4, 8, 16) if 32 * n >= k)
    g = lane_group(k)
    slot = np.arange(npl)[None, :]
    return npl, g, g * (np.arange(32)[:, None] + 32 * (slot // g)) + slot % g


def _per_class_order(scores, thr):
    """The kernel's order test on one pool: its keys in the lane slots
    (0 past the end), no key below its successor inside a group, and each
    group's last key against the next group's first (lane l + 1's group
    u, or lane 0's group u + 1 for lane 31). Returns (sorted, keys [32,
    npl], the count of active keys)."""
    k = len(scores)
    npl, g, idx = _lane_slots(k)
    keys = np.where(idx < k, _active_keys(scores, thr)[np.minimum(idx, k - 1)], np.uint32(0))
    ok = True
    for u in range(npl // g):
        for j in range(1, g):
            ok &= bool((keys[:, u * g + j - 1] >= keys[:, u * g + j]).all())
        nxt = np.roll(keys[:, u * g], -1)  # lane l: lane l + 1's first
        nxt[31] = keys[0, (u + 1) * g] if u + 1 < npl // g else 0
        ok &= bool((keys[:, u * g + g - 1] >= nxt).all())
    return ok, keys, int((keys != 0).sum())


def _per_class_model(boxes, scores, max_det, iou_threshold, score_threshold, empty_score):
    """``csrc/nms.cu::nms_kernel`` on one pool (boxes [K, 4], scores [K]) in
    numpy: the order test; on a sorted pool the walk over the active prefix
    in chunks of 32 (the next chunk's boxes fetched while a chunk is
    tested; chunk 0 while the scores arrive), each lane's candidate tested
    against the picks so far, then the chunk's own order from its kill
    bits (each survivor against the earlier ones, once), lowest survivor
    first; on an unsorted pool the rounds (the lowest index holding the top
    key, the kill test on every slot); every kill by ``_kills`` (the
    margin test).
    Returns (boxes [D, 4], scores [D], "walk" or "rounds", boxes read)."""
    k = len(scores)
    ordered, keys, n_act = _per_class_order(scores, score_threshold)
    picks, read = [], min(k, 32)
    if ordered:
        for base in range(0, n_act, 32):
            if len(picks) == max_det:
                break
            lanes = base + np.arange(32)
            read = max(read, min(n_act, base + 64))
            q = np.where((lanes < k)[:, None], boxes[np.minimum(lanes, k - 1)], np.float32(0))
            alive = lanes < n_act
            for j in picks:
                alive &= ~_kills(boxes[j], q, iou_threshold)
            # the chunk's own order: km[i, j], survivor j < i kills lane i
            km = np.zeros((32, 32), bool)
            if len(picks) + 1 < max_det and alive.sum() > 1:
                for j in np.nonzero(alive)[0]:
                    km[:, j] = _kills(q[j], q, iou_threshold) & (np.arange(32) > j)
            while alive.any() and len(picks) < max_det:
                lane = int(np.argmax(alive))
                picks.append(base + lane)
                alive &= (np.arange(32) > lane) & ~km[:, lane]
    else:
        _, _, idx = _lane_slots(k)
        qb = np.where((keys != 0)[..., None], boxes[np.minimum(idx, k - 1)], np.float32(0))
        while len(picks) < max_det and keys.max() > 0:
            top = keys.max()
            cand = idx[np.arange(32), keys.argmax(1)]  # each lane's lowest slot of its top key
            p = int(cand[keys.max(1) == top].min())
            picks.append(p)
            kill = _kills(boxes[p], qb.reshape(-1, 4), iou_threshold).reshape(keys.shape)
            keys = np.where((idx == p) | kill, np.uint32(0), keys)
    out_b = np.zeros((max_det, 4), np.float32)
    out_s = np.full(max_det, empty_score, np.float32)
    out_b[:len(picks)], out_s[:len(picks)] = boxes[picks], scores[picks]
    return out_b, out_s, "walk" if ordered else "rounds", read


@st.composite
def _per_class_pools(draw):
    """``per_class_pools`` of one image: 1 or 2 classes of 1 to 512
    candidates, sorted, shuffled or with one inversion at a lane boundary
    or the last index, on a grid of 4 to 160, with or without infinite
    corners; a score threshold, max_det and empty score."""
    boxes, scores = per_class_pools(
        draw(st.integers(1, 512)), c=draw(st.integers(1, 2)),
        order=draw(st.sampled_from(PER_CLASS_ORDERS)), seed=draw(st.integers(0, 2 ** 31 - 1)),
        grid=draw(st.sampled_from([4, 12, 40, 160])), inf_corners=draw(st.booleans()))
    return (boxes, scores, draw(st.sampled_from([0.0, 0.25, float("-inf"), 2.0])),
            draw(st.sampled_from([1, 20, 60])), draw(st.sampled_from([0.0, float("-inf")])))


@settings(max_examples=200, deadline=None, derandomize=True, database=None)
@given(_per_class_pools())
def test_per_class_kernel_algorithm_matches_plain(pools):
    """The per-class kernel's algorithm (``_per_class_model``: lane
    layout, order test, walk or rounds, margin test) equals the plain
    version exactly, signs of zero included; it walks exactly the pools
    whose keys do not increase, and the walk reads no box past the chunk
    after the one that ends it."""
    boxes, scores, thr, max_det, empty = pools
    kw = dict(max_det=max_det, iou_threshold=IOU_THR, score_threshold=thr, empty_score=empty)
    want_b, want_s = suppress_plain(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    for c in range(scores.shape[1]):
        got_b, got_s, branch, read = _per_class_model(boxes[0, c], scores[0, c], **kw)
        np.testing.assert_array_equal(got_s, want_s[0, c].numpy())
        np.testing.assert_array_equal(np.signbit(got_s), np.signbit(want_s[0, c].numpy()))
        np.testing.assert_array_equal(got_b, want_b[0, c].numpy())
        key = np.where((scores[0, c] >= thr) & (scores[0, c] > -np.inf), scores[0, c], -np.inf)
        assert branch == ("walk" if (key[:-1] >= key[1:]).all() else "rounds")
        if branch == "walk":
            n = int(np.isfinite(key).sum())
            picks = int((got_s != empty).sum()) if empty == float("-inf") else None
            last_chunk = (n - 1) // 32 if n else 0
            if picks == max_det:  # ended by its last pick: the chunk after it is in flight
                last = np.nonzero((scores[0, c] == got_s[-1]) & (boxes[0, c] == got_b[-1]).all(-1))
                last_chunk = int(last[0][0]) // 32
            assert read <= max(min(len(key), 32), min(n, 32 * (last_chunk + 2)))


@pytest.mark.parametrize("k", [1, 2, 31, 33, 64, 65, 255, 256, 257, 511, 512])
def test_per_class_order_test_sees_every_inversion(k):
    """The order test over the lane slots finds one inversion at every
    index of a pool of distinct scores (inside a group, at a group's
    boundary within a lane's neighbour, from lane 31 to lane 0's next
    group, at the last index) and none in the pool sorted, and counts
    its active keys."""
    rs = np.random.RandomState(k)
    scores = np.sort(rs.permutation(k).astype(np.float32) / k)[::-1].copy()
    ok, _, n_act = _per_class_order(scores, 0.25)
    assert ok and n_act == int((scores >= 0.25).sum())
    for i in range(1, k):
        bad = scores.copy()
        bad[i] = bad[i - 1] + np.float32(0.5)
        assert not _per_class_order(bad, 0.0)[0], i


@pytest.mark.parametrize("ref", ["lax", "pallas"])
@pytest.mark.parametrize("k", [33, 256])
def test_sorted_per_class_pools_match_jax(k, ref):
    """``suppress_plain`` on sorted per-class pools (``_sorted_pools``, b1
    C=2; K=33: ``nms_case("b1_c3_ragged")``'s first two classes; K=256:
    ``large_pool_case``'s ties in eighths, -0 beside +0 and pairs at IoU
    0.5), the pools the per-class kernel walks, against ``_suppress_lax``
    and the Pallas ``nms_fused`` (interpret mode), exactly."""
    if k == 33:
        boxes, scores, thr = nms_case("b1_c3_ragged")
        scores = np.ascontiguousarray(scores[:, :2])
    else:
        boxes, scores = large_pool_case(256, b=1, c=2, shared=True)
        thr = 0.25
    bx, sc = _sorted_pools(boxes, scores)
    kw = dict(iou_threshold=IOU_THR, score_threshold=thr)
    pb, ps = suppress_plain(torch.from_numpy(bx), torch.from_numpy(sc), max_det=NMS_MAX_DET, **kw)
    if ref == "lax":
        jb, js = _suppress_lax(jnp.asarray(bx), jnp.asarray(sc), max_det=NMS_MAX_DET, **kw)
    else:
        jb, js = nms_fused(jnp.asarray(bx), jnp.asarray(sc), max_det_per_class=NMS_MAX_DET,
                           interpret=True, **kw)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    assert (ps > 0).sum() > 2


@pytest.mark.parametrize("k", [1, 33, 64, 256, 512])
def test_plan_per_class(k):
    """Per-class pools up to 512: a warp each, PER_CLASS_WARPS a CTA, the
    picks' boxes, areas and indices and a chunk's 32 boxes and areas in
    shared memory (above 48 KB only from max_det 486 on), the same for
    every class count."""
    for c in (1, 4, 20, 80):
        for max_det in (0, 1, 20, 60, 1000):
            p = plan_nms(c, k, max_det, shared=False)
            assert p.variant == "per_class" and p.warps == PER_CLASS_WARPS == 4
            assert 32 * p.npl >= k and (p.npl == 1 or k > 16 * p.npl)
            assert p.smem == per_class_smem_bytes(k, max_det) == 4 * (24 * min(max_det, k)
                                                                        + 640)
            assert p.smem <= 51712 < SMEM_LIMIT
            assert (p.smem > 48 * 1024) == (min(max_det, k) >= 486)
