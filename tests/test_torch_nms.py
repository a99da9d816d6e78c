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
then one mask row per round) gives the plain result, and its launch plan.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda import AT_THRESHOLD, NMS_CASES, NMS_MAX_DET, large_pool_case, nms_case
from yoloret_tpu.ops.nms_pallas import nms_fused
from yoloret_tpu.ops.postprocess import _suppress_lax, _suppress_lax_shared
from yoloret_tpu_torch.ops.boxes import iou
from yoloret_tpu_torch.ops.nms_kernel import (
    MAX_CANDIDATES, SMEM_LIMIT, large_smem_bytes, plan_nms, shared_smem_bytes, suppress,
    suppress_plain)

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
    assert plan_nms(20, 512, 20, shared=False) == ("per_class", 16, 4, 20, 0)


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
    for shared in (True, False):
        assert plan_nms(20, MAX_CANDIDATES + 1, 20, shared).variant == "per_class_large"
        with pytest.raises(ValueError):  # keys beyond shared memory
            plan_nms(20, (SMEM_LIMIT - 8 * 32) // 4, 20, shared)
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
        assert plan_nms(80, 3087, 20, shared) == ("per_class_large", 8, 13, 80, 12624)
        assert plan_nms(80, 10647, 20, shared) == ("per_class_large", 11, 32, 80, 42864)
    assert large_smem_bytes(10647) == 42864


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
    """Pools above 512, shared or per-class, take the large-pool kernel:
    one warp per 256 candidates (8 to 32), the keys in shared memory."""
    for shared in (True, False):
        for max_det in (1, 20, 1000):
            p = plan_nms(20, k, max_det, shared)
            assert p.variant == "per_class_large" and p.classes_per_pass == 20
            assert p.warps == min(32, max(8, -(-k // 256))) and 32 * p.warps * p.npl >= k
            assert p.smem == large_smem_bytes(k) <= SMEM_LIMIT and p.smem >= 4 * k
    assert plan_nms(20, 512, 20, shared=False).variant == "per_class"


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
