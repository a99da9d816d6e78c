"""The port's two kernel modules vs the JAX package's kernels, on the CPU.

On the CPU each wrapper takes its plain PyTorch version, which is what
is held here against the Pallas kernels (interpret mode) and their XLA
twins. The CUDA kernels themselves are held against the same plain
versions on the card by tests/test_torch_cuda.py and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloret_tpu.ops.mbconv_pallas import fused_mbconv as jax_fused_mbconv
from yoloret_tpu.ops.mbconv_pallas import reference_mbconv as jax_reference_mbconv
from yoloret_tpu.ops.nms_pallas import nms_fused
from yoloret_tpu.ops.postprocess import _suppress_lax, _suppress_lax_shared
from yoloret_tpu_torch.ops.mbconv import fused_mbconv, reference_mbconv
from yoloret_tpu_torch.ops.nms_kernel import suppress, suppress_plain

torch.set_num_threads(1)


def _mbconv_inputs(rs, h, w, cin, ce, cout, expand):
    def r(*shape):
        return (rs.randn(*shape) * 0.2).astype(np.float32)

    x = rs.rand(2, h, w, cin).astype(np.float32) - 0.5
    we = r(cin, ce) if expand else None
    be = r(1, ce) if expand else None
    return x, we, be, r(3, 3, ce), r(1, ce), r(ce, cout), r(1, cout)


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


MBCONV_CASES = [
    # (h, w, cin, ce, cout, stride, expand, residual)
    (16, 16, 8, 32, 16, 1, True, False),
    (16, 16, 16, 96, 16, 1, True, True),
    (16, 16, 24, 24, 16, 1, False, False),  # t=1, block 0
    (12, 12, 16, 16, 16, 1, False, True),
    (16, 16, 8, 48, 24, 2, True, False),  # stride 2 pads (0, 1)
    (16, 8, 16, 16, 24, 2, False, False),
    # MobileNetV2 x1.4 @224: block 13 (Cout 224, 10 accumulator blocks of
    # the bf16 kernel) and blocks 14-15 (Ce 1344 = 28 chunks, a 7x7 map)
    (8, 8, 136, 816, 224, 2, True, False),
    (7, 7, 224, 1344, 224, 1, True, True),
]


@pytest.mark.parametrize("case", MBCONV_CASES)
def test_mbconv_plain_matches_pallas_and_xla(case):
    h, w, cin, ce, cout, stride, expand, residual = case
    args = _mbconv_inputs(np.random.RandomState(0), h, w, cin, ce, cout, expand)
    got = reference_mbconv(*[_t(a) for a in args], stride=stride, residual=residual)
    want_xla = jax_reference_mbconv(*[_j(a) for a in args], stride=stride, residual=residual)
    want_pallas = jax_fused_mbconv(*[_j(a) for a in args], stride=stride, residual=residual,
                                   interpret=True)
    assert tuple(got.shape) == (2, h // stride, w // stride, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), atol=1e-5, rtol=1e-5)


def test_mbconv_plain_bf16_rounds_where_jax_does():
    """bf16 in and out, rounded after expand, depthwise and project; the
    only difference left is float32 summation order, which can move a
    rounding by one bf16 step (2^-8 relative)."""
    args = _mbconv_inputs(np.random.RandomState(1), 16, 16, 8, 48, 16, True)
    dt = [jnp.bfloat16 if i in (0, 1, 3, 5) else jnp.float32 for i in range(7)]
    tdt = [torch.bfloat16 if i in (0, 1, 3, 5) else torch.float32 for i in range(7)]
    got = reference_mbconv(*[_t(a, d) for a, d in zip(args, tdt)], stride=1)
    want = jax_reference_mbconv(*[_j(a, d) for a, d in zip(args, dt)], stride=1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_mbconv_wrapper_takes_plain_version_on_cpu():
    args = [_t(a) for a in _mbconv_inputs(np.random.RandomState(2), 8, 8, 8, 32, 8, True)]
    before = fused_mbconv.launches
    got = fused_mbconv(*args, stride=1, residual=True)
    assert fused_mbconv.launches == before  # counts kernel launches only
    torch.testing.assert_close(got, reference_mbconv(*args, stride=1, residual=True),
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        fused_mbconv(*args, stride=2, residual=True)
    with pytest.raises(ValueError):
        fused_mbconv(args[0], None, None, *args[3:], stride=1)  # Ce != Cin without expand


def _nms_problem(rs, b, n, c, k):
    """Random boxes and distinct random scores, top-k per class."""
    boxes = rs.rand(b, n, 4).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + rs.rand(b, n, 2).astype(np.float32) * 0.3
    scores = rs.permutation(b * n * c).reshape(b, n, c).astype(np.float32) / (b * n * c)
    order = np.argsort(-scores.transpose(0, 2, 1), axis=-1, kind="stable")[..., :k]
    cls_scores = np.take_along_axis(scores.transpose(0, 2, 1), order, axis=-1)
    cls_boxes = np.take_along_axis(boxes[:, None].repeat(c, 1), order[..., None], axis=2)
    return boxes, cls_boxes, np.ascontiguousarray(cls_scores)


@pytest.mark.parametrize("k,max_det,thr", [(128, 10, 0.3), (64, 5, 0.3), (100, 20, 0.0)])
def test_nms_plain_matches_pallas_per_class(k, max_det, thr):
    _, cls_boxes, cls_scores = _nms_problem(np.random.RandomState(k), 2, 300, 4, k)
    kb, ks = nms_fused(jnp.asarray(cls_boxes), jnp.asarray(cls_scores),
                       max_det_per_class=max_det, iou_threshold=0.5, score_threshold=thr,
                       interpret=True)
    lb, ls = _suppress_lax(jnp.asarray(cls_boxes), jnp.asarray(cls_scores), max_det=max_det,
                           iou_threshold=0.5, score_threshold=thr)
    pb, ps = suppress_plain(torch.from_numpy(cls_boxes), torch.from_numpy(cls_scores),
                            max_det=max_det, iou_threshold=0.5, score_threshold=thr)
    for want_b, want_s in ((kb, ks), (lb, ls)):
        np.testing.assert_allclose(ps.numpy(), np.asarray(want_s), rtol=1e-6)
        np.testing.assert_allclose(pb.numpy(), np.asarray(want_b), rtol=1e-6)


@pytest.mark.parametrize("m,thr", [(64, 0.3), (512, 0.0), (200, 0.6)])
def test_nms_plain_matches_lax_shared(m, thr):
    rs = np.random.RandomState(m)
    boxes = rs.rand(2, m, 4).astype(np.float32) * 50
    boxes[..., 2:] = boxes[..., :2] + rs.rand(2, m, 2).astype(np.float32) * 20
    scores = (rs.permutation(2 * 5 * m).reshape(2, 5, m) / (2 * 5 * m)).astype(np.float32)
    lb, ls = _suppress_lax_shared(jnp.asarray(boxes), jnp.asarray(scores), max_det=20,
                                  iou_threshold=0.5, score_threshold=thr)
    pb, ps = suppress(torch.from_numpy(boxes), torch.from_numpy(scores), max_det=20,
                      iou_threshold=0.5, score_threshold=thr)
    np.testing.assert_allclose(ps.numpy(), np.asarray(ls), rtol=1e-6)
    np.testing.assert_allclose(pb.numpy(), np.asarray(lb), rtol=1e-6)


def test_nms_suppresses_overlaps_and_respects_threshold():
    boxes = torch.tensor([[[0.1, 0.1, 0.5, 0.5], [0.11, 0.11, 0.51, 0.51],
                           [0.6, 0.6, 0.9, 0.9]]])
    scores = torch.tensor([[[0.9, 0.8, 0.7]]])
    before = suppress.launches
    ob, os_ = suppress(boxes, scores, max_det=3, iou_threshold=0.5, score_threshold=0.1)
    assert suppress.launches == before
    np.testing.assert_allclose(os_[0, 0].numpy(), [0.9, 0.7, 0.0], rtol=1e-6)
    np.testing.assert_array_equal(ob[0, 0, 2].numpy(), np.zeros(4, np.float32))
    _, os_ = suppress(boxes, scores, max_det=3, iou_threshold=0.5, score_threshold=0.95)
    assert float(os_.sum()) == 0.0
    with pytest.raises(ValueError):
        suppress(boxes[:, :2], scores, max_det=3)
