"""The port's target assignment and YOLO loss against the JAX package's
(``yoloret_tpu/ops/targets.py``, ``yoloret_tpu/train/losses.py``), on
the CPU, float32, on the same seeded heads and ground truth.

Targets are held bitwise, boxes that collide on one cell and anchor and
padding rows included. The loss (total and the three parts, GIoU and
MSE box loss, BCE and focal class loss) is held within 1e-5 relative,
and its gradient with respect to the heads within 1e-5 (relative to the
largest gradient of each scale)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloret_tpu.ops.targets import assign_targets_batch as jax_assign
from yoloret_tpu.ops.targets import true_corner_boxes as jax_corners
from yoloret_tpu.train.losses import yolo_loss as jax_loss
from yoloret_tpu_torch.ops.boxes import pairwise_iou, wh_iou
from yoloret_tpu_torch.ops.targets import assign_targets_batch, true_corner_boxes
from yoloret_tpu_torch.train.losses import yolo_loss

from _torch_parity import ANCHORS

SIZE = 64
C = 4
T = 10


def gt_boxes(seed=0, batch=3):
    """[batch, T, 5] pixel (x1, y1, x2, y2, cls): random boxes, two pairs
    that land on one cell and anchor (the later one must win), a box of
    zero width, and padding rows."""
    rs = np.random.RandomState(seed)
    out = np.zeros((batch, T, 5), np.float32)
    for b in range(batch):
        n = 6 + b
        xy = rs.uniform(0, SIZE - 8, (n, 2))
        wh = rs.uniform(4, SIZE / 1.5, (n, 2))
        out[b, :n, 0:2] = xy
        out[b, :n, 2:4] = np.minimum(xy + wh, SIZE - 1)
        out[b, :n, 4] = rs.randint(0, C, n)
    out[0, 3] = out[0, 1] + np.asarray([0.4, 0.3, 0.4, 0.3, 0], np.float32)  # collide
    out[0, 3, 4] = (out[0, 1, 4] + 1) % C
    out[1, 5, :4] = out[1, 0, :4]  # an exact duplicate, another class
    out[1, 5, 4] = (out[1, 0, 4] + 2) % C
    out[2, 2, 2] = out[2, 2, 0]  # zero width: padding
    return out


def test_box_ops_match_jax():
    from yoloret_tpu.ops.boxes import pairwise_iou as jax_iou
    from yoloret_tpu.ops.boxes import wh_iou as jax_wh_iou

    rs = np.random.RandomState(3)
    a = np.sort(rs.rand(50, 2, 2), axis=1).reshape(50, 4).astype(np.float32)
    b = np.sort(rs.rand(50, 2, 2), axis=1).reshape(50, 4).astype(np.float32)
    b[:5] = 0.0  # empty boxes: divide-no-nan
    for mode in ("iou", "giou"):
        want = np.asarray(jax_iou(jnp.asarray(a), jnp.asarray(b), mode=mode))
        got = pairwise_iou(torch.from_numpy(a), torch.from_numpy(b), mode).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    wh = rs.rand(20, 2).astype(np.float32)
    np.testing.assert_array_equal(
        wh_iou(torch.from_numpy(wh)[:, None], torch.from_numpy(ANCHORS)).numpy(),
        np.asarray(jax_wh_iou(jnp.asarray(wh)[:, None], jnp.asarray(ANCHORS))))
    # the double where keeps the gradient finite on an empty box
    x = torch.zeros(1, 4, requires_grad=True)
    pairwise_iou(x, torch.zeros(1, 4), "giou").sum().backward()
    assert torch.isfinite(x.grad).all()


def test_assign_targets_bitwise():
    boxes = gt_boxes()
    want = jax_assign(jnp.asarray(boxes), (SIZE, SIZE), jnp.asarray(ANCHORS), C, 3)
    got = assign_targets_batch(torch.from_numpy(boxes), (SIZE, SIZE),
                               torch.from_numpy(ANCHORS), C, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the collisions are there: fewer objects than valid boxes
    n_obj = sum(float(g[..., 4].sum()) for g in got)
    assert n_obj < (boxes[..., 2] - boxes[..., 0] > 0).sum()
    gc, gv = true_corner_boxes(torch.from_numpy(boxes), (SIZE, SIZE))
    wc, wv = jax_corners(jnp.asarray(boxes), (SIZE, SIZE))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def heads(seed=1, batch=3):
    rs = np.random.RandomState(seed)
    return [(rs.randn(batch, SIZE // s, SIZE // s, 3, 5 + C) * 1.5).astype(np.float32)
            for s in (32, 16, 8)]


@pytest.mark.parametrize("box_loss,class_loss", [("giou", "bce"), ("giou", "focal"),
                                                 ("mse", "bce"), ("mse", "focal")])
def test_loss_and_gradient_match_jax(box_loss, class_loss):
    boxes = gt_boxes()
    ys = [np.asarray(y) for y in jax_assign(jnp.asarray(boxes), (SIZE, SIZE),
                                            jnp.asarray(ANCHORS), C, 3)]
    gt, gv = (np.asarray(v) for v in jax_corners(jnp.asarray(boxes), (SIZE, SIZE)))
    hs = heads()
    # a few predictions on the ground truth, so that the ignore mask bites
    hs[2][0, 1, 1] = 0.0
    kw = dict(num_scales=3, ignore_thresh=0.5, box_loss=box_loss, class_loss_kind=class_loss)

    def jfn(h):
        total, parts = jax_loss(h, ys, jnp.asarray(gt), jnp.asarray(gv), jnp.asarray(ANCHORS),
                                **kw)
        return total, parts

    # jitted: one compile beats dispatching every op of the loss eagerly
    (jtotal, jparts), jgrad = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        [jnp.asarray(h) for h in hs])
    th = [torch.from_numpy(h).requires_grad_(True) for h in hs]
    total, parts = yolo_loss(th, [torch.from_numpy(y) for y in ys], torch.from_numpy(gt),
                             torch.from_numpy(gv), torch.from_numpy(ANCHORS), **kw)
    total.backward()
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    for p, jp in zip(parts, jparts):
        for name in ("box", "confidence", "classification"):
            np.testing.assert_allclose(float(getattr(p, name)), float(getattr(jp, name)),
                                       rtol=1e-5, err_msg=name)
    ignored = sum(float(jp.confidence) for jp in jparts)
    assert ignored > 0
    for t, jg in zip(th, jgrad):
        jg = np.asarray(jg)
        np.testing.assert_allclose(t.grad.numpy(), jg, rtol=0, atol=1e-5 * np.abs(jg).max())
