"""The port's zoom-in ensemble and ``use_pallas`` postprocess
(``yoloret_tpu_torch/ops/postprocess.py``) against the JAX package's
(``yoloret_tpu/ops/postprocess.py``), the zoom's centre-mapping
regressions of ``tests/test_zoom.py``, and ``Predictor(zoom_ensemble=
True)``.

Heads from a numpy seed (logits x2, so scores form distinct peaks),
float32 on the CPU, exact top-k on both sides (``approx_topk=False``),
the JAX side jitted as its ``Predictor`` runs it;
the detections held as ``tests/test_torch_eval.py`` holds the per-class
pool: valid and classes equal, scores to 1e-6 relative, boxes to 1e-4 px.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import ANCHORS, CLASSES, IMAGE_HW, _heads
from yoloret_tpu.ops.postprocess import _detect_batch_candidates as jax_candidates_path
from yoloret_tpu.ops.postprocess import detect_batch as jax_detect_batch
from yoloret_tpu_torch.infer import Predictor
from yoloret_tpu_torch.ops.postprocess import detect_batch, gather_boxes_and_scores

torch.set_num_threads(1)

MAIN, ZOOM = 96, 64  # network input and centre crop of the tests


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _assert_same(got, want):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-5, atol=1e-4)
    assert got.valid.any()


@pytest.mark.parametrize("thr,k,pool", [(0.3, 64, None), (0.0, 512, "per_class"),
                                        (0.5, 10_000, None)])
def test_detect_batch_zoom_matches_jax(thr, k, pool):
    """Per-class pools over both passes' positions (K = min(k, N): 64,
    512, and all 2,268 + 1,008); the crop's candidates interleaved per
    scale, so ties keep the JAX package's order."""
    heads, zoom = _heads(k, size=MAIN), _heads(k + 1, size=ZOOM)
    kw = dict(score_threshold=thr, num_candidates=k, pool=pool)
    want = jax.jit(functools.partial(jax_detect_batch, num_classes=len(CLASSES),
                                     approx_topk=False, **kw))(
        _j(heads), jnp.asarray(ANCHORS), image_hw=jnp.asarray(IMAGE_HW), zoom_outputs=_j(zoom))
    got = detect_batch(_t(heads), torch.from_numpy(ANCHORS), len(CLASSES),
                       torch.from_numpy(IMAGE_HW), zoom_outputs=_t(zoom), **kw)
    _assert_same(got, want)


def test_use_pallas_gives_the_per_class_answer():
    """``use_pallas=True``: the JAX package's per-class kernel path (its
    XLA twin here, the Pallas kernel being the TPU's), with the kernel's
    slate (valid = score above 0)."""
    heads = _heads(3)
    kw = dict(max_det_per_class=20, score_threshold=0.2, iou_threshold=0.5, num_candidates=128)
    want = jax.jit(functools.partial(jax_candidates_path, num_classes=len(CLASSES),
                                     use_pallas=False, approx_topk=False, **kw))(
        _j(heads), jnp.asarray(ANCHORS), image_hw=jnp.asarray(IMAGE_HW))
    got = detect_batch(_t(heads), torch.from_numpy(ANCHORS), len(CLASSES),
                       torch.from_numpy(IMAGE_HW), use_pallas=True, **kw)
    _assert_same(got, want)
    with pytest.raises(ValueError, match="per-class"):
        detect_batch(_t(heads), torch.from_numpy(ANCHORS), len(CLASSES),
                     torch.from_numpy(IMAGE_HW), use_pallas=True, pool="shared")


def _zero_outputs(size):
    return [torch.zeros((1, size // s, size // s, 3, 25)) for s in (32, 16, 8)]


@pytest.mark.parametrize("scale,atol", [(0, 0.5), (1, 8.5)])
def test_zoom_center_maps_to_center(scale, atol):
    """tests/test_zoom.py's two regressions: the crop's centre cell lands
    at the centre of the input (416 px, crop 224) on the coarsest scale
    (xy * 224/416 + (416-224)/(2*416)), and within one cell on the finer
    scale 1, whose crop size comes from the COARSEST crop grid."""
    hw = torch.tensor([[416.0, 416.0]])
    boxes, scores = gather_boxes_and_scores(_zero_outputs(416), torch.from_numpy(ANCHORS), 20,
                                            hw, zoom_outputs=_zero_outputs(224))
    main = [(416 // s) ** 2 * 3 for s in (32, 16, 8)]
    crop = [(224 // s) ** 2 * 3 for s in (32, 16, 8)]
    assert boxes.shape == (1, sum(main) + sum(crop), 4) and scores.shape[1:] == (boxes.shape[1], 20)
    start = sum(main[:scale + 1]) + sum(crop[:scale])  # [main 0][crop 0][main 1][crop 1]...
    g = 224 // (32 >> scale)
    center = boxes[0, start:start + crop[scale]].reshape(g, g, 3, 4)[g // 2, g // 2, 0]
    np.testing.assert_allclose([(center[0] + center[2]) / 2, (center[1] + center[3]) / 2],
                               [208.0, 208.0], atol=atol)


@pytest.mark.parametrize("int8", [False, True])
def test_predictor_zoom_answers(int8):
    """``Predictor(zoom_ensemble=True)``: its ``infer`` is ``detect_batch``
    of the full input's heads and the centre crop's (the fused forward,
    or the int8 one), and ``detect_arrays`` answers."""
    pred = Predictor(class_names=CLASSES, anchors=ANCHORS, input_hw=(MAIN, MAIN), bf16=False,
                     score_threshold=0.0, zoom_ensemble=True, zoom_hw=(ZOOM, ZOOM),
                     use_int8=int8, device="cpu")
    rs = np.random.RandomState(7)
    images = torch.from_numpy(rs.randint(0, 256, (2, MAIN, MAIN, 3), np.uint8))
    hw = torch.from_numpy(IMAGE_HW)
    got = pred.infer(images, hw)
    x = images.float() * (1.0 / 255.0)
    o = (MAIN - ZOOM) // 2
    want = detect_batch(pred._forward(x), pred._anchors_t, len(CLASSES), hw,
                        score_threshold=0.0, num_candidates=pred.num_candidates,
                        zoom_outputs=pred._forward(x[:, o:o + ZOOM, o:o + ZOOM]))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    dets = pred.detect_arrays([rs.randint(0, 256, (70, 50, 3), np.uint8)])
    assert len(dets) == 1 and dets[0]
