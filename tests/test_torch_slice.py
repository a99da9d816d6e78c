"""The port's serving slice vs the JAX package: the shared-pool
postprocess on random heads, and the whole Predictor (letterbox ->
fused forward -> postprocess -> detections) on the same peaked weights.

Float32 on the CPU, inputs made with numpy from a seed. The port uses
exact ``torch.topk``, held against the JAX ``approx_topk=False``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloret_tpu.infer import Predictor as JaxPredictor
from yoloret_tpu.nn import build_detector as jax_build_detector
from yoloret_tpu.ops.postprocess import detect_batch as jax_detect_batch
from yoloret_tpu.ops.postprocess import shared_pool_candidates as jax_candidates
from yoloret_tpu_torch.infer import Predictor
from yoloret_tpu_torch.ops.postprocess import detect_batch, shared_pool_candidates

torch.set_num_threads(1)

ANCHORS = np.asarray([[10, 13], [16, 30], [33, 23], [30, 61], [62, 45],
                      [59, 119], [116, 90], [156, 198], [373, 326]], np.float32)
CLASSES = ["a", "b", "c"]
SIZE = 64


def _heads(seed, b=2, size=SIZE, c=len(CLASSES)):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, size // s, size // s, 3, 5 + c).astype(np.float32) * 2.0
            for s in (32, 16, 8)]


IMAGE_HW = np.asarray([[480.0, 640.0], [300.0, 200.0]], np.float32)


@pytest.mark.parametrize("m", [64, 512])
def test_shared_pool_candidates_match_jax(m):
    heads = _heads(m)
    want_b, want_s = jax_candidates([jnp.asarray(h) for h in heads], jnp.asarray(ANCHORS),
                                    len(CLASSES), jnp.asarray(IMAGE_HW), num_candidates=m,
                                    approx_topk=False)
    got_b, got_s = shared_pool_candidates([torch.from_numpy(h) for h in heads],
                                          torch.from_numpy(ANCHORS), len(CLASSES),
                                          torch.from_numpy(IMAGE_HW), num_candidates=m)
    assert tuple(got_b.shape) == want_b.shape and tuple(got_s.shape) == want_s.shape
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("thr,m", [(0.3, 64), (0.0, 512)])
def test_detect_batch_matches_jax(thr, m):
    heads = _heads(100 + m)
    want = jax_detect_batch([jnp.asarray(h) for h in heads], jnp.asarray(ANCHORS),
                            len(CLASSES), jnp.asarray(IMAGE_HW), score_threshold=thr,
                            num_candidates=m, pool="shared", approx_topk=False)
    got = detect_batch([torch.from_numpy(h) for h in heads], torch.from_numpy(ANCHORS),
                       len(CLASSES), torch.from_numpy(IMAGE_HW), score_threshold=thr,
                       num_candidates=m)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-5, atol=1e-4)
    assert got.valid.any()


def _peaked_variables():
    """Detector weights with the head kernels amplified x4, so scores
    form distinct input-dependent peaks instead of ties at 0.25."""
    model = jax_build_detector("mobilenetv2x75", num_classes=len(CLASSES))
    v = jax.device_get(model.init(jax.random.PRNGKey(3), jnp.zeros((1, SIZE, SIZE, 3)), False))

    def amplify(tree, path=()):
        return {k: amplify(val, path + (k,)) if isinstance(val, dict)
                else (np.asarray(val) * 4.0 if k == "kernel" and any("head" in p for p in path)
                      else np.asarray(val))
                for k, val in tree.items()}

    return {"params": amplify(v["params"]), "batch_stats": amplify(v["batch_stats"])}


def test_predictor_matches_jax_predictor():
    variables = _peaked_variables()
    kw = dict(class_names=CLASSES, anchors=ANCHORS, input_hw=(SIZE, SIZE),
              score_threshold=0.25, bf16=False, num_candidates=64, batch_buckets=(4,))
    want_pred = JaxPredictor(**kw)
    want_pred.variables = variables
    got_pred = Predictor(weights=variables, device="cpu", **kw)
    rs = np.random.RandomState(7)
    images = [rs.randint(0, 256, hw + (3,), dtype=np.uint8)
              for hw in ((100, 140), (64, 64), (90, 50))]
    want = want_pred.detect_arrays(images)
    got = got_pred.detect_arrays(images)
    assert got_pred.forwards == 1 and got_pred.dispatched_batch_sizes == {4}
    assert sum(len(d) for d in want) > 0
    for g_img, w_img in zip(got, want):
        assert len(g_img) == len(w_img)
        for g, w in zip(g_img, w_img):
            assert (g.class_id, g.class_name) == (w.class_id, w.class_name)
            np.testing.assert_allclose(g.score, w.score, rtol=1e-4)
            np.testing.assert_allclose(g.box, w.box, atol=1e-2)
