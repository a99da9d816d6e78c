"""The port's full-int8 study (``yoloret_tpu_torch/tools/int8_study.py``)
on the CPU with TensorFlow.

Held: ``run`` end to end (1 epoch at 64 px): the four rows in the JAX
package's order, the port's float32 and W8A8 paths in place of the JAX
ones, each mAP in [0, 1]; and on peaked weights (the recipe of
``tests/test_export.py::_peaked_checkpoint``, head kernels x4, here on the
port's seeded init through ``_torch_parity.peaked_variables``, 4 classes,
written as a JAX weight directory) the float32 row equals, to 1e-6, the
mAP that the JAX package's own pieces give on the same weights and
scenes: ``export.export._build_infer`` (its init replaced by the
directory's values), ``ops.letterbox.letterbox_numpy_u8`` and
``eval.map.MAPEvaluator``, with the ``[1, 0, 3, 2]`` box swap of the JAX
study.

The other rows' parts are held elsewhere: the W8A8 path against the JAX
package's in ``tests/test_torch_int8.py`` (``test_calibration_and_weights_match_jax``,
``test_int8_blocks_match_jax``, ``test_int8_detector_apply_matches_jax``), the TFLite flavours against the
port's float program and the JAX criteria in ``tests/test_torch_tf_export.py``
(``test_tflite_dynamic_range_matches_the_float_program``,
``test_tflite_full_int8_keeps_the_detections``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import yoloret_tpu.export.export as jax_export
from _torch_parity import peaked_variables
from yoloret_tpu.configs import RunConfig as JaxRunConfig
from yoloret_tpu.data.annotations import parse_annotation_line as jax_parse_annotation_line
from yoloret_tpu.eval.map import MAPEvaluator as JaxMAPEvaluator
from yoloret_tpu.nn import build_detector as jax_build_detector
from yoloret_tpu.ops.letterbox import letterbox_numpy_u8 as jax_letterbox_numpy_u8
from yoloret_tpu.utils.checkpoint import save_params as jax_save_params
from yoloret_tpu_torch.data import load_anchors
from yoloret_tpu_torch.infer import Predictor
from yoloret_tpu_torch.tools import int8_study
from yoloret_tpu_torch.tools.topk_study import CLASS_NAMES, build_crowded

pytest.importorskip("tensorflow")

torch.set_num_threads(1)

SIZE = 64


def test_run_on_the_cpu(tmp_path, capsys):
    rows = int8_study.run(epochs=1, size=SIZE, workdir=str(tmp_path), device="cpu")
    assert [name for name, _ in rows] == ["torch_f32", "torch_int8", "tflite_f32", "tflite_int8"]
    assert all(np.isfinite(m) and 0.0 <= m <= 1.0 for _, m in rows)
    out = capsys.readouterr().out
    assert "| backend | mAP | delta vs torch_f32 |" in out
    for name, m in rows:
        assert f"| {name} | {m:.4f} | {m - rows[0][1]:+.4f} |" in out


class _ShapeInit:
    """A JAX detector whose ``init`` returns zeros of the init's shapes
    (``jax.eval_shape``, no eager init): ``_build_infer`` replaces every
    one of them with the weight directory's."""

    def __init__(self, model):
        self.model = model

    def init(self, key, x, train):
        shapes = jax.eval_shape(lambda k: self.model.init(k, x, train), key)
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    def apply(self, *a, **kw):
        return self.model.apply(*a, **kw)


def jax_float32_map(cfg, ann):
    """The JAX study's float32 row, from its own pieces, jitted."""
    infer = jax.jit(jax_export._build_infer(cfg)[0])
    ev = JaxMAPEvaluator(num_classes=len(CLASS_NAMES))
    with open(ann) as fh:
        for line in fh:
            path, gtb = jax_parse_annotation_line(line)
            arr = np.asarray(Image.open(path).convert("RGB"), np.uint8)
            img = jax_letterbox_numpy_u8(arr, (SIZE, SIZE)).astype(np.float32) / 255.0
            hw = np.asarray([[arr.shape[0], arr.shape[1]]], np.float32)
            b, s, c, v = [np.asarray(x) for x in infer(img[None], hw)]
            m = np.asarray(v[0], bool)
            db = b[0][m]
            ev.add_image(db[:, [1, 0, 3, 2]] if len(db) else db.reshape(0, 4), s[0][m],
                         c[0][m], gtb)
    aps = ev.compute()
    return float(np.mean(list(aps.values()))) if aps else 0.0


def test_float32_row_is_the_jax_packages_on_peaked_weights(tmp_path, monkeypatch):
    """8 crowded scenes, whose ground truth is their own boxes and the
    port's 2 best detections, a class changed on some (as
    ``tests/test_torch_eval.py`` makes it): seeded weights match none of
    the scenes' boxes, and not every detection matches."""
    scenes, classes, anchors = build_crowded(str(tmp_path), n=8)
    weights = str(tmp_path / "peaked")
    jax_save_params(weights, peaked_variables(
        jax_build_detector("mobilenetv2x75", num_classes=len(CLASS_NAMES)), len(CLASS_NAMES)))
    pred = Predictor(weights=weights, class_names=CLASS_NAMES, anchors=load_anchors(anchors),
                     input_hw=(SIZE, SIZE), score_threshold=0.0, bf16=False, device="cpu")
    detect = int8_study.torch_detect(pred, SIZE)
    rs = np.random.RandomState(5)
    lines = []
    with open(scenes) as fh:
        for line in fh:
            path = line.split()[0]
            boxes, scores, cls = detect(np.asarray(Image.open(path).convert("RGB"), np.uint8))
            top = np.argsort(-scores, kind="stable")[:2]
            cls = cls[top].copy()
            cls[rs.rand(len(cls)) < 0.3] = (cls[0] + 1) % len(CLASS_NAMES)
            lines.append(line.strip() + "".join(
                " {!r},{!r},{!r},{!r},{}".format(float(b[1]), float(b[0]), float(b[3]),
                                                 float(b[2]), int(c))
                for b, c in zip(boxes[top], cls)))
    ann = str(tmp_path / "gt.txt")
    with open(ann, "w") as f:
        f.write("\n".join(lines) + "\n")
    got = int8_study.backend_map(detect, int8_study.read_samples(ann))

    monkeypatch.setattr(jax_export, "build_detector",
                        lambda *a, **kw: _ShapeInit(jax_build_detector(*a, **kw)))
    want = jax_float32_map(JaxRunConfig(backbone="mobilenetv2x75", input_size=(SIZE, SIZE),
                                        classes_path=classes, anchors_path=anchors,
                                        model=weights, score_threshold=0.0), ann)
    assert abs(got - want) <= 1e-6, (got, want)
    assert 0.05 < got < 1.0  # the ground truth matches, not all of it (0.0986)
