"""The port's TensorFlow flavours of EXPORT for the backbones outside the
tfjs graph model's families: DarkNet-53 (into the weighted-sum RFCR and
the neck) and the full YOLO-Nano and Yolo-Fastest(-XL) bodies
(``yoloret_tpu_torch/export/tfjs.py::_TFMirror``), against the JAX
package, on the CPU with TensorFlow. A file of its own, so that the
scheduler can run it beside ``tests/test_torch_tf_export.py``.

- The TF mirror of each of the four against the JAX forward at 64x64 b1,
  on the port's seeded init written into the Flax tree
  (``tests/_torch_parity.py::port_variables``, ``jax.eval_shape`` of the
  JAX init) with the BatchNorm statistics calibrated on the input: rtol
  1e-3, atol 5e-5 (``tests/test_torch_tf_export.py``'s tolerance and its
  reason); YOLO-Nano and Yolo-Fastest-XL at float64 compute on both
  sides (see the test).
- ``export_tf_flavor`` for Yolo-Fastest at 96x96 on its calibrated
  weights with the head kernels scaled x0.25 (a port weight file,
  ``cfg.model``; at x1 the picked cells' box logits saturate, to boxes of
  zero width in float32 and of the whole image in int8, where no box
  check means anything): SERVING's slate against the port's float program
  and the JAX program (``detect_batch(approx_topk=False)`` of the JAX
  forward) at score threshold 0.7, inside the crowd (valid and classes
  equal, scores within 1e-4, boxes within 0.05 px); TFLITE with
  ``--quantize`` on 3 calibration JPEGs drawn as the test image is: each
  head of the dynamic-range and of the full-int8 model at most 1.25x as
  far from the float program as the JAX package's TFLITE of the same
  weights and JPEGs (its readings: ``tests/tflite_jax_readings.py``; see
  the tests for the slate); TFJS, where the JAX package stages the
  SavedModel and prints the converter's command.
- The mirror tests run the mirror's ops eagerly: the graph of the same
  ops is what SERVING and TFLITE hold.

No DarkNet-53 SavedModel is written here: its ~62M float32 constants
cost too much for this suite.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import ANCHORS, SIZE, _map, calibrated_pair, make_pair, port_variables
from yoloret_tpu.nn import build_detector as jax_build_detector
from yoloret_tpu.ops import detect_batch as jax_detect_batch
from yoloret_tpu_torch.configs import RunConfig
from yoloret_tpu_torch.export.export import InferenceProgram, export_tf_flavor, program_weights
from yoloret_tpu_torch.export import tfjs
from yoloret_tpu_torch.nn.detector import YoloReT
from yoloret_tpu_torch.utils.checkpoint import save_params
from yoloret_tpu_torch.weights import from_flax

tf = pytest.importorskip("tensorflow")

torch.set_num_threads(1)

MIRROR_TOL = dict(rtol=1e-3, atol=5e-5)
CLASSES = ["a", "b"]
LEGACY = ["darknet53", "yolo_nano", "yolo_fastest", "yolo_fastest_xl"]
PROGRAM_SIZE = 96
HEAD_SCALE = 0.25
SERVING_SCORE = 0.7
TFLITE_SCORE = 0.6
WIDE = ("yolo_nano", "yolo_fastest_xl")  # float64 compute on both sides


@pytest.mark.parametrize("backbone", LEGACY)
def test_tf_mirror_matches_jax(backbone, monkeypatch):
    """The mirror's heads against the JAX forward's, 64x64 b1, its ops run
    eagerly. YOLO-Nano
    and Yolo-Fastest-XL run both sides at float64 compute (the mirror's
    weights read, folded and held as float64, its input float64): on these
    weights the JAX package's own float32 heads sit 3.0e-4 (Nano) and
    1.3e-4 (XL) from its float64 heads, the float32 mirror's 3.7e-4 and
    2.1e-4, so two float32 executors cannot be held at atol 5e-5 where a
    head lies near 0."""
    jax_model = jax_build_detector(backbone, num_classes=len(CLASSES))
    port = YoloReT(backbone, num_classes=len(CLASSES))
    if backbone in WIDE:
        x, variables = calibrated_pair(jax_model, port, port_variables, batch=1)
        x = x.astype(np.float64)
        with jax.enable_x64(True):
            wide = jax_build_detector(backbone, num_classes=len(CLASSES), dtype=jnp.float64)
            want = jax.jit(lambda v, xx: wide.apply(v, xx, False))(
                jax.tree.map(lambda a: np.asarray(a, np.float64), variables), x)
            want = [np.asarray(w) for w in want]
        monkeypatch.setattr(tfjs, "_np", lambda t: t.detach().double().numpy())
    else:
        x, _, want, port = make_pair(jax_model, port, port_variables, batch=1)
    got = tfjs._TFMirror(tf, port).forward(tf.constant(x))  # eagerly: no graph of ~62M constants
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(w).max() > 0.5, "heads too small for the comparison to mean much"
        np.testing.assert_allclose(g.numpy(), w, **MIRROR_TOL)


class _Fastest:
    pass


@pytest.fixture(scope="module")
def fastest(tmp_path_factory):
    """Yolo-Fastest, 2 classes: the port's seeded init in the Flax tree,
    its BatchNorm calibrated (``calibrated_pair``) and its head kernels
    scaled by ``HEAD_SCALE``, saved as a port weight file (``cfg.model``);
    the JAX detector and a 96x96 image."""
    p = _Fastest()
    p.root = tmp_path_factory.mktemp("tf_export_legacy")
    (p.root / "classes.txt").write_text("\n".join(CLASSES) + "\n")
    (p.root / "anchors.txt").write_text(", ".join(f"{int(w)},{int(h)}" for w, h in ANCHORS) + "\n")
    p.jax_model = jax_build_detector("yolo_fastest", num_classes=len(CLASSES), dtype=jnp.float32)
    p.model = YoloReT("yolo_fastest", num_classes=len(CLASSES))
    _, v = calibrated_pair(p.jax_model, p.model, port_variables)
    head = lambda path: path[-1] == "kernel" and any("head" in q for q in path)
    p.variables = {"params": _map(v["params"], lambda path, a: a * HEAD_SCALE if head(path) else a),
                   "batch_stats": v["batch_stats"]}
    p.model.load_state_dict(from_flax(p.variables, p.model), strict=True)
    save_params(str(p.root / "fastest.pt"), p.model.state_dict())
    p.cfg = RunConfig(backbone="yolo_fastest", input_size=(PROGRAM_SIZE, PROGRAM_SIZE),
                      classes_path=str(p.root / "classes.txt"),
                      anchors_path=str(p.root / "anchors.txt"), bf16=True,
                      model=str(p.root / "fastest.pt"), score_threshold=SERVING_SCORE)
    p.images = (np.random.RandomState(0).rand(1, PROGRAM_SIZE, PROGRAM_SIZE, 3) ** 2).astype(
        np.float32)
    return p


def port_slate(p, images, hw, score):
    program = InferenceProgram("yolo_fastest", len(CLASSES), torch.float32, "weighted_sum",
                               score, 0.5)
    with torch.no_grad():
        return [t.numpy() for t in program(program_weights(p.model, ANCHORS),
                                           torch.from_numpy(images), torch.from_numpy(hw))]


def jax_slate(p, images, hw, score):
    def infer(v, x, image_hw):
        r = jax_detect_batch(p.jax_model.apply(v, x, False), jnp.asarray(ANCHORS),
                             num_classes=len(CLASSES), image_hw=image_hw, score_threshold=score,
                             iou_threshold=0.5, approx_topk=False)
        return r.boxes, r.scores, r.classes, r.valid

    return [np.asarray(t) for t in jax.jit(infer)(p.variables, images, hw)]


def test_serving_slate_matches_the_port_and_jax(fastest):
    out = export_tf_flavor(fastest.cfg, str(fastest.root / "srv"), "serving")
    saved = os.path.join(out, "saved_model")
    assert os.path.exists(os.path.join(saved, "assets.extra", "tf_serving_warmup_requests"))
    fn = tf.saved_model.load(saved).signatures["serving_default"]
    hw = np.asarray([[120.0, 160.0]], np.float32)
    res = fn(images=tf.constant(fastest.images), image_hw=tf.constant(hw))
    got = [res[f"output_{i}"].numpy() for i in range(4)]
    want = port_slate(fastest, fastest.images, hw, SERVING_SCORE)
    assert 0 < want[3].sum() < want[3].size, "the threshold must keep some slots and drop others"
    for ref in (want, jax_slate(fastest, fastest.images, hw, SERVING_SCORE)):
        boxes, scores, classes, valid = got
        np.testing.assert_array_equal(valid, ref[3])
        np.testing.assert_array_equal(classes, ref[2])
        np.testing.assert_allclose(scores, ref[1], atol=1e-4, rtol=0)
        np.testing.assert_allclose(boxes, ref[0], atol=0.05, rtol=0)


def _calibration_list(p):
    """3 JPEGs drawn as the test image is, as a train list (their
    per-tensor activation ranges calibrate the full-int8 models)."""
    from PIL import Image

    path = p.root / "cal.txt"
    if not path.exists():
        rng = np.random.RandomState(1)
        lines = []
        for i in range(3):
            jpg = p.root / f"cal{i}.jpg"
            pixels = rng.rand(PROGRAM_SIZE, PROGRAM_SIZE, 3) ** 2 * 255
            Image.fromarray(pixels.astype(np.uint8)).save(jpg)
            lines.append(f"{jpg} 10,10,60,50,0")
        path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def tflite(fastest):
    """TFLITE with --quantize, calibrated on 3 JPEGs of a train list."""
    cfg = fastest.cfg.replace(score_threshold=TFLITE_SCORE, quantize=True, quantize_samples=3,
                              train_dataset=_calibration_list(fastest))
    return export_tf_flavor(cfg, str(fastest.root / "tfl"), "tflite")


def run_tflite(path, images, hw=None):
    interp = tf.lite.Interpreter(model_path=path, experimental_preserve_all_tensors=True)
    interp.allocate_tensors()
    for d in interp.get_input_details():
        interp.set_tensor(d["index"], images if d["shape"][-1] == 3 else hw)
    interp.invoke()
    return interp, [(o["dtype"], tuple(o["shape"][1:]), interp.get_tensor(o["index"]))
                    for o in interp.get_output_details()]


def float_heads(p):
    """The float program's three heads (strides 32, 16, 8) of the image."""
    with torch.no_grad():
        return [w[0].numpy() for w in p.model(torch.from_numpy(p.images))]


def rel_rms(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


def pipeline_head_distances(p, path):
    """Each head's relative RMS distance from the float program's, for a
    dynamic-range pipeline model: the head conv's output tensor (named
    ``.../head_<s>/...``, [1, g, g, A * (5 + C)]), kept by the
    interpreter."""
    hw = np.full((1, 2), float(PROGRAM_SIZE), np.float32)
    interp, _ = run_tflite(path, p.images, hw)
    out = []
    for s, w in zip((32, 16, 8), float_heads(p)):
        g = PROGRAM_SIZE // s
        found = [d for d in interp.get_tensor_details()
                 if f"head_{s}/" in d["name"] and tuple(d["shape"]) == (1, g, g, w[0, 0].size)
                 and d["dtype"] == np.float32]
        assert len(found) == 1, [d["name"] for d in found]
        out.append(rel_rms(interp.get_tensor(found[0]["index"]).reshape(w.shape), w))
    return out


def int8_head_distances(p, path):
    """Each head's relative RMS distance from the float program's, for a
    full-int8 conv-stack model (int8 inside, float IO)."""
    interp, outs = run_tflite(path, p.images)
    assert "int8" in {d["dtype"].__name__ for d in interp.get_tensor_details()}
    assert all(d["dtype"].__name__ == "float32" for d in interp.get_input_details())
    heads = {shape: t for _, shape, t in outs}
    out = []
    for s, w in zip((32, 16, 8), float_heads(p)):
        g = heads[(PROGRAM_SIZE // s, PROGRAM_SIZE // s, 3, 5 + len(CLASSES))][0]
        assert np.isfinite(g).all()
        out.append(rel_rms(g, w))
    return out


# Each head's relative RMS distance from the float program's, of the JAX
# package's TFLITE with --quantize of the same weights and calibration
# JPEGs (strides 32, 16, 8), as ``python tests/tflite_jax_readings.py``
# prints them; the port's may sit at most 1.25x as far.
JAX_DYNAMIC_RANGE_HEADS = (0.101518, 0.124589, 0.014383)
JAX_FULL_INT8_HEADS = (0.440931, 0.458148, 0.085728)
JAX_DISTANCE_RATIO = 1.25


def test_tflite_dynamic_range_matches_the_float_program(fastest, tflite):
    """The dynamic-range model: each raw head within 1.25x the JAX
    package's dynamic-range model's relative RMS distance from the float
    program (``JAX_DYNAMIC_RANGE_HEADS``; both quantize the same
    convolutions per channel and run their activations through the same
    hybrid kernels). Its slate at 0.6, where four candidates (0.877 to
    0.642) stand clear of the next (0.562): valid and classes equal to the
    float program's, scores within 0.05 and boxes within 12 px (3/8 of a
    /32 cell). The JAX export tests' 0.02 and 1.5 px do not hold for this
    model's int8 weights, the JAX package's own artifact included: its
    slate sits 0.021 and 3.9 px from the float program's, the port's
    0.033 and 9.4 px (``tests/tflite_jax_readings.py``), a sample of four
    boxes, each moved by its own weights' rounding, where the heads are
    equally far (the port's mirror with its BatchNorm unfolded gives the
    same readings: the converter folds it itself)."""
    got = pipeline_head_distances(fastest, os.path.join(tflite, "model.tflite"))
    for s, g, r in zip((32, 16, 8), got, JAX_DYNAMIC_RANGE_HEADS):
        assert g <= JAX_DISTANCE_RATIO * r, (s, g, r)
    hw = np.full((1, 2), float(PROGRAM_SIZE), np.float32)
    _, outs = run_tflite(os.path.join(tflite, "model.tflite"), fastest.images, hw)
    n = len(CLASSES) * 20
    by = {(np.dtype(dt).name, shape): t for dt, shape, t in outs}
    boxes, scores = by[("float32", (n, 4))], by[("float32", (n,))]
    classes, valid = by[("int32", (n,))], by[("bool", (n,))]
    want = port_slate(fastest, fastest.images, hw, TFLITE_SCORE)
    assert want[3].sum() > 0
    np.testing.assert_array_equal(valid, want[3])
    np.testing.assert_array_equal(classes, want[2])
    m = want[3][0]
    np.testing.assert_allclose(scores[0][m], want[1][0][m], atol=0.05)
    np.testing.assert_allclose(boxes[0][m], want[0][0][m], atol=12.0)


def test_tflite_full_int8_heads(fastest, tflite):
    """The full-int8 model (int8 inside, float IO): each of its three
    heads within 1.25x the JAX package's full-int8 model's relative RMS
    distance from the float program's heads, head by head
    (``JAX_FULL_INT8_HEADS``: a 5x5-depthwise tower on a 3x3 map,
    quantized per tensor, is far from float in both). The JAX export
    tests' criteria (the detections kept) do not hold for this model, the
    JAX package's own artifact included."""
    got = int8_head_distances(fastest, os.path.join(tflite, "model_int8.tflite"))
    for s, g, r in zip((32, 16, 8), got, JAX_FULL_INT8_HEADS):
        assert g <= JAX_DISTANCE_RATIO * r, (s, g, r)


def test_tfjs_stages_the_saved_model(fastest, tmp_path, capsys):
    """TFJS on a backbone outside the graph model's families: the
    SavedModel staged, no graph model, the converter's command printed."""
    out = export_tf_flavor(fastest.cfg, str(tmp_path / "js"), "tfjs")
    saved = os.path.join(out, "saved_model")
    assert os.path.exists(os.path.join(saved, "saved_model.pb"))
    assert not os.path.exists(os.path.join(out, "tfjs_model"))
    text = capsys.readouterr().out
    assert "tfjs export covers the reference's released configs" in text
    assert f"tensorflowjs_converter --input_format=tf_saved_model {saved}" in text
