"""The port's TensorFlow flavours of EXPORT (``yoloret_tpu_torch/export/
{tfjs,tf_postprocess,warmup,export}.py``) against the JAX package and
against the port's own float32 program, on the CPU with TensorFlow.

- The TF mirror of the detector's forward (``tfjs.tf_mirror``) against
  the JAX forward and the port's float32 forward, MobileNetV2 x0.75 and
  EfficientNet-B0 at 64x64 b2, on the shared calibrated set-up of
  ``tests/_torch_parity.py`` (heads up to ~6): rtol 1e-3 (the JAX test's,
  ``tests/test_tfjs.py``) and atol 5e-5. The JAX test's atol 1e-7 holds
  on its uncalibrated init only because every head there is below 1e-6;
  on unit-scale activations float32 sums leave up to 2.6e-5 between two
  executors, which no relative tolerance covers where a head element
  lies near 0.
- The tfjs graph model: op set, externalised Consts, shard bytes, and the
  graph read back equal to the mirror to rtol 1e-6, atol 1e-9.
- SERVING at 96x96 (567 positions, a partial pool of 256) on the JAX
  export tests' peaked weights (``tests/test_export.py::
  _peaked_checkpoint``: the JAX init of key 3, head kernels x4; here its
  init jitted), written by the JAX package's ``save_params`` and read by
  the port's ``load_params``: the signature, the slate
  against the port's ``InferenceProgram`` and the JAX program
  (``detect_batch(approx_topk=False)`` of the JAX forward), ``valid`` and
  ``classes`` equal, scores within 1e-4, boxes within 0.05 px; the
  warm-up records.
- TFLITE (``--quantize``, 3 calibration JPEGs): the dynamic-range
  ``model.tflite`` against the port's float program at the JAX test's
  tolerances (``tests/test_export.py``: valid and classes equal, scores
  0.02, boxes 1.5 px) and the full-int8 ``model_int8.tflite`` at the JAX
  criteria (int8 inside, float IO; its heads through the port's
  ``detect_batch`` keep all detections but at most one, scores 0.1, mean
  IoU 0.5).
- The TF postprocess's suppression against ``suppress_plain`` on the
  edge-case pools of ``tests/test_torch_cuda.py::NMS_CASES`` (ties, IoU
  exactly at the threshold, identical and zero-area boxes): exactly.

The TFLite checks run at the JAX test's threshold, 0.3, where these
weights give two detections (0.371 and 0.315) clear of the next score
(0.286): quantization moves scores by up to ~0.005 (dynamic range) and
~0.04 (int8), which reorders the crowded picks below (the port's own
seeded, peaked weights crowd their best scores 0.001-0.01 apart, and
there int8 kept 28 of 39 slots at 0.3). SERVING runs at 0.27, inside the
crowd: a float program against float programs.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import ANCHORS, SIZE, _map, make_pair, port_variables
from test_torch_cuda import NMS_CASES, NMS_MAX_DET, nms_case
from yoloret_tpu.nn import build_detector as jax_build_detector
from yoloret_tpu.ops import detect_batch as jax_detect_batch
from yoloret_tpu.utils.checkpoint import save_params as jax_save_params
from yoloret_tpu_torch.configs import RunConfig
from yoloret_tpu_torch.export import tf_postprocess
from yoloret_tpu_torch.export.export import (
    InferenceProgram,
    export_tf_flavor,
    program_weights,
)
from yoloret_tpu_torch.export.tfjs import (
    TFJS_SAFE_OPS,
    export_tfjs_graph_model,
    read_graph_model,
    tf_mirror,
    write_graph_model,
)
from yoloret_tpu_torch.export.warmup import read_warmup_records
from yoloret_tpu_torch.nn.detector import YoloReT
from yoloret_tpu_torch.ops.nms import fused_result
from yoloret_tpu_torch.ops.nms_kernel import suppress_plain
from yoloret_tpu_torch.ops.postprocess import detect_batch
from yoloret_tpu_torch.utils.checkpoint import load_params

tf = pytest.importorskip("tensorflow")

torch.set_num_threads(1)

MIRROR_TOL = dict(rtol=1e-3, atol=5e-5)
CLASSES = ["a", "b"]
PEAKED_SIZE = 96
SERVING_SCORE = 0.27
TFLITE_SCORE = 0.3


@pytest.fixture(scope="module")
def pairs():
    """One calibrated set-up and JAX forward per backbone (64x64 b2), made
    on first use: (inputs, JAX heads, port model, its TF mirror)."""
    cache = {}

    def get(name):
        if name not in cache:
            x, _, want, port = make_pair(jax_build_detector(name, num_classes=len(CLASSES)),
                                         YoloReT(name, num_classes=len(CLASSES)), port_variables)
            cache[name] = x, want, port, tf_mirror(port, 2, (SIZE, SIZE))
        return cache[name]

    return get


@pytest.mark.parametrize("backbone", ["mobilenetv2x75", "efficientnetb0"])
def test_tf_mirror_matches_jax(pairs, backbone):
    x, want, _, raw = pairs(backbone)
    got = raw(x)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, **MIRROR_TOL)


@pytest.mark.parametrize("backbone", ["mobilenetv2x75", "efficientnetb0"])
def test_tf_mirror_matches_the_ports_forward(pairs, backbone):
    x, _, port, raw = pairs(backbone)
    with torch.no_grad():
        want = port(torch.from_numpy(x))
    for g, w in zip(raw(x), want):
        assert tuple(g.shape) == tuple(w.shape)
        assert np.abs(w.numpy()).max() > 0.5, "heads too small for the comparison to mean much"
        np.testing.assert_allclose(g.numpy(), w.numpy(), **MIRROR_TOL)


def test_tfjs_artifact_round_trip(pairs, tmp_path):
    """The graph model written, read back as the JS runtime reads it
    (weights from the shards in manifest order, Consts resolved by name)
    and run: equal to the mirror."""
    x, _, _, raw = pairs("mobilenetv2x75")
    out = write_graph_model(raw.get_concrete_function(), str(tmp_path / "tfjs_model"))
    with open(os.path.join(out, "model.json")) as f:
        meta = json.load(f)
    assert meta["format"] == "graph-model"
    assert meta["convertedBy"].startswith("yoloret_tpu_torch ")
    ops = {n["op"] for n in meta["modelTopology"]["node"]}
    assert ops <= TFJS_SAFE_OPS, f"ops outside the tfjs registry: {ops - TFJS_SAFE_OPS}"
    assert {"Conv2D", "DepthwiseConv2dNative", "Relu6"} <= ops and "Pad" not in ops
    for n in meta["modelTopology"]["node"]:
        if n["op"] == "Const":
            t = n["attr"]["value"]["tensor"]
            assert "tensorContent" not in t and "floatVal" not in t
    group = meta["weightsManifest"][0]
    n_bytes = sum(os.path.getsize(os.path.join(out, p)) for p in group["paths"])
    sizes = {"float32": 4, "int32": 4, "bool": 1}
    assert n_bytes == sum(int(np.prod(w["shape"]) if w["shape"] else 1) * sizes[w["dtype"]]
                          for w in group["weights"])

    graph, sig = read_graph_model(out)
    with tf.compat.v1.Session(graph=graph) as sess:
        outs = sess.run([sig["outputs"][k]["name"] for k in ("y1", "y2", "y3")],
                        {sig["inputs"]["images"]["name"]: x})
    for a, b in zip(raw(x), outs):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("backbone,rfcr", [("yolo_nano", "weighted_sum"),
                                           ("darknet53", "weighted_sum"),
                                           ("mobilenetv2x75", "concat")])
def test_tfjs_unsupported_model_raises(peaked, tmp_path, backbone, rfcr):
    """The tfjs graph model refuses YOLO-Nano and DarkNet-53 with the JAX
    package's message, before building anything (their other flavours:
    ``tests/test_torch_tf_export_legacy.py``); every flavour refuses the
    RFCR ``concat`` fusion, which the JAX flavours never build, before
    writing anything."""
    cfg = peaked.cfg.replace(backbone=backbone, rfcr=rfcr, model=None)
    if rfcr == "weighted_sum":
        with pytest.raises(ValueError, match=r"\(mobilenetv2\*/efficientnetb\* backbones\); got "
                                             f"'{backbone}'$"):
            export_tfjs_graph_model(cfg, str(tmp_path / "x"))
        assert not (tmp_path / "x").exists()
        return
    for flavor in ("serving", "tfjs"):
        with pytest.raises(ValueError, match="without its rfcr"):
            export_tf_flavor(cfg, str(tmp_path / "y"), flavor)
    assert not (tmp_path / "y").exists()


# -- the whole program: SERVING and TFLITE on peaked weights ------------------


class _Peaked:
    pass


@pytest.fixture(scope="module")
def peaked(tmp_path_factory):
    """x0.75, 2 classes: the JAX variables of the peaked recipe, saved as a
    JAX weight directory (``cfg.model``) and read back by the port into
    its model; the JAX detector and a 96x96 image. ``cfg`` asks for bf16,
    which the TF flavours ignore (float32)."""
    p = _Peaked()
    p.root = tmp_path_factory.mktemp("tf_export")
    (p.root / "classes.txt").write_text("\n".join(CLASSES) + "\n")
    (p.root / "anchors.txt").write_text(", ".join(f"{int(w)},{int(h)}" for w, h in ANCHORS) + "\n")
    p.jax_model = jax_build_detector("mobilenetv2x75", num_classes=len(CLASSES),
                                     dtype=jnp.float32)
    v = jax.device_get(jax.jit(lambda k: p.jax_model.init(
        k, jnp.zeros((1, PEAKED_SIZE, PEAKED_SIZE, 3)), False))(jax.random.PRNGKey(3)))
    p.variables = {"params": _map(v["params"], lambda path, a: a * 4.0 if path[-1] == "kernel"
                                  and any("head" in q for q in path) else a),
                   "batch_stats": v["batch_stats"]}
    jax_save_params(str(p.root / "peaked"), p.variables)
    p.model = YoloReT("mobilenetv2x75", num_classes=len(CLASSES))
    p.model.load_state_dict(load_params(str(p.root / "peaked")), strict=True)
    p.model.eval()
    p.cfg = RunConfig(backbone="mobilenetv2x75", input_size=(PEAKED_SIZE, PEAKED_SIZE),
                      classes_path=str(p.root / "classes.txt"),
                      anchors_path=str(p.root / "anchors.txt"), bf16=True,
                      model=str(p.root / "peaked"), score_threshold=SERVING_SCORE)
    p.images = (np.random.RandomState(0).rand(1, PEAKED_SIZE, PEAKED_SIZE, 3) ** 2).astype(
        np.float32)
    return p


def port_slate(p, images, hw, score):
    program = InferenceProgram("mobilenetv2x75", len(CLASSES), torch.float32, "weighted_sum",
                               score, 0.5)
    with torch.no_grad():
        return [t.numpy() for t in program(program_weights(p.model, ANCHORS),
                                           torch.from_numpy(images), torch.from_numpy(hw))]


def jax_slate(p, images, hw, score):
    """The JAX package's TF-flavour program (``export.py::_build_infer``'s
    ``infer``) on the same weights."""
    def infer(v, x, image_hw):
        outs = p.jax_model.apply(v, x, False)
        r = jax_detect_batch(outs, jnp.asarray(ANCHORS), num_classes=len(CLASSES),
                             image_hw=image_hw, score_threshold=score, iou_threshold=0.5,
                             approx_topk=False)
        return r.boxes, r.scores, r.classes, r.valid

    return [np.asarray(t) for t in jax.jit(infer)(p.variables, images, hw)]


@pytest.fixture(scope="module")
def serving(peaked):
    return export_tf_flavor(peaked.cfg, str(peaked.root / "srv"), "serving")


def assert_same_slate(got, want):
    boxes, scores, classes, valid = got
    np.testing.assert_array_equal(valid, want[3])
    np.testing.assert_array_equal(classes, want[2])
    np.testing.assert_allclose(scores, want[1], atol=1e-4, rtol=0)
    np.testing.assert_allclose(boxes, want[0], atol=0.05, rtol=0)


def test_serving_slate_matches_the_port_and_jax(peaked, serving):
    saved = os.path.join(serving, "saved_model")
    fn = tf.saved_model.load(saved).signatures["serving_default"]
    _, inputs = fn.structured_input_signature
    assert {k: (tuple(v.shape), v.dtype) for k, v in inputs.items()} == {
        "images": ((1, PEAKED_SIZE, PEAKED_SIZE, 3), tf.float32),
        "image_hw": ((1, 2), tf.float32)}
    n = len(CLASSES) * 20
    assert {k: (tuple(v.shape), v.dtype) for k, v in fn.structured_outputs.items()} == {
        "output_0": ((1, n, 4), tf.float32), "output_1": ((1, n), tf.float32),
        "output_2": ((1, n), tf.int32), "output_3": ((1, n), tf.bool)}
    hw = np.asarray([[120.0, 160.0]], np.float32)
    res = fn(images=tf.constant(peaked.images), image_hw=tf.constant(hw))
    got = [res[f"output_{i}"].numpy() for i in range(4)]
    want = port_slate(peaked, peaked.images, hw, SERVING_SCORE)
    assert 0 < want[3].sum() < want[3].size, "the threshold must keep some slots and drop others"
    assert_same_slate(got, want)
    assert_same_slate(got, jax_slate(peaked, peaked.images, hw, SERVING_SCORE))


def test_serving_writes_warmup_records_that_drive_the_signature(peaked, serving):
    saved = os.path.join(serving, "saved_model")
    assert os.path.exists(os.path.join(saved, "assets.extra", "tf_serving_warmup_requests"))
    recs = read_warmup_records(saved)
    assert len(recs) == 2
    fn = tf.saved_model.load(saved).signatures["serving_default"]
    for name, sig, inputs in recs:
        assert name == "mobilenetv2x75" and sig == "serving_default"
        assert set(inputs) == {"images", "image_hw"}
        assert inputs["images"].shape == (1, PEAKED_SIZE, PEAKED_SIZE, 3)
        assert inputs["images"].dtype == np.float32
        np.testing.assert_array_equal(inputs["image_hw"], [[PEAKED_SIZE, PEAKED_SIZE]])
        res = fn(images=tf.constant(inputs["images"]), image_hw=tf.constant(inputs["image_hw"]))
        assert all(np.isfinite(v.numpy()).all() for v in res.values())


@pytest.fixture(scope="module")
def tflite(peaked):
    """TFLITE with --quantize, calibrated on 3 JPEGs of a train list."""
    from PIL import Image

    rng = np.random.RandomState(1)
    lines = []
    for i in range(3):
        path = peaked.root / f"cal{i}.jpg"
        Image.fromarray((rng.rand(80, 100, 3) * 255).astype(np.uint8)).save(path)
        lines.append(f"{path} 10,10,60,50,0")
    (peaked.root / "cal.txt").write_text("\n".join(lines) + "\n")
    cfg = peaked.cfg.replace(score_threshold=TFLITE_SCORE, quantize=True, quantize_samples=3,
                             train_dataset=str(peaked.root / "cal.txt"))
    return export_tf_flavor(cfg, str(peaked.root / "tfl"), "tflite")


def run_tflite(path, images, hw=None):
    interp = tf.lite.Interpreter(model_path=path)
    interp.allocate_tensors()
    for d in interp.get_input_details():
        interp.set_tensor(d["index"], images if d["shape"][-1] == 3 else hw)
    interp.invoke()
    return interp, [(o["dtype"], tuple(o["shape"][1:]), interp.get_tensor(o["index"]))
                    for o in interp.get_output_details()]


def test_tflite_dynamic_range_matches_the_float_program(peaked, tflite):
    hw = np.full((1, 2), float(PEAKED_SIZE), np.float32)
    _, outs = run_tflite(os.path.join(tflite, "model.tflite"), peaked.images, hw)
    n = len(CLASSES) * 20
    by = {(np.dtype(dt).name, shape): t for dt, shape, t in outs}
    boxes, scores = by[("float32", (n, 4))], by[("float32", (n,))]
    classes, valid = by[("int32", (n,))], by[("bool", (n,))]
    want = port_slate(peaked, peaked.images, hw, TFLITE_SCORE)
    assert want[3].sum() > 0, "peaked weights must produce detections"
    np.testing.assert_array_equal(valid, want[3])
    np.testing.assert_array_equal(classes, want[2])
    m = want[3][0]
    np.testing.assert_allclose(scores[0][m], want[1][0][m], atol=0.02)
    np.testing.assert_allclose(boxes[0][m], want[0][0][m], atol=1.5)


def _iou(a, b):
    yx1, yx2 = np.maximum(a[:2], b[:2]), np.minimum(a[2:], b[2:])
    inter = np.prod(np.maximum(yx2 - yx1, 0.0))
    return inter / max(np.prod(a[2:] - a[:2]) + np.prod(b[2:] - b[:2]) - inter, 1e-9)


def test_tflite_full_int8_keeps_the_detections(peaked, tflite):
    path = os.path.join(tflite, "model_int8.tflite")
    interp, outs = run_tflite(path, peaked.images)
    assert "int8" in {d["dtype"].__name__ for d in interp.get_tensor_details()}
    assert all(d["dtype"].__name__ == "float32" for d in interp.get_input_details())
    heads = {shape: t for _, shape, t in outs}
    grids = [(PEAKED_SIZE // s, PEAKED_SIZE // s) for s in (32, 16, 8)]
    t_outs = [torch.from_numpy(heads[(gh, gw, 3, 5 + len(CLASSES))]) for gh, gw in grids]
    hw = np.full((1, 2), float(PEAKED_SIZE), np.float32)
    r = detect_batch(t_outs, torch.from_numpy(ANCHORS), len(CLASSES), torch.from_numpy(hw),
                     score_threshold=TFLITE_SCORE, iou_threshold=0.5)
    jb, js, _, jv = port_slate(peaked, peaked.images, hw, TFLITE_SCORE)
    tv, ts, tb = r.valid.numpy(), r.scores.numpy(), r.boxes.numpy()
    assert jv.sum() > 0
    m = jv[0] & tv[0]
    assert m.sum() >= max(1, int(jv.sum()) - 1)  # int8 keeps the detections
    np.testing.assert_allclose(ts[0][m], js[0][m], atol=0.1)
    ious = [_iou(tb[0][i], jb[0][i]) for i in np.where(m)[0]]
    assert np.mean(ious) >= 0.5, ious


# -- the TF suppression against the port's plain one --------------------------


@pytest.mark.parametrize("name", sorted(NMS_CASES))
def test_tf_suppress_equals_suppress_plain(name):
    boxes, scores, thr = nms_case(name)
    want = fused_result(*suppress_plain(torch.from_numpy(boxes), torch.from_numpy(scores),
                                        max_det=NMS_MAX_DET, iou_threshold=0.5,
                                        score_threshold=thr))
    got = tf_postprocess.slate(*tf_postprocess.suppress(
        tf.constant(boxes), tf.constant(scores), max_det=NMS_MAX_DET, iou_threshold=0.5,
        score_threshold=thr))
    for g, w in zip(got, want):
        g, w = g.numpy(), w.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))  # bit for bit
