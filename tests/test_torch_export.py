"""The port's EXPORT path (``yoloret_tpu_torch/export/``, the operators of
``ops/library.py``, the CLI's EXPORT / TFLITE) against the JAX package's
``export_stablehlo`` / ``quantize_tree``, on the CPU.

x0.75 at 64x64, 2 classes, float32, on the peaked weights of
``_torch_parity.peaked_variables`` (scores far from ties). The JAX
program takes its weights as an argument, so its bundle is traced from
the shapes of its init (``jax.eval_shape``: no init is computed) and
called with the same weights as the port's bundle.
"""

import contextlib
import io
import json
import os
import sys
import types
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import ANCHORS, SIZE, peaked_variables
from yoloret_tpu.configs import RunConfig as JaxRunConfig
from yoloret_tpu.export import export as jax_export_mod
from yoloret_tpu.export.quantize import quantize_tree
from yoloret_tpu.nn import build_detector as jax_build_detector
from yoloret_tpu_torch.cli.main import main as cli_main
from yoloret_tpu_torch.configs import RunConfig
from yoloret_tpu_torch.export.export import bundle_graph_counts, export_bundle, load_bundle
from yoloret_tpu_torch.export.quantize import dequantize_state_dict, quantize_state_dict
from yoloret_tpu_torch.ops.library import mbconv as mbconv_op
from yoloret_tpu_torch.ops.library import nms as nms_op
from yoloret_tpu_torch.ops.mbconv import pack_mbconv
from yoloret_tpu_torch.weights import from_flax

torch.set_num_threads(1)

CLASSES = ["a", "b"]
BATCH = 2
SCORE = 0.285  # about half of the 80 slots of the slate pass it
IMAGE_HW = np.asarray([[480.0, 640.0], [300.0, 200.0]], np.float32)
ROUND_TRIP_SCORE = 0.1  # below every score, as tests/test_export.py's round trip
JAX_ONLY_KEYS = {"jax_version", "calling_convention_version", "platforms"}


class _ShapeInit:
    """A JAX detector whose ``init`` returns zeros of the init's shapes
    (``jax.eval_shape``): ``export_stablehlo`` needs only the structure."""

    def __init__(self, model):
        self.model = model

    def init(self, key, x, train):
        shapes = jax.eval_shape(lambda k: self.model.init(k, x, train), key)
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    def apply(self, *a, **kw):
        return self.model.apply(*a, **kw)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("export")
    (root / "classes.txt").write_text("\n".join(CLASSES) + "\n")
    (root / "anchors.txt").write_text(", ".join(f"{int(w)},{int(h)}" for w, h in ANCHORS) + "\n")
    variables = peaked_variables(jax_build_detector("mobilenetv2x75", num_classes=2), 2)
    state = from_flax(variables)
    torch.save(state, root / "peaked.pt")
    images = np.random.RandomState(0).rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
    files = dict(classes_path=str(root / "classes.txt"), anchors_path=str(root / "anchors.txt"),
                 input_size=(SIZE, SIZE), bf16=False, score_threshold=SCORE)
    return types.SimpleNamespace(root=root, variables=variables, state=state, images=images,
                                 files=files)


@pytest.fixture(scope="module")
def jax_bundle(setup):
    """The JAX bundle's slate on the peaked weights, and its model.json."""
    from jax import export as jax_export

    out = str(setup.root / "jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_export_mod, "build_detector",
                   lambda *a, **kw: _ShapeInit(jax_build_detector(*a, **kw)))
        jax_export_mod.export_stablehlo(JaxRunConfig(backbone="mobilenetv2x75", **setup.files),
                                        out, batch=BATCH)
    with open(os.path.join(out, "model.stablehlo"), "rb") as f:
        exported = jax_export.deserialize(f.read())
    slate = exported.call(setup.variables, jnp.asarray(setup.images), jnp.asarray(IMAGE_HW))
    with open(os.path.join(out, "model.json")) as f:
        meta = json.load(f)
    return [np.asarray(t) for t in slate], meta


@pytest.fixture(scope="module")
def port_bundle(setup):
    out = str(setup.root / "port")
    export_bundle(RunConfig(model=str(setup.root / "peaked.pt"), **setup.files), out,
                  batch=BATCH, device="cpu")
    return out, load_bundle(out, device="cpu")


def _slate(bundle, images, hw):
    return [t.numpy() for t in bundle(torch.from_numpy(images), torch.from_numpy(hw))]


def test_bundle_matches_jax_bundle(setup, jax_bundle, port_bundle):
    want, _ = jax_bundle
    got = _slate(port_bundle[1], setup.images, IMAGE_HW)
    assert [g.shape for g in got] == [w.shape for w in want]
    boxes, scores, classes, valid = got
    np.testing.assert_array_equal(valid, want[3])
    np.testing.assert_array_equal(classes, want[2])
    np.testing.assert_allclose(scores, want[1], rtol=1e-6)
    np.testing.assert_allclose(boxes, want[0], rtol=1e-5, atol=1e-4)
    assert 0 < valid.sum() < valid.size, "the threshold must keep some slots and drop others"


def test_bundle_graph_and_files(jax_bundle, port_bundle):
    out, bundle = port_bundle
    counts = bundle_graph_counts(bundle.program)
    assert counts == {"mbconv": 16, "nms": 1, "argmax": 0, "tensors": 0}, counts
    assert bundle.program.example_inputs is None
    with zipfile.ZipFile(os.path.join(out, "model.pt2")) as z:
        data = [i for i in z.infolist() if "/data/" in i.filename and i.file_size > 64]
    assert not data, [i.filename for i in data]  # no sample inputs, weights or constants
    _, jax_meta = jax_bundle
    meta = bundle.meta
    assert set(jax_meta) - JAX_ONLY_KEYS <= set(meta)
    for k in set(jax_meta) - JAX_ONLY_KEYS:
        assert meta[k] == jax_meta[k], k
    assert meta["device"] == "cpu" and meta["torch_version"] == torch.__version__
    assert os.path.getsize(os.path.join(out, "model.pt2")) < os.path.getsize(
        os.path.join(out, "weights.pt"))


def test_load_bundle_refuses_another_device(port_bundle, tmp_path):
    out, _ = port_bundle
    with open(os.path.join(out, "model.json")) as f:
        meta = json.load(f)
    (tmp_path / "model.json").write_text(json.dumps(dict(meta, device="cuda")))
    with pytest.raises(ValueError, match="exported on 'cuda'"):
        load_bundle(str(tmp_path), device="cpu")


def _port_codes(tree, leaf):
    """A quantize_tree result with each {"q", "scale"} node replaced by
    ``leaf`` of it, as the port's state dict (``from_flax``'s relayout
    for codes)."""
    def walk(t):
        return {k: (leaf(v) if isinstance(v, dict) and set(v) == {"q", "scale"} else walk(v))
                if isinstance(v, dict) else v for k, v in t.items()}

    return walk(tree)


def test_quantize_matches_jax(setup):
    qtree, jstats = quantize_tree(setup.variables["params"])
    qstate, stats = quantize_state_dict(setup.state)
    assert stats == jstats and stats["quantized"] > 50
    codes = from_flax({"params": _port_codes(qtree, lambda v: v["q"].astype(np.float32))})
    scales = {}

    def collect(t, path=()):
        for k, v in t.items():
            if isinstance(v, dict) and set(v) == {"q", "scale"}:
                scales[".".join(path + (k,)).replace(".kernel", ".weight")] = v["scale"]
            elif isinstance(v, dict):
                collect(v, path + (k,))

    collect(qtree)
    quantized = {k for k, v in qstate.items() if isinstance(v, dict)}
    assert quantized == set(scales)
    for name in quantized:
        assert qstate[name]["q"].dtype == torch.int8
        np.testing.assert_array_equal(qstate[name]["q"].numpy().astype(np.float32), codes[name])
        np.testing.assert_array_equal(qstate[name]["scale"].numpy(), scales[name])
    for name, v in qstate.items():
        if name not in quantized:
            assert v is setup.state[name]
    deq = dequantize_state_dict(qstate)
    assert set(deq) == set(setup.state)
    for name in quantized:
        assert (deq[name] - setup.state[name]).abs().max() <= qstate[name]["scale"].max() / 2


def _cli(setup, *flags):
    return cli_main(["--no-bf16", "--device=cpu", f"--model={setup.root / 'peaked.pt'}",
                     f"--classes_path={setup.files['classes_path']}",
                     f"--anchors_path={setup.files['anchors_path']}", f"--input_size={SIZE}",
                     f"--score={ROUND_TRIP_SCORE}", *flags])


@pytest.fixture(scope="module")
def tflite_bundle(setup):
    """--mode=TFLITE where TensorFlow cannot be imported: (rc, stdout, the
    bundle's directory)."""
    out = str(setup.root / "tfl")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorflow", None)  # import -> ImportError
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = _cli(setup, "--mode=TFLITE", f"--output={out}")
    return rc, buf.getvalue(), out


def test_cli_tflite_without_tensorflow_writes_the_bundle(tflite_bundle):
    rc, text, out = tflite_bundle
    assert rc == 0 and "TensorFlow runtime not present" in text
    assert "PyTorch export bundle" in text
    assert sorted(os.listdir(out)) == ["model.json", "model.pt2", "weights.pt"]


def test_cli_export_quantized_round_trip(setup, tflite_bundle, capsys):
    """--mode=EXPORT --quantize: rc 0, a smaller weight file, and the
    dequantized bundle's slate within the JAX test's criteria of the
    float bundle's at its threshold (scores within 0.05, classes
    equal)."""
    out = str(setup.root / "q")
    rc = _cli(setup, "--mode=EXPORT", "--quantize", f"--export={out}")
    text = capsys.readouterr().out
    assert rc == 0 and "int8 weights:" in text and "PyTorch export bundle" in text
    fp_dir = tflite_bundle[2]
    assert (os.path.getsize(os.path.join(out, "weights.pt"))
            < os.path.getsize(os.path.join(fp_dir, "weights.pt")) / 3)
    q, fp = load_bundle(out, device="cpu"), load_bundle(fp_dir, device="cpu")
    assert q.meta["quantized"] is True and fp.meta["quantized"] is False
    assert q.meta["batch"] == 1
    _, s_q, c_q, v_q = _slate(q, setup.images[:1], IMAGE_HW[:1])
    _, s_fp, c_fp, v_fp = _slate(fp, setup.images[:1], IMAGE_HW[:1])
    assert v_fp.all()
    np.testing.assert_allclose(s_q, s_fp, atol=0.05)
    np.testing.assert_array_equal(c_q, c_fp)


TF_ARTIFACTS = {"TFLITE": ["model.tflite", "saved_model"], "SERVING": ["saved_model"],
                "TFJS": ["saved_model", "tfjs_model"]}


@pytest.mark.parametrize("mode", ["TFLITE", "SERVING", "TFJS"])
def test_cli_tf_flavours_refused_where_tensorflow_imports(setup, capsys, mode):
    """Named for what these modes did before TensorFlow's formats were
    ported (they refused where TensorFlow imports). Now, with TensorFlow,
    each writes its artifacts (``export_tf_flavor``; held against the JAX
    package and the port's program by tests/test_torch_tf_export.py):
    rc 0, the SavedModel, and ``model.tflite``, the warm-up records or
    the tfjs graph model."""
    pytest.importorskip("tensorflow")
    out = setup.root / f"tf_{mode}"
    rc = _cli(setup, f"--mode={mode}", f"--export={out}")
    assert rc == 0, capsys.readouterr().err
    assert sorted(os.listdir(out)) == TF_ARTIFACTS[mode]
    assert os.path.exists(os.path.join(out, "saved_model", "saved_model.pb"))
    extra = {"TFLITE": "model.tflite",
             "SERVING": "saved_model/assets.extra/tf_serving_warmup_requests",
             "TFJS": "tfjs_model/model.json"}[mode]
    assert os.path.getsize(os.path.join(out, extra)) > 0


def _block(seed, cin, ce, cout, expand):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g) * 0.3  # noqa: E731
    we, be = (r(cin, ce), r(ce)) if expand else (None, None)
    return we, be, r(3, 3, ce), r(ce), r(ce, cout), r(cout)


@pytest.mark.parametrize("case", ["no_expand", "expand_stride2", "packed_bf16"])
def test_opcheck_mbconv(case):
    g = torch.Generator().manual_seed(1)
    if case == "no_expand":
        x, w, stride, residual = torch.rand(2, 8, 8, 16, generator=g), _block(0, 16, 16, 16,
                                                                             False), 1, True
    else:
        x, w, stride, residual = torch.rand(2, 8, 6, 8, generator=g), _block(1, 8, 48, 16,
                                                                            True), 2, False
    packed = None
    if case == "packed_bf16":
        x = x.to(torch.bfloat16)
        w = tuple(None if t is None else (t if t.dim() == 1 else t.to(torch.bfloat16))
                  for t in w)
        packed = pack_mbconv(*w[:5]).w
    torch.library.opcheck(mbconv_op, (x, *w, packed, stride, residual))
    want = mbconv_op(x, *w, packed, stride, residual)
    assert want.shape == (2, -(-x.shape[1] // stride), -(-x.shape[2] // stride), 16)


@pytest.mark.parametrize("shared", [True, False])
def test_opcheck_nms(shared):
    rs = np.random.RandomState(2)
    b, c, k = 2, 3, 40
    xy = rs.rand(b, k, 2) * 50
    boxes = np.concatenate([xy, xy + 5 + rs.rand(b, k, 2) * 20], -1).astype(np.float32)
    if not shared:
        boxes = np.repeat(boxes[:, None], c, 1) + rs.rand(b, c, k, 4).astype(np.float32)
    scores = rs.rand(b, c, k).astype(np.float32)
    args = (torch.from_numpy(np.ascontiguousarray(boxes)), torch.from_numpy(scores), 5, 0.5,
            0.3, float("-inf") if not shared else 0.0)
    torch.library.opcheck(nms_op, args)
    out_b, out_s = nms_op(*args)
    assert out_b.shape == (b, c, 5, 4) and out_s.shape == (b, c, 5)
