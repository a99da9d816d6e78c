"""The port's W8A8 int8 backbone (``yoloret_tpu_torch/nn/int8_infer.py``)
against the JAX package's (``yoloret_tpu/nn/int8_infer.py``), and its
entry points: ``Predictor(use_int8=True)``, the CLI's ``--int8`` with
the JAX package's calibration images, the server's ``--int8``.

MobileNetV2 x0.75 (relu6, folded and unfolded epilogues) and
EfficientNet-B0 (swish, squeeze-excite, 5x5 depthwise) at 64x64, batch 2,
3 classes, float32 on the CPU; the port's seeded init in the Flax tree
with BatchNorm calibrated on the inputs (``tests/_torch_parity.py``).
The JAX side runs jitted once per backbone (its calibration, then one
program for every block's output and the heads).

Tolerances: calibration scales within 1e-5 relative (each side's float32
forward sums in its own order, so amaxes differ in the last ulps); the
int8 weights equal; each block, run from the JAX block's own int8 input
on the JAX weights (``weights.int8_from_flax``), equal codes or off by 1
on at most 0.1% of them (float32 rounding in the epilogues, and swish's
sigmoid, may put a value on the other side of a .5). The whole int8
detector's heads within HEADS_TOL: MobileNetV2's codes come out equal
all the way, so its heads agree to float32 rounding; EfficientNet's
swish and squeeze-excite (and the port's stem, in float64 rounded to
float32, against XLA's float32) flip a few codes, and each flipped code
moves the chain after it, which seeded weights amplify block by block,
so its heads are held to 15% of the largest head and 10% relative RMS.
"""

import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parity import ANCHORS, SIZE, calibrated_pair, port_variables
from yoloret_tpu.cli import main as jax_cli
from yoloret_tpu.nn import build_detector as jax_build_detector
from yoloret_tpu.nn import int8_infer as jax_int8
from yoloret_tpu_torch.cli import main as cli
from yoloret_tpu_torch.configs import RunConfig
from yoloret_tpu_torch.data import tfrecord
from yoloret_tpu_torch.infer import Predictor
from yoloret_tpu_torch.nn import detector, int8_infer
from yoloret_tpu_torch.nn.detector import YoloReT
from yoloret_tpu_torch.serve import server
from yoloret_tpu_torch.weights import int8_from_flax

torch.set_num_threads(1)

CLASSES = ["a", "b", "c"]
SCALE_RTOL = 1e-5
CODE_FLIP_SHARE = 1e-3  # codes off by one, at most
# the whole int8 detector's heads: (largest difference over the largest
# |head|, relative RMS difference)
HEADS_TOL = {"mobilenetv2x75": (1e-5, 1e-5), "efficientnetb0": (0.15, 0.1)}
BACKBONES = ("mobilenetv2x75", "efficientnetb0")


def _jax_chain(model, variables, qp, x, folded):
    """The JAX int8 chain: (stem codes, per block (input, folded output,
    unfolded output), heads)."""
    st = qp["stem"]
    y = jax.lax.conv_general_dilated(x, st["kernel"], (2, 2), "SAME",
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"))
    y = jax_int8._act(y + st["bias"], st.get("act", "relu6"))
    xq = stem = jax_int8._q(y, st["out_s"])
    blocks = []
    for blk in qp["blocks"]:
        plain = jax_int8._int8_block(xq, blk, folded=False)
        outs = (jax_int8._int8_block(xq, blk, folded=True) if folded else plain, plain)
        blocks.append((xq,) + outs)
        xq = outs[0]
    heads = jax_int8.int8_detector_apply(model, variables, qp, x, folded=folded)
    return stem, blocks, heads


def _setup(name):
    """The port model, the JAX qp, the port's own qp, the JAX chain as
    numpy, the inputs."""
    jm = jax_build_detector(name, num_classes=len(CLASSES), dtype=jnp.float32)
    port = YoloReT(name, num_classes=len(CLASSES))
    x, variables = calibrated_pair(jm, port, port_variables)
    calib = np.random.RandomState(5).rand(4, SIZE, SIZE, 3).astype(np.float32)
    qp = jax.device_get(jax_int8.quantize_from_data(jm, variables, calib))
    chain = jax.device_get(jax.jit(
        lambda xx: _jax_chain(jm, variables, qp, xx, folded=name.startswith("mobile"))
    )(jnp.asarray(x)))
    return port, qp, int8_infer.quantize_from_data(port, calib), chain, x


def _warm(shape):
    """Compile the JAX weight quantization's eager ops for one kernel
    shape (``_quant_w`` runs op by op, each compiled at first use)."""
    jax_int8._quant_w(jnp.ones(shape, jnp.float32))


def _weight_shapes(name):
    """The shapes ``_quant_w`` meets in the JAX quantization of ``name``."""
    shapes = set()
    for m in YoloReT(name, num_classes=len(CLASSES)).body.modules():
        conv = getattr(m, "conv", None) or getattr(m, "dwconv", None)
        if conv is None or conv.weight.shape[1] == 3:  # the stem is not quantized
            continue
        o, i, kh, kw = conv.weight.shape
        shapes.add((kh * kw, o) if conv.groups > 1 else (i, o))
    return sorted(shapes)


@pytest.fixture(scope="module")
def setups():
    """Both backbones' set-ups, made at once in threads (the JAX side
    compiles without the interpreter lock; its quantization, run eagerly
    as the JAX Predictor runs it, compiles op by op, so its shapes are
    compiled ahead in two more threads)."""
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        futures = {name: pool.submit(_setup, name) for name in BACKBONES}
        warm = [pool.submit(_warm, s) for name in BACKBONES for s in _weight_shapes(name)]
        done = {name: f.result() for name, f in futures.items()}
        for f in warm:
            f.result()
    return done.__getitem__


def _scales(qp):
    out = {"stem": qp["stem"]["out_s"]}
    for i, blk in enumerate(qp["blocks"]):
        for k in ("in_s", "out_s", "e_s", "d_s", "p_in_s"):
            if k in blk:
                out[f"{i}.{k}"] = blk[k]
    return out


@pytest.mark.parametrize("name", BACKBONES)
def test_calibration_and_weights_match_jax(setups, name):
    _, qp, own, _, _ = setups(name)
    want, got = _scales(qp), _scales(own)
    assert sorted(got) == sorted(want)
    for k in want:
        assert isinstance(got[k], float), k
        np.testing.assert_allclose(got[k], want[k], rtol=SCALE_RTOL, err_msg=k)
    carried = int8_from_flax(qp)
    assert sorted(carried["blocks"][0]) == sorted(own["blocks"][0])
    for i, (c, o) in enumerate(zip(carried["blocks"], own["blocks"])):
        assert sorted(c) == sorted(o), i
        for k, v in o.items():
            if isinstance(v, torch.Tensor) and v.dtype == torch.int8:
                assert v.shape == c[k].shape and torch.equal(v, c[k]), (i, k)
            elif isinstance(v, torch.Tensor):
                np.testing.assert_allclose(v.numpy(), c[k].numpy(), rtol=1e-5, atol=1e-7,
                                           err_msg=f"{i}.{k}")
            else:
                assert type(v) is type(c[k]), (i, k)
    assert own.get("taps") == carried.get("taps")


def _assert_codes(got, want, what):
    got, want = got.numpy().astype(np.int32), np.asarray(want).astype(np.int32)
    assert got.shape == want.shape, what
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= CODE_FLIP_SHARE, (
        what, int(diff.max()), float((diff > 0).mean()))


@pytest.mark.parametrize("name,folded", [("mobilenetv2x75", True), ("mobilenetv2x75", False),
                                         ("efficientnetb0", False)])
def test_int8_blocks_match_jax(setups, name, folded):
    _, qp, _, (_, blocks, _), _ = setups(name)
    carried = int8_from_flax(qp)
    for i, (blk, (xq, out_folded, out_plain)) in enumerate(zip(carried["blocks"], blocks)):
        got = int8_infer._int8_block(torch.from_numpy(np.array(xq)), blk, folded=folded)
        assert got.dtype == torch.int8
        _assert_codes(got, out_folded if folded else out_plain, (name, folded, i))


@pytest.mark.parametrize("name", BACKBONES)
def test_int8_detector_apply_matches_jax(setups, name):
    port, qp, _, (stem, _, heads), x = setups(name)
    carried = int8_from_flax(qp)
    xt = torch.from_numpy(x)
    _assert_codes(int8_infer._stem_i8(carried["stem"], xt, torch.float32), stem, "stem")
    got = int8_infer.int8_detector_apply(port, carried, xt)
    max_rel, rms_rel = HEADS_TOL[name]
    for g, w in zip(got, heads):
        w = np.asarray(w)
        assert np.abs(w).max() > 0.5
        d = np.abs(g.numpy() - w)
        assert d.max() <= max_rel * np.abs(w).max(), (name, d.max(), np.abs(w).max())
        assert np.sqrt((d ** 2).mean() / (w ** 2).mean()) <= rms_rel, name


def test_int8_tensors_cross_as_int8(setups, monkeypatch):
    """Every backbone conv after the stem takes int8 operands (and the
    1x1 products give int32), as the JAX package's test holds its jaxpr."""
    port, _, own, _, x = setups("mobilenetv2x75")
    seen = []
    mm, dw = int8_infer.int_mm, int8_infer._dw_i8

    def rec_mm(a, w):
        out = mm(a, w)
        seen.append(("mm", a.dtype, w.dtype, out.dtype))
        return out

    def rec_dw(a, w, stride):
        seen.append(("dw", a.dtype, w.dtype, None))
        return dw(a, w, stride)

    monkeypatch.setattr(int8_infer, "int_mm", rec_mm)
    monkeypatch.setattr(int8_infer, "_dw_i8", rec_dw)
    int8_infer.int8_detector_apply(port, own, torch.from_numpy(x))
    assert len(seen) >= 40, len(seen)  # 16 blocks x 2-3 convs
    assert all(a == torch.int8 and w == torch.int8 for _, a, w, _ in seen), seen
    assert all(o == torch.int32 for kind, _, _, o in seen if kind == "mm")


def test_int_mm_shape_guard():
    rs = np.random.RandomState(0)

    def i8(*shape):
        return torch.from_numpy(rs.randint(-127, 128, shape).astype(np.int8))

    for m in (1, 16, 17, 40):  # rows padded to 17 below 17, cut off again
        a, w = i8(m, 24), i8(24, 16)
        assert torch.equal(int8_infer.int_mm(a, w), a.int() @ w.int())
    for k, n in ((12, 16), (24, 12), (0, 8)):
        with pytest.raises(ValueError, match="multiples of 8"):
            int8_infer.int_mm(i8(20, k), i8(k, n))
    # every 1x1 conv of every int8 backbone passes the guard (K, N % 8 == 0)
    for name in sorted(detector.BACKBONES):
        if not int8_infer.supports_int8(name):
            continue
        body = YoloReT(name, num_classes=3).body
        convs = [(m.conv.weight.shape[1], m.conv.weight.shape[0]) for m in body.modules()
                 if isinstance(m, detector.nn.Module) and hasattr(m, "conv")
                 and m.conv.weight.shape[-1] == 1]
        assert convs, name
        for k, n in convs:
            int8_infer.check_mm_shape(17, k, n)


def test_int8_rejects_other_backbones():
    model = YoloReT("darknet53", num_classes=3)
    with pytest.raises(ValueError, match="int8"):
        int8_infer.quantize_from_data(model, np.zeros((1, SIZE, SIZE, 3), np.float32))
    with pytest.raises(ValueError, match="int8"):
        Predictor("yolo_fastest", class_names=CLASSES, anchors=ANCHORS, input_hw=(SIZE, SIZE),
                  use_int8=True, device="cpu")


# -- entry points --------------------------------------------------------------


def _images(n, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, (int(rs.randint(40, 90)), int(rs.randint(40, 90)), 3), np.uint8)
            for _ in range(n)]


def test_predictor_int8_answers(setups):
    port, _, own, _, _ = setups("mobilenetv2x75")
    state = {k: v.clone() for k, v in port.state_dict().items()}
    pred = Predictor(weights=state, class_names=CLASSES, anchors=ANCHORS, input_hw=(SIZE, SIZE),
                     bf16=False, score_threshold=0.0, use_int8=True, device="cpu")
    images = _images(3)
    dets = pred.detect_arrays(images)
    assert len(dets) == 3 and all(len(d) > 0 for d in dets)
    # noise-calibrated, as the JAX Predictor: RandomState(0) uint8, 16 images
    noise = np.random.RandomState(0).randint(0, 256, (16, SIZE, SIZE, 3), np.uint8) / 255.0
    want = int8_infer.quantize_from_data(pred.model, noise.astype(np.float32))
    assert _scales(pred._qp) == _scales(want)
    # refresh() re-quantizes from the model's weights
    with torch.no_grad():
        pred.model.body.block_3.project.bn.weight.mul_(2.0)
    old = pred._qp["blocks"][3]["wp_q"].clone()
    pred.refresh()
    assert not torch.equal(pred._qp["blocks"][3]["p_deq"], want["blocks"][3]["p_deq"])
    assert torch.equal(pred._qp["blocks"][3]["wp_q"], old)  # per-channel: the codes stay


def _write_sets(root):
    """The same 5 images as a text list and as a TFRecord shard."""
    rs = np.random.RandomState(1)
    lines = []
    with tfrecord.TFRecordWriter(os.path.join(root, "set.tfrecord")) as wr:
        for i in range(5):
            h, w = (int(v) for v in rs.randint(40, 120, 2))
            path = os.path.join(root, f"im{i}.jpg")
            Image.fromarray(rs.randint(0, 256, (h, w, 3), np.uint8)).save(path)
            lines.append(f"{path} 1,2,{w - 3},{h - 3},{i % 3}")
            with open(path, "rb") as f:
                wr.write(tfrecord.Example({
                    "image/encoded": f.read(),
                    "image/object/bbox/xmin": [1.0 / w], "image/object/bbox/ymin": [2.0 / h],
                    "image/object/bbox/xmax": [(w - 3.0) / w],
                    "image/object/bbox/ymax": [(h - 3.0) / h],
                    "image/object/bbox/label": [float(i % 3)]}).serialize())
    with open(os.path.join(root, "list.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "classes.txt"), "w") as f:
        f.write("\n".join(CLASSES) + "\n")
    with open(os.path.join(root, "anchors.txt"), "w") as f:
        f.write(",".join(str(v) for v in ANCHORS.ravel()) + "\n")
    return root


@pytest.mark.parametrize("source", ["list.txt", "set.tfrecord"])
def test_int8_kw_calibration_images_match_jax(tmp_path, source):
    root = _write_sets(str(tmp_path))
    cfg = RunConfig().replace(int8=True, test_dataset=os.path.join(root, source),
                              input_size=(SIZE, SIZE), quantize_samples=4)
    got = cli._int8_kw(cfg)
    want = jax_cli._int8_kw(cfg)
    assert got["use_int8"] and want["use_int8"]
    assert got["calibration_images"].shape == (4, SIZE, SIZE, 3)
    np.testing.assert_array_equal(got["calibration_images"], want["calibration_images"])
    assert cli._int8_kw(RunConfig()) == {}


def test_cli_map_int8_runs(tmp_path, capsys):
    root = _write_sets(str(tmp_path))
    argv = ["--mode=MAP", "--int8", f"--test_dataset={root}/list.txt",
            f"--classes_path={root}/classes.txt", f"--anchors_path={root}/anchors.txt",
            f"--input_size={SIZE}", "--batch_size=2", "--no-bf16", "--device=cpu"]
    assert cli.main(argv) == 0
    assert "mAP" in capsys.readouterr().out


def test_server_int8_flag(monkeypatch, tmp_path):
    root = _write_sets(str(tmp_path))
    built = []
    monkeypatch.setattr(server.DetectionServer, "start", lambda self, block=True:
                        built.append(self.predictor))
    server.main([f"--classes_path={root}/classes.txt", f"--anchors_path={root}/anchors.txt",
                 f"--input_size={SIZE}", "--int8", "--device=cpu"])
    assert built and built[0]._qp is not None
