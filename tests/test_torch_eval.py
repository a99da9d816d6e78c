"""The port's mAP evaluation vs the JAX package: the AP bookkeeping, the
per-class candidate pool, ``evaluate_map`` end to end and the CLI's MAP
mode.

Float32 on the CPU, inputs made with numpy from a seed. The detector's
weights come from the port's seeded init carried into the Flax tree
(``_torch_parity.peaked_variables``), with the head kernels amplified (as
in tests/test_export.py::_peaked_checkpoint), so scores form distinct
peaks and no NMS tie-break depends on the backend; the ground truth is the
port's own detections on the dataset, so APs are not zero.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import yoloret_tpu_torch.native
from _torch_parity import peaked_variables
from test_torch_data import pinned_decoder
from test_torch_slice import ANCHORS, _heads
from yoloret_tpu.data.pipeline import Dataset as JaxDataset
from yoloret_tpu.data.pipeline import DatasetMode as JaxDatasetMode
from yoloret_tpu.eval.map import MAPEvaluator as JaxMAPEvaluator
from yoloret_tpu.eval.map import evaluate_map as jax_evaluate_map
from yoloret_tpu.eval.map import voc_ap as jax_voc_ap
from yoloret_tpu.nn import build_detector as jax_build_detector
from yoloret_tpu.ops.postprocess import detect_batch as jax_detect_batch
from yoloret_tpu_torch.cli.main import main as cli_main
from yoloret_tpu_torch.data import Dataset, tfrecord
from yoloret_tpu_torch.eval import MAPEvaluator, evaluate_map, voc_ap
from yoloret_tpu_torch.infer import Predictor
from yoloret_tpu_torch.ops.postprocess import detect_batch

torch.set_num_threads(1)

CLASSES = ["a", "b", "c"]
SIZE = 64
GRID = sum((SIZE // s) ** 2 * 3 for s in (32, 16, 8))  # 252 positions: --exact_nms's K


# -- AP bookkeeping -----------------------------------------------------------


def _random_eval(rs, n_images=12, c=4):
    """Per image: (pred boxes, scores, classes, gt [N, 5]), boxes near the
    GT (so some match) and random ones, a few images without GT."""
    out = []
    for i in range(n_images):
        n_gt = int(rs.randint(0, 5)) if i % 5 else 0
        xy = rs.rand(n_gt, 2) * 200
        gt = np.concatenate([xy, xy + 10 + rs.rand(n_gt, 2) * 80,
                             rs.randint(0, c, (n_gt, 1))], 1)
        near = gt[:, :4] + rs.randn(n_gt, 4) * 6
        far = rs.rand(int(rs.randint(0, 6)), 4) * 200
        far[:, 2:] += far[:, :2]
        boxes = np.concatenate([near, near + 1, far])
        scores = np.round(rs.rand(len(boxes)), 2)  # ties across images
        classes = np.concatenate([gt[:, 4], rs.randint(0, c, n_gt + len(far))])
        out.append((boxes, scores, classes, gt))
    return out


def test_voc_ap_matches_jax():
    rs = np.random.RandomState(0)
    for n in (1, 2, 7, 50):
        rec = np.sort(rs.rand(n))
        prec = rs.rand(n)
        assert voc_ap(rec, prec) == jax_voc_ap(rec, prec)


@pytest.mark.parametrize("iou", [0.5, 0.3, 0.75])
def test_map_evaluator_matches_jax(iou):
    data = _random_eval(np.random.RandomState(int(iou * 100)))
    got, want = MAPEvaluator(4, iou), JaxMAPEvaluator(4, iou)
    for args in data:
        assert got.add_image(*args) == want.add_image(*args)
    aps = got.compute()
    assert aps == want.compute()
    assert got.compute_range() == want.compute_range()
    assert 0 < np.mean(list(aps.values())) < 1


# -- the per-class pool -------------------------------------------------------

IMAGE_HW = np.asarray([[480.0, 640.0], [300.0, 200.0]], np.float32)


@pytest.mark.parametrize("thr,k,saturated", [(0.3, 64, False), (0.0, GRID, False),
                                             (0.0, GRID, True), (0.0, 100, True)])
def test_detect_batch_per_class_matches_jax(thr, k, saturated):
    """Per-class top-K (K = N is --exact_nms's whole grid), candidate
    boxes and greedy NMS per class. ``saturated``: class 2's logits at
    -200, so its scores are exactly 0 and tie everywhere -- at threshold 0
    its picks are real (valid), taken in position order."""
    heads = _heads(k + 7 * saturated)
    if saturated:
        for h in heads:
            h[..., 5 + 2] = -200.0
    want = jax_detect_batch([jnp.asarray(h) for h in heads], jnp.asarray(ANCHORS),
                            len(CLASSES), jnp.asarray(IMAGE_HW), score_threshold=thr,
                            num_candidates=k, pool="per_class", approx_topk=False)
    got = detect_batch([torch.from_numpy(h) for h in heads], torch.from_numpy(ANCHORS),
                       len(CLASSES), torch.from_numpy(IMAGE_HW), score_threshold=thr,
                       num_candidates=k, pool="per_class")
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-5, atol=1e-4)
    assert got.valid.any()
    if saturated:
        zero = got.valid & (got.classes == 2)
        assert zero.any() and not got.scores[zero].any()


def test_detect_batch_refuses_what_is_not_ported():
    """Since the zoom ensemble and ``use_pallas`` are ported, what is
    refused is what the JAX package refuses: an unknown pool, and the
    shared pool with either of them."""
    heads = [torch.from_numpy(h) for h in _heads(1)]
    anchors, hw = torch.from_numpy(ANCHORS), torch.from_numpy(IMAGE_HW)
    for kw in (dict(use_pallas=True), dict(zoom_outputs=heads)):
        assert detect_batch(heads, anchors, len(CLASSES), hw, **kw).valid.shape == (2, 60)
        with pytest.raises(ValueError, match="per-class"):
            detect_batch(heads, anchors, len(CLASSES), hw, pool="shared", **kw)
    with pytest.raises(ValueError, match="pool"):
        detect_batch(heads, anchors, len(CLASSES), hw, pool="both")


# -- evaluate_map and the CLI -------------------------------------------------


def _peaked_variables():
    model = jax_build_detector("mobilenetv2x75", num_classes=len(CLASSES))
    return model, peaked_variables(model, len(CLASSES))


def _write_images(root, n, rs):
    paths = []
    for i in range(n):
        h, w = (int(v) for v in rs.randint(48, 160, 2))
        # smooth gradients plus noise: some structure for the detector
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx * 255 / w, yy * 255 / h, (xx + yy) * 127 / (h + w)], -1)
        img = np.clip(base + rs.randn(h, w, 3) * 40, 0, 255).astype(np.uint8)
        paths.append(os.path.join(root, f"im{i}.jpg"))
        Image.fromarray(img).save(paths[-1])
    return paths


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    """Peaked weights (JAX and port), 5 JPEGs of mixed sizes and a dataset
    of them -- 3 in a text list, 2 in a TFRecord shard -- whose ground
    truth is the port's 2 best detections per image, a class changed on
    some so that not every detection matches."""
    root = str(tmp_path_factory.mktemp("eval"))
    rs = np.random.RandomState(5)
    jax_model, variables = _peaked_variables()
    pred = Predictor(class_names=CLASSES, anchors=ANCHORS, input_hw=(SIZE, SIZE), bf16=False,
                     weights=variables, device="cpu")
    paths = _write_images(root, 5, rs)
    with open(os.path.join(root, "all.lst"), "w") as f:
        f.write("\n".join(paths) + "\n")
    gt = []
    for batch in Dataset(os.path.join(root, "all.lst"), 5, input_hw=(SIZE, SIZE),
                         device="cpu").build(epochs=1):
        res = pred.infer(batch["images"], batch["image_hw"], score_threshold=0.0)
        for i in range(5):
            m = res.valid[i]
            order = torch.argsort(res.scores[i][m], descending=True)[:2]
            ymin, xmin, ymax, xmax = res.boxes[i][m][order].T.numpy()
            cls = res.classes[i][m][order].numpy().astype(np.float32)
            cls[rs.rand(len(cls)) < 0.3] = (cls[0] + 1) % len(CLASSES)
            gt.append(np.stack([xmin, ymin, xmax, ymax, cls], -1))
    lines = [p + "".join(" {!r},{!r},{!r},{!r},{}".format(*map(float, v[:4]), int(v[4])) for v in g)
             for p, g in zip(paths[:3], gt[:3])]
    with open(os.path.join(root, "test.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with tfrecord.TFRecordWriter(os.path.join(root, "test.tfrecord")) as w:
        for p, g in zip(paths[3:], gt[3:]):
            with Image.open(p) as im:
                iw, ih = im.size
            with open(p, "rb") as f:
                raw = f.read()
            w.write(tfrecord.Example({
                "image/encoded": raw,
                "image/object/bbox/xmin": [float(v) for v in g[:, 0] / iw],
                "image/object/bbox/ymin": [float(v) for v in g[:, 1] / ih],
                "image/object/bbox/xmax": [float(v) for v in g[:, 2] / iw],
                "image/object/bbox/ymax": [float(v) for v in g[:, 3] / ih],
                "image/object/bbox/label": [float(v) for v in g[:, 4]],
            }).serialize())
    return dict(root=root, pattern=os.path.join(root, "test.*"), pred=pred,
                jax_model=jax_model, variables=variables)


@pytest.mark.parametrize("pool,k,decoder", [("shared", 512, "pil"), ("shared", 512, "native"),
                                             ("per_class", GRID, "native")])
def test_evaluate_map_matches_jax(eval_setup, pool, k, decoder, tmp_path):
    """Both packages decode with ``decoder`` (test_torch_data.pinned_decoder)."""
    s = eval_setup
    with pinned_decoder(decoder, tmp_path):
        ds = Dataset(s["pattern"], 2, input_hw=(SIZE, SIZE), device="cpu")
        got_map, got_aps = evaluate_map(s["pred"], ds, CLASSES, num_candidates=k, pool=pool,
                                        verbose=False)
        assert ds.decodes == {decoder: 6}
        jds = JaxDataset(s["pattern"], 2, ANCHORS, len(CLASSES), input_hw=(SIZE, SIZE),
                         mode=JaxDatasetMode.TEST)
        want_map, want_aps = jax_evaluate_map(
            s["jax_model"], s["variables"], jds, ANCHORS, CLASSES, num_candidates=k, pool=pool,
            approx_topk=False, verbose=False)
        first = evaluate_map(s["pred"], ds, CLASSES, num_candidates=k, pool=pool,
                             verbose=False, max_batches=1)[0]
    assert set(got_aps) == set(want_aps) == {0, 1, 2}
    for c in want_aps:
        assert abs(got_aps[c] - want_aps[c]) <= 1e-6, (c, got_aps, want_aps)
    assert abs(got_map - want_map) <= 1e-6
    assert 0.1 < got_map < 1.0  # the ground truth matches, not all of it
    assert first != got_map  # the first batch alone


@pytest.mark.parametrize("exact", [False, True])
def test_cli_map_prints_the_same_map(eval_setup, exact, tmp_path, capsys):
    s = eval_setup
    weights = str(tmp_path / "weights.pt")
    torch.save(s["pred"].model.state_dict(), weights)
    (tmp_path / "classes.txt").write_text("\n".join(CLASSES) + "\n")
    (tmp_path / "anchors.txt").write_text(",".join(str(v) for v in ANCHORS.ravel()) + "\n")
    argv = ["--mode=MAP", f"--model={weights}", f"--test_dataset={s['pattern']}",
            f"--classes_path={tmp_path / 'classes.txt'}",
            f"--anchors_path={tmp_path / 'anchors.txt'}", f"--input_size={SIZE}",
            "--batch_size=2", "--no-bf16", "--device=cpu"] + ["--exact_nms"] * exact
    assert cli_main(argv) == 0
    out = capsys.readouterr().out
    printed = float(out.strip().splitlines()[-1].split("mAP:")[1])
    ds = Dataset(s["pattern"], 2, input_hw=(SIZE, SIZE), device="cpu")
    kw = dict(pool="per_class", num_candidates=GRID) if exact else {}
    want, _ = evaluate_map(s["pred"], ds, CLASSES, verbose=False, **kw)
    assert abs(printed - want) <= 5e-7 and "eval: 5 images" in out
    n_native = 6 if yoloret_tpu_torch.native.available() else 0  # 3 batches of 2
    assert f"decoded: native {n_native}, PIL {6 - n_native}" in out


def test_cli_refuses_what_is_not_ported(capsys, tmp_path):
    for argv in (["--mode=VIDEO"],
                 ["--mode=MAP", "--mesh_data=4"], ["--mode=MAP", f"--model={tmp_path}"],
                 ["--mode=TRAIN", "--mesh_data=2"], ["--mode=bogus"]):
        assert cli_main(argv) == 2
        assert "ROADMAP.md" in capsys.readouterr().err
