"""The port's CLI modes IMAGE, ANCHORS and PRUNE against the JAX
package's, on the CPU, and the CLI taking the training options of
ROADMAP item 4c.

IMAGE at 64x64, float32, on the port's copy of the demo photo, with
weights carried from a Flax tree by ``from_flax`` into a port weight
file: ``Predictor.detect_image`` gives the JAX ``Predictor.detect_image``'s
detections (classes equal, scores within 1e-4 relative, boxes within
1e-2 px: tests/test_torch_slice.py's tolerances), and the CLI prints
them one a line, then ``wrote <path>``, and writes the drawn image.
ANCHORS writes the JAX package's anchors file bit for bit from a seeded
annotation list; PRUNE answers with the JAX package's message and exit
code 2."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import yoloret_tpu_torch
from _torch_parity import SIZE, peaked_variables
from yoloret_tpu.cli.main import main as jax_cli_main
from yoloret_tpu.infer import Predictor as JaxPredictor
from yoloret_tpu.nn import build_detector as jax_build_detector
from yoloret_tpu.nn import detector as jax_detector
from yoloret_tpu.tools.kmeans import kmeans_anchors_cli as jax_kmeans_anchors_cli
from yoloret_tpu_torch.cli.main import args_to_config, build_parser, demo_image
from yoloret_tpu_torch.cli.main import main as cli_main
from yoloret_tpu_torch.infer import Predictor

CLASSES = ["a", "b", "c"]
ANCHORS_LINE = "10,13, 16,30, 33,23, 30,61, 62,45, 59,119, 116,90, 156,198, 373,326\n"
JAX_ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "yoloret_tpu", "assets")


def test_assets_are_the_jax_packages():
    port = os.path.join(os.path.dirname(yoloret_tpu_torch.__file__), "assets")
    assert demo_image() == os.path.join(port, "demo.jpg")
    for name in ("demo.jpg", "voc_classes.txt", "coco_classes.txt", "yolo_anchors.txt"):
        with open(os.path.join(port, name), "rb") as a, open(os.path.join(JAX_ASSETS, name),
                                                              "rb") as b:
            assert a.read() == b.read(), name


def test_image_matches_the_jax_predictor(tmp_path, monkeypatch, capsys):
    model = jax_build_detector("mobilenetv2x75", num_classes=len(CLASSES))
    variables = peaked_variables(model, len(CLASSES))
    kw = dict(class_names=CLASSES, input_hw=(SIZE, SIZE), score_threshold=0.3, bf16=False)
    anchors = np.asarray([float(v) for v in ANCHORS_LINE.split(",")], np.float32).reshape(-1, 2)
    # the JAX Predictor's own init is replaced by these variables
    monkeypatch.setattr(jax_detector.YoloReT, "init", lambda self, *a, **k: variables)
    _, want = JaxPredictor(anchors=anchors, **kw).detect_image(
        os.path.join(JAX_ASSETS, "demo.jpg"), draw=False)
    port = Predictor(anchors=anchors, weights=variables, device="cpu", **kw)
    drawn, got = port.detect_image(demo_image())
    assert drawn.size == Image.open(demo_image()).size
    assert 0 < len(want) == len(got)
    for g, w in zip(got, want):
        assert (g.class_id, g.class_name) == (w.class_id, w.class_name)
        np.testing.assert_allclose(g.score, w.score, rtol=1e-4)
        np.testing.assert_allclose(g.box, w.box, atol=1e-2)
    capsys.readouterr()

    weights = tmp_path / "w.pt"
    torch.save(port.model.state_dict(), weights)
    (tmp_path / "classes.txt").write_text("\n".join(CLASSES) + "\n")
    (tmp_path / "anchors.txt").write_text(ANCHORS_LINE)
    out_png = tmp_path / "out.png"
    assert cli_main([f"--model={weights}", f"--classes_path={tmp_path / 'classes.txt'}",
                     f"--anchors_path={tmp_path / 'anchors.txt'}", f"--input_size={SIZE}",
                     "--score=0.3", "--no-bf16", "--device=cpu", f"--output={out_png}"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"found {len(got)} boxes in ")
    assert lines[1:-1] == [f"{d.class_name} {d.score:.3f} {tuple(round(v, 1) for v in d.box)}"
                           for d in got]
    assert lines[-1] == f"wrote {out_png}"
    np.testing.assert_array_equal(np.asarray(Image.open(out_png)), np.asarray(drawn))


def test_image_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["--mode=IMAGE", f"--classes_path={os.path.join(JAX_ASSETS, 'voc_classes.txt')}",
                  f"--anchors_path={os.path.join(JAX_ASSETS, 'yolo_anchors.txt')}"])


def test_anchors_file_is_the_jax_packages(tmp_path, capsys):
    rs = np.random.RandomState(4)
    lines = []
    for i in range(40):
        boxes = []
        for _ in range(int(rs.randint(1, 5))):
            x1, y1 = rs.randint(0, 300, 2)
            w, h = rs.randint(4, 200, 2)
            boxes.append(f"{x1},{y1},{x1 + w},{y1 + h},{rs.randint(0, 20)}")
        lines.append(f"/data/im{i}.jpg " + " ".join(boxes))
    (tmp_path / "train_40.txt").write_text("\n".join(lines) + "\n")
    got, want = tmp_path / "port.txt", tmp_path / "jax.txt"
    assert cli_main(["--mode=ANCHORS", f"--train_dataset={tmp_path / 'train_*.txt'}",
                     f"--output={got}"]) == 0
    out = capsys.readouterr().out
    jax_kmeans_anchors_cli(str(tmp_path / "train_*.txt"), str(want))
    assert out == capsys.readouterr().out.replace(str(want), str(got))
    assert got.read_bytes() == want.read_bytes()
    assert len(got.read_text().split(", ")) == 9


def test_prune_answers_as_the_jax_package(capsys):
    assert cli_main(["--mode=PRUNE"]) == 2
    got = capsys.readouterr().out
    assert jax_cli_main(["--mode=PRUNE"]) == 2
    assert got == capsys.readouterr().out and got.startswith("PRUNE:")


@pytest.mark.parametrize("flags,field,value", [
    (["--autoaugment_policy=v1"], "autoaugment_policy", "v1"),
    (["--mosaic=0.5"], "augment", {"mosaic_prob": 0.5}),
    (["--mixup=0.25"], "augment", {"mixup_prob": 0.25}),
    (["--multi_scale", "288", "352"], "multi_scale", [288, 352]),
    (["--tb_images=4"], "tb_images", 4),
])
def test_training_options_are_taken(flags, field, value):
    cfg = args_to_config(build_parser().parse_args(["--mode=TRAIN"] + flags))
    assert getattr(cfg, field) == value


def test_other_modes_still_refused(capsys):
    """VIDEO and the TensorFlow flavours are ported (tests/test_torch_video.py,
    tests/test_torch_tf_export.py); ``--mesh_data`` above the devices there
    are stops in any mode with the JAX ``make_mesh`` message (no CUDA
    device here), an unknown mode refuses, and VIDEO without ``--video``
    answers as the JAX CLI does."""
    for mode in ("IMAGE", "VIDEO", "TFLITE", "SERVING", "TFJS"):
        assert cli_main([f"--mode={mode}", "--mesh_data=2"]) == 2
        assert "mesh 2x1 needs 2 devices, have 0" in capsys.readouterr().err
    assert cli_main(["--mode=bogus"]) == 2
    assert "unknown mode" in capsys.readouterr().err
    assert cli_main(["--mode=VIDEO"]) == 2
    assert "--video required" in capsys.readouterr().err
