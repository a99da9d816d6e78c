"""The port's detector registry vs the JAX package's: every backbone with
every RFCR fusion builds, and the JAX model's variable tree (its shapes,
by ``jax.eval_shape`` of the init: no forward is compiled) loads into it
through ``from_flax`` with a strict key match and matching shapes. The
CLI's MAP mode takes the shipped COCO configurations and every fusion.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from yoloret_tpu.nn import build_detector as jax_build_detector
from yoloret_tpu.nn.detector import BACKBONES as JAX_BACKBONES
from yoloret_tpu_torch.cli.main import main as cli_main
from yoloret_tpu_torch.configs import load_config
from yoloret_tpu_torch.data import Dataset, load_anchors, load_classes
from yoloret_tpu_torch.eval import evaluate_map
from yoloret_tpu_torch.infer import Predictor
from yoloret_tpu_torch.nn.detector import BACKBONES, YoloReT, build_detector
from yoloret_tpu_torch.weights import from_flax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = [(name, rfcr) for name in sorted(JAX_BACKBONES)
         for rfcr in (("weighted_sum",) if JAX_BACKBONES[name][0] == "fullbody"
                      else ("weighted_sum", "concat", "none"))]


def test_registry_is_the_jax_registry():
    assert BACKBONES == JAX_BACKBONES


@pytest.mark.parametrize("name,rfcr", CASES)
def test_every_backbone_and_fusion_loads_jax_variables(name, rfcr):
    model = jax_build_detector(name, num_classes=4, rfcr=rfcr)
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, 64, 64, 3)), False),
                            jax.random.PRNGKey(0))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    port = YoloReT(name, num_classes=4, rfcr=rfcr)
    port.load_state_dict(from_flax(variables, port), strict=True)  # keys, then shapes


@pytest.mark.parametrize("name", sorted(n for n, (kind, _) in JAX_BACKBONES.items()
                                         if kind == "fullbody"))
@pytest.mark.parametrize("rfcr", ["concat", "none"])
def test_full_bodies_take_every_fusion(name, rfcr):
    """A full legacy body has no RFCR of its own: every fusion builds the
    same parameters (the JAX model's tree does not depend on it either)."""
    want = {k: tuple(v.shape) for k, v in YoloReT(name, num_classes=4).state_dict().items()}
    got = build_detector(name, num_classes=4, rfcr=rfcr, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.state_dict().items()} == want


def test_build_detector_refuses_unknown_names():
    with pytest.raises(ValueError, match="unknown backbone"):
        build_detector("resnet50", device="cpu")
    with pytest.raises(ValueError, match="unknown rfcr fusion"):
        build_detector("mobilenetv2x75", rfcr="sum", device="cpu")
    model = build_detector("yolo_fastest", rfcr="none", num_classes=2, device="cpu")
    heads = model(torch.rand(1, 64, 64, 3))
    assert [tuple(h.shape) for h in heads] == [(1, 2, 2, 3, 7), (1, 4, 4, 3, 7), (1, 8, 8, 3, 7)]


def _tiny_dataset(root, n=3, size=64):
    """``n`` seeded JPEGs in a text list, one ground-truth box each."""
    rs = np.random.RandomState(0)
    lines = []
    for i in range(n):
        h, w = (int(v) for v in rs.randint(48, 120, 2))
        path = os.path.join(root, f"im{i}.jpg")
        Image.fromarray(rs.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(path)
        lines.append(f"{path} 4,4,{w // 2},{h // 2},{i}")
    with open(os.path.join(root, "test.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return os.path.join(root, "test.txt")


@pytest.mark.parametrize("config,exact", [("configs/coco_mobilenetv2x14_224.yaml", False),
                                          ("configs/coco_efficientnetb3_416.yaml", True)])
def test_cli_runs_the_coco_configs(config, exact, tmp_path, capsys, monkeypatch):
    """``--config`` on the shipped COCO files (backbone, 80 class names and
    the 9 anchors read from the repository), the size cut to 64 by flag:
    the printed mAP is ``evaluate_map``'s on the same weights."""
    monkeypatch.chdir(ROOT)
    cfg = load_config(config)
    names, anchors = load_classes(cfg.classes_path), load_anchors(cfg.anchors_path)
    assert len(names) == 80 and anchors.shape == (9, 2)
    model = build_detector(cfg.backbone, num_classes=80, seed=1, device="cpu")
    weights = str(tmp_path / "w.pt")
    torch.save(model.state_dict(), weights)
    data = _tiny_dataset(str(tmp_path))
    argv = [f"--config={config}", "--mode=MAP", f"--model={weights}", f"--test_dataset={data}",
            "--input_size=64", "--batch_size=2", "--no-bf16", "--device=cpu"]
    assert cli_main(argv + ["--exact_nms"] * exact) == 0
    printed = float(capsys.readouterr().out.strip().splitlines()[-1].split("mAP:")[1])
    pred = Predictor(backbone=cfg.backbone, weights=weights, class_names=names, anchors=anchors,
                     input_hw=(64, 64), bf16=False, score_threshold=0.0, device="cpu")
    kw = dict(pool="per_class", num_candidates=252) if exact else {}
    want, _ = evaluate_map(pred, Dataset(data, 2, input_hw=(64, 64), device="cpu"), names,
                           verbose=False, **kw)
    assert abs(printed - want) <= 5e-7


@pytest.mark.parametrize("rfcr", ["concat", "none"])
def test_cli_takes_every_rfcr_fusion(rfcr, tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(ROOT)
    model = build_detector("mobilenetv2x75", num_classes=80, rfcr=rfcr, device="cpu")
    weights = str(tmp_path / "w.pt")
    torch.save(model.state_dict(), weights)
    argv = ["--config=configs/coco_mobilenetv2x14_224.yaml", "--backbone=mobilenetv2x75",
            f"--rfcr={rfcr}", "--mode=MAP", f"--model={weights}",
            f"--test_dataset={_tiny_dataset(str(tmp_path))}", "--input_size=64",
            "--batch_size=2", "--no-bf16", "--device=cpu"]
    assert cli_main(argv) == 0
    assert "mAP:" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="state_dict"):  # the fusion is the weights' own
        cli_main([a for a in argv if not a.startswith("--rfcr")])
