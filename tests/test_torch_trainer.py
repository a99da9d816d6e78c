"""The port's CLI TRAIN mode end to end on the CPU, at 64x64 and batch
2 (MobileNetV2 x0.75, float32): stage 1 with a validation loss and the
stage-end mAP, stage 2 from stage 1's weight file, ``--mode=MAP
--model=`` on the final file giving the trainer's stage-end mAP; a run
interrupted after a checkpoint and ``--resume``d ending with the weights
of the uninterrupted run (the data stream continues at the batch where
it stopped); and each option that is not ported yet stopping with its
ROADMAP.md item. The training options of item 4c are held in
tests/test_torch_train_options.py."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import yoloret_tpu_torch.train.trainer as trainer
from yoloret_tpu_torch.cli.main import main as cli_main
from yoloret_tpu_torch.utils.checkpoint import load_params

CLASSES = ["a", "b", "c"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Six JPEGs with coloured boxes on noise, as one text list, plus the
    classes, anchors and a config with a checkpoint every epoch."""
    root = tmp_path_factory.mktemp("train")
    rs = np.random.RandomState(0)
    lines = []
    for i in range(6):
        h, w = (int(v) for v in rs.randint(56, 96, 2))
        img = rs.randint(0, 60, (h, w, 3)).astype(np.uint8)
        boxes = []
        for _ in range(int(rs.randint(1, 3))):
            x1, y1 = int(rs.randint(0, w // 2)), int(rs.randint(0, h // 2))
            x2, y2 = x1 + int(rs.randint(12, w // 2)), y1 + int(rs.randint(12, h // 2))
            c = int(rs.randint(0, len(CLASSES)))
            img[y1:y2, x1:x2, c] = 230
            boxes.append(f"{x1},{y1},{x2},{y2},{c}")
        path = root / f"im{i}.jpg"
        Image.fromarray(img).save(path, quality=95)
        lines.append(f"{path} " + " ".join(boxes))
    (root / "list.txt").write_text("\n".join(lines) + "\n")
    (root / "classes.txt").write_text("\n".join(CLASSES) + "\n")
    (root / "anchors.txt").write_text(
        "10,13, 16,30, 33,23, 30,61, 62,45, 59,119, 116,90, 156,198, 373,326\n")
    (root / "ckpt.yaml").write_text("checkpoint_every: 1\n")
    return root


def common(root, log_dir):
    return [f"--train_dataset={root / 'list.txt'}", f"--classes_path={root / 'classes.txt'}",
            f"--anchors_path={root / 'anchors.txt'}", "--input_size=64", "--batch_size=2",
            "--no-bf16", "--device=cpu", f"--log_dir={log_dir}"]


def records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_two_stages_then_map(data, tmp_path, capsys):
    torch.manual_seed(0)
    argv = common(data, tmp_path) + [f"--val_dataset={data / 'list.txt'}",
                                     f"--test_dataset={data / 'list.txt'}", "--epochs", "2", "1"]
    assert cli_main(["--mode=TRAIN"] + argv) == 0
    stage1 = tmp_path / "mobilenetv2x75_stage1"
    w1 = stage1 / "mobilenetv2x75_trained_weights_stage_1.pt"
    assert w1.exists()
    recs = records(stage1 / "metrics.jsonl")
    losses = [r for r in recs if "loss" in r]
    assert [r["epoch"] for r in losses] == [0, 1]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["val_loss"]) for r in losses)
    assert "mAP" in recs[-1]
    # stage 1 left the backbone as it was: the seeded init
    from yoloret_tpu_torch.nn.detector import YoloReT
    from yoloret_tpu_torch.nn.layers import init_weights

    init = YoloReT("mobilenetv2x75", num_classes=len(CLASSES))
    init_weights(init, torch.Generator().manual_seed(0))
    got1 = load_params(str(w1))
    for k, v in init.state_dict().items():
        if k.startswith("body."):
            assert torch.equal(got1[k], v), k
    assert not torch.equal(got1["neck.pan_head_8.pred.weight"],
                           init.state_dict()["neck.pan_head_8.pred.weight"])
    capsys.readouterr()

    assert cli_main(["--mode=TRAIN", f"--train_unfreeze={w1}"] + argv) == 0
    out = capsys.readouterr().out
    final = tmp_path / "mobilenetv2x75_stage2" / "mobilenetv2x75_trained_weights_final.pt"
    stage_end = float(out.split("stage-end mAP:")[1].split()[0])
    got2 = load_params(str(final))
    assert any(not torch.equal(got2[k], got1[k]) for k in got1 if k.startswith("body."))

    assert cli_main(["--mode=MAP", f"--model={final}", f"--test_dataset={data / 'list.txt'}",
                     f"--classes_path={data / 'classes.txt'}",
                     f"--anchors_path={data / 'anchors.txt'}", "--input_size=64",
                     "--batch_size=2", "--no-bf16", "--device=cpu"]) == 0
    printed = float(capsys.readouterr().out.strip().splitlines()[-1].split("mAP:")[1])
    assert abs(printed - stage_end) <= 1e-6


class Preempted(Exception):
    pass


def test_resume_continues_at_the_same_batch(data, tmp_path, monkeypatch):
    argv = common(data, tmp_path) + [f"--config={data / 'ckpt.yaml'}", "--epochs", "3", "1",
                                     "--use_ema"]
    whole = tmp_path / "whole"
    assert cli_main(["--mode=TRAIN"] + argv + [f"--log_dir={whole}"]) == 0

    real_step = trainer.train_step
    seen = []

    def preempted_step(state, batch, cfg, seed=0):
        seen.append(batch["images"])
        if state.step == 7:  # the second batch of epoch 2, after epoch 1's checkpoint
            raise Preempted
        return real_step(state, batch, cfg, seed)

    cut = tmp_path / "cut"
    monkeypatch.setattr(trainer, "train_step", preempted_step)
    with pytest.raises(Preempted):
        cli_main(["--mode=TRAIN"] + argv + [f"--log_dir={cut}"])
    first_of_epoch2 = seen[6]
    seen.clear()
    monkeypatch.setattr(trainer, "train_step", real_step)

    resumed_batches = []

    def recording_step(state, batch, cfg, seed=0):
        resumed_batches.append(batch["images"])
        return real_step(state, batch, cfg, seed)

    monkeypatch.setattr(trainer, "train_step", recording_step)
    assert cli_main(["--mode=TRAIN", "--resume"] + argv + [f"--log_dir={cut}"]) == 0
    assert torch.equal(resumed_batches[0], first_of_epoch2)
    assert len(resumed_batches) == 3  # epoch 2 only
    name = "mobilenetv2x75_stage1/mobilenetv2x75_trained_weights_stage_1.pt"
    want, got = (torch.load(d / name, weights_only=True) for d in (whole, cut))
    assert set(got) == set(want) and any(k.startswith("ema_params.") for k in got)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("flags,item", [
    (["--mesh_data=2"], "item 6"),
    (["--model={root}"], "item 5"),
    (["--train_unfreeze={root}"], "item 5"),
])
def test_unported_training_options_are_refused(data, tmp_path, capsys, flags, item):
    flags = [f.format(root=data) for f in flags]
    assert cli_main(["--mode=TRAIN"] + common(data, tmp_path) + flags) == 2
    err = capsys.readouterr().err
    assert "ROADMAP.md" in err and item in err
    assert not (tmp_path / "mobilenetv2x75_stage1").exists()


def test_train_backbone_answers_as_the_jax_package(capsys):
    assert cli_main(["--mode=TRAIN_BACKBONE"]) == 2
    assert "TRAIN_BACKBONE: pretraining the backbone alone" in capsys.readouterr().out


NEW_MODULES = ("yoloret_tpu_torch.train", "yoloret_tpu_torch.train.freeze",
               "yoloret_tpu_torch.train.losses", "yoloret_tpu_torch.train.step",
               "yoloret_tpu_torch.train.trainer", "yoloret_tpu_torch.ops.targets",
               "yoloret_tpu_torch.utils.checkpoint", "yoloret_tpu_torch.utils.tensorboard",
               "yoloret_tpu_torch.tools.autoaugment", "yoloret_tpu_torch.tools.kmeans",
               "yoloret_tpu_torch.data.pipeline", "yoloret_tpu_torch.infer.predictor",
               "yoloret_tpu_torch.cli.main")


def test_training_modules_import_no_jax():
    """The training modules, and chip_smoke.py, import nothing of JAX or of
    the JAX package: they import with jax, flax and yoloret_tpu blocked,
    and no import line of theirs names them."""
    import re
    import subprocess
    import sys

    code = ("import sys, importlib\n"
            "for m in ('jax', 'flax', 'yoloret_tpu'): sys.modules[m] = None\n"
            f"for n in {NEW_MODULES!r}: importlib.import_module(n)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    import importlib

    paths = [importlib.import_module(n).__file__ for n in NEW_MODULES]
    paths.append(os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py"))
    bad = re.compile(r"^\s*(import|from)\s+(jax|flax|yoloret_tpu)(\s|\.|$)", re.M)
    for p in paths:
        with open(p) as f:
            assert not bad.search(f.read()), p


def test_train_runs_on_the_card_unless_asked(data, tmp_path, monkeypatch):
    from yoloret_tpu_torch.cli.main import args_to_config, build_parser

    cfg = args_to_config(build_parser().parse_args(
        ["--mode=TRAIN"] + common(data, tmp_path)[:-2] + [f"--log_dir={tmp_path}"]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.train(cfg)
