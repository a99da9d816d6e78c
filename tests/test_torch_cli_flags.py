"""The port's CLI takes the JAX CLI's ``--num_scales``, ``--opt``,
``--prune``, ``--video`` and ``--track_interval`` (``yoloret_tpu/cli/
main.py:45,114,130``) into the same ``RunConfig`` fields; ``--opt=DEBUG``
(the flag or a config's ``opt: DEBUG``) sets the seed to 0 as the JAX
``main`` does, and turns on autograd's anomaly check in TRAIN; VIDEO
takes ``--video`` and ``--track_interval`` into ``detect_video``."""

import dataclasses

import jax
import pytest
import torch

import yoloret_tpu.train.trainer as jax_trainer
import yoloret_tpu_torch.train.trainer as trainer
from yoloret_tpu.cli.main import args_to_config as jax_args_to_config
from yoloret_tpu.cli.main import build_parser as jax_build_parser
from yoloret_tpu.cli.main import main as jax_main
from yoloret_tpu_torch.cli.main import args_to_config, build_parser
from yoloret_tpu_torch.cli.main import main as cli_main
from yoloret_tpu_torch.infer.predictor import Predictor

ARGV = ["--mode=VIDEO", "--num_scales", "2", "--opt", "MKL", "--prune", "--video", "clip.mp4",
        "--track_interval", "5", "--seed", "7", "--input_size", "96", "--no-bf16"]


@pytest.mark.parametrize("argv", [ARGV, ["--mode=MAP", "--opt", "XLA", "--prune",
                                         "--num_scales", "3"]])
def test_flags_parse_to_the_jax_config(argv):
    got = args_to_config(build_parser().parse_args(argv))
    want = jax_args_to_config(jax_build_parser().parse_args(argv))
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    if argv is ARGV:
        assert (got.num_scales, got.opt, got.prune, got.video, got.track_interval) == (
            2, "MKL", True, "clip.mp4", 5)


def capture_train(monkeypatch, module):
    """Replace ``module.train`` by a recorder of its config and of whether
    autograd's anomaly check was on when it ran."""
    seen = {}

    def fake_train(cfg, *a, **kw):
        seen["cfg"] = cfg
        seen["anomaly"] = torch.is_anomaly_enabled()
        return "weights"

    monkeypatch.setattr(module, "train", fake_train)
    return seen


@pytest.mark.parametrize("how", ["flag", "config"])
def test_debug_sets_seed_0_as_jax_does(monkeypatch, tmp_path, how):
    extra = ["--opt=DEBUG"]
    if how == "config":
        (tmp_path / "debug.yaml").write_text("opt: DEBUG\n")
        extra = [f"--config={tmp_path / 'debug.yaml'}"]
    argv = ["--mode=TRAIN", "--seed=7"] + extra
    seen = capture_train(monkeypatch, trainer)
    assert cli_main(argv + ["--device=cpu"]) == 0
    jax_seen = capture_train(monkeypatch, jax_trainer)
    try:
        jax_main(argv)
    finally:
        jax.config.update("jax_debug_nans", False)  # the JAX main turns it on
    assert seen["cfg"].seed == jax_seen["cfg"].seed == 0
    assert seen["anomaly"] and not torch.is_anomaly_enabled()
    # without DEBUG the seed stays and the anomaly check stays off
    assert cli_main(["--mode=TRAIN", "--seed=7", "--opt=XLA", "--device=cpu"]) == 0
    assert seen["cfg"].seed == 7 and not seen["anomaly"]


def test_video_reaches_the_refusal_naming_item_7(monkeypatch, tmp_path, capsys):
    """Named for where VIDEO stopped before it was ported. Now
    ``--track_interval=3`` reaches ``Predictor.detect_video`` with the clip
    and ``--output``, and a clip that does not open raises ``IOError``, as
    the JAX CLI lets it."""
    (tmp_path / "classes.txt").write_text("a\n")
    (tmp_path / "anchors.txt").write_text(", ".join(["10,13"] * 9) + "\n")
    argv = ["--mode=VIDEO", "--device=cpu", "--input_size=64", "--no-bf16",
            f"--classes_path={tmp_path / 'classes.txt'}",
            f"--anchors_path={tmp_path / 'anchors.txt'}"]
    with pytest.raises(IOError, match="cannot open video source"):
        cli_main(argv + [f"--video={tmp_path / 'missing.mp4'}"])
    seen = []
    monkeypatch.setattr(Predictor, "detect_video",
                        lambda self, *a, **kw: seen.append((a, kw)) or 7)
    assert cli_main(argv + ["--video=clip.mp4", "--track_interval=3", "--output=o.mp4"]) == 0
    assert seen == [(("clip.mp4", "o.mp4"), {"track_interval": 3})]
    assert capsys.readouterr().out.strip().splitlines()[-1] == "processed 7 frames"
