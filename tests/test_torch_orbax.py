"""The port reads the JAX package's Orbax weight directories
(``yoloret_tpu/utils/checkpoint.py::save_params``) with ``tensorstore``
alone (``yoloret_tpu_torch/utils/checkpoint.py::load_params``), on the
CPU.

Held: a directory of an init tree, and of a tree with ``ema_params``,
reads back equal bit for bit to ``weights.from_flax`` of the tree the
JAX ``load_params`` restores (with ``use_ema``: its EMA parameters where
the tree has them, as the JAX ``Predictor`` chooses); ``--mode=MAP
--model=<dir>`` prints the mAP of the same weights as a ``.pt`` file;
and the JAX trainer and the port's, both started from one directory
through ``train_unfreeze`` (stage 2, 64 px, b2, 2 images, 1 epoch,
float32, augmentation set to the identity so that both see the same
pixels), log the same epoch-0 loss: the first step's, taken before any
update (rtol 1e-5)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parity import _map, peaked_variables
from test_torch_data import _write_dataset, pinned_decoder
import yoloret_tpu.train.trainer as jax_trainer_module
from yoloret_tpu.configs import RunConfig as JaxRunConfig
from yoloret_tpu.nn import build_detector
from yoloret_tpu.utils.checkpoint import load_params as jax_load_params
from yoloret_tpu.utils.checkpoint import save_params as jax_save_params
from yoloret_tpu_torch.cli.main import main as cli_main
from yoloret_tpu_torch.configs import RunConfig
from yoloret_tpu_torch.train.trainer import train
from yoloret_tpu_torch.utils.checkpoint import load_params, save_params
from yoloret_tpu_torch.weights import from_flax

ANCHORS_LINE = "10,13, 16,30, 33,23, 30,61, 62,45, 59,119, 116,90, 156,198, 373,326\n"


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{kind: (directory, tree)}: the JAX package's ``save_params`` of a
    3-class x0.75 tree (the port's seeded init, head kernels x4), and of
    the same with ``ema_params`` (half the parameters, plus 0.01)."""
    root = tmp_path_factory.mktemp("orbax")
    v = peaked_variables(build_detector("mobilenetv2x75", num_classes=3), 3)
    ema = _map(v["params"], lambda path, a: (a * 0.5 + 0.01).astype(np.float32))
    out = {}
    for kind, tree in (("init", v), ("ema", {**v, "ema_params": ema})):
        jax_save_params(str(root / kind), tree)
        out[kind] = (str(root / kind), tree)
    return out


@pytest.mark.parametrize("use_ema", [False, True])
@pytest.mark.parametrize("kind", ["init", "ema"])
def test_load_params_reads_a_jax_directory(trees, kind, use_ema):
    path, tree = trees[kind]
    got = load_params(path, use_ema)
    restored = jax.device_get(jax_load_params(path))
    pick = "ema_params" if use_ema and "ema_params" in restored else "params"
    for source in (restored, tree):
        want = from_flax({"params": source[pick], "batch_stats": source["batch_stats"]})
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k
    if kind == "ema":
        assert not torch.equal(got["body.stem.conv.weight"],
                               load_params(path, not use_ema)["body.stem.conv.weight"])


def test_a_directory_without_metadata_is_refused(tmp_path):
    with pytest.raises(ValueError, match="without _METADATA"):
        load_params(str(tmp_path))


def tree_without_ema(tree):
    return {"params": tree["params"], "batch_stats": tree["batch_stats"]}


@pytest.mark.parametrize("use_ema", [False, True])
def test_cli_map_reads_the_directory_as_the_pt_file(trees, tmp_path, capsys, use_ema):
    path, tree = trees["ema"]
    (tmp_path / "data").mkdir()
    pattern = _write_dataset(str(tmp_path / "data"), n_list=4, n_shard=2)
    (tmp_path / "classes.txt").write_text("a\nb\nc\n")
    (tmp_path / "anchors.txt").write_text(ANCHORS_LINE)
    pt = str(tmp_path / "weights.pt")
    save_params(pt, from_flax(tree_without_ema(tree)),
                ema=from_flax({"params": tree["ema_params"]}))
    printed = []
    for model in (path, pt):
        argv = ["--mode=MAP", f"--model={model}", f"--test_dataset={pattern}",
                f"--classes_path={tmp_path / 'classes.txt'}",
                f"--anchors_path={tmp_path / 'anchors.txt'}", "--input_size=64",
                "--batch_size=2", "--no-bf16", "--device=cpu"] + ["--use_ema"] * use_ema
        assert cli_main(argv) == 0
        out = capsys.readouterr().out
        printed.append([line for line in out.splitlines() if "ap:" in line or "mAP:" in line])
    assert printed[0] == printed[1] and len(printed[0]) == 4, printed


class _ShapeInit:
    """A JAX detector whose ``init`` returns zeros of the init's shapes
    (``jax.eval_shape``, no eager init of ~30 s): the JAX trainer replaces
    every one of them with the directory's (``train_unfreeze``)."""

    def __init__(self, model):
        self.model = model

    def init(self, key, x, train):
        shapes = jax.eval_shape(lambda k: self.model.init(k, x, train), key)
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    def apply(self, *a, **kw):
        return self.model.apply(*a, **kw)


def test_jax_and_port_trainers_start_alike_from_one_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_trainer_module, "build_detector",
                        lambda *a, **kw: _ShapeInit(build_detector(*a, **kw)))
    rs = np.random.RandomState(0)
    lines = []
    for i in range(2):  # square images: with scale 1 and no jitter the placement is fixed
        img = rs.randint(0, 60, (64, 64, 3)).astype(np.uint8)
        img[10:40, 12:50, i] = 230
        Image.fromarray(img).save(tmp_path / f"im{i}.jpg", quality=95)
        lines.append(f"{tmp_path / f'im{i}.jpg'} 12,10,50,40,{i}")
    (tmp_path / "list.txt").write_text("\n".join(lines) + "\n")
    (tmp_path / "classes.txt").write_text("a\nb\n")
    (tmp_path / "anchors.txt").write_text(ANCHORS_LINE)
    v = peaked_variables(build_detector("mobilenetv2x75", num_classes=2), 2)
    jax_save_params(str(tmp_path / "w"), v)
    identity = dict(jitter=0.0, min_scale=1.0, max_scale=1.0, flip=False, hue=0.0, sat=0.0,
                    val=0.0, min_gamma=1.0, max_gamma=1.0, contrast=0.0)
    common = dict(backbone="mobilenetv2x75", input_size=(64, 64),
                  train_dataset=str(tmp_path / "list.txt"),
                  classes_path=str(tmp_path / "classes.txt"),
                  anchors_path=str(tmp_path / "anchors.txt"), batch_size=2, epochs=(1, 1),
                  freeze=False, train_unfreeze=str(tmp_path / "w"), bf16=False, mesh_data=1,
                  checkpoint_every=10**9, seed=0, augment=identity)
    with pinned_decoder("pil", tmp_path):
        jax_trainer_module.train(JaxRunConfig(log_dir=str(tmp_path / "jax"), **common))
        train(RunConfig(log_dir=str(tmp_path / "port"), **common), device="cpu")
    losses = {}
    for side in ("jax", "port"):
        with open(tmp_path / side / "mobilenetv2x75_stage2" / "metrics.jsonl") as f:
            losses[side] = [json.loads(line)["loss"] for line in f]
    assert len(losses["jax"]) == len(losses["port"]) == 1
    assert losses["jax"][0] > 10  # the loss of an untrained detector
    np.testing.assert_allclose(losses["port"][0], losses["jax"][0], rtol=1e-5)
