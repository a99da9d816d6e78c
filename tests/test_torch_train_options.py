"""The training options of the port (online AutoAugment, mosaic and
mixup, multi-scale, TensorBoard images) against the JAX package, on the
CPU at 64x64.

Held: a TRAIN stream with ``aa_policy`` gives the JAX package's host
batches bit for bit, with and without ``skip`` (both packages pinned to
PIL); with mosaic and mixup on and the JAX package's draws injected (its
batch key for the augmentation, its key folded with 0x6D6978 for the
mixing), the port's device batch is JAX's ``_finalize_train`` within the
tolerances of tests/test_torch_train_data.py (1e-4); the multi-scale
schedule of the JAX trainer (epoch e at size e % len(sizes), its line
``epoch {e}: input size {hw}``, and a resumed run skipping in each
size's stream the batches its completed epochs drew); a CLI run with all
four options writing ``tb_images`` image summaries per epoch whose PNGs
are the epoch's input size; ``add_image`` writing the JAX writer's event
bytes; and ``draw_detections`` drawing the JAX package's pixels. No JAX
train step is compiled: the schedule's runs replace the step."""

import io
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import yoloret_tpu_torch.data.pipeline as pipeline
import yoloret_tpu_torch.train.trainer as trainer
from _torch_parity import ANCHORS
from test_torch_data import _write_dataset, pinned_decoder
from test_torch_train_data import jax_draws as jax_augment_draws
from test_torch_trainer import Preempted, common, data, records  # noqa: F401 (fixture)
from yoloret_tpu.data.augment import AugmentConfig as JaxAugmentConfig
from yoloret_tpu.data.pipeline import Dataset as JaxDataset
from yoloret_tpu.data.pipeline import DatasetMode as JaxDatasetMode
from yoloret_tpu.infer.predictor import Detection as JaxDetection
from yoloret_tpu.infer.predictor import draw_detections as jax_draw_detections
from yoloret_tpu.utils.tensorboard import SummaryWriter as JaxSummaryWriter
from yoloret_tpu_torch.cli.main import main as cli_main
from yoloret_tpu_torch.data.augment import AugmentConfig
from yoloret_tpu_torch.data.pipeline import Dataset, DatasetMode
from yoloret_tpu_torch.data.tfrecord import index_tfrecord, read_record_at
from yoloret_tpu_torch.infer.predictor import Detection, draw_detections
from yoloret_tpu_torch.utils.tensorboard import SummaryWriter

C = 3


@pytest.mark.parametrize("policy", ["v0", "v3"])
def test_host_stream_with_autoaugment_bitwise(tmp_path, policy):
    pattern = _write_dataset(str(tmp_path), n_list=5, n_shard=2)
    with pinned_decoder("pil", tmp_path):
        kw = dict(input_hw=(64, 64), seed=3, num_workers=2)
        jds = JaxDataset(pattern, 2, ANCHORS, C, mode=JaxDatasetMode.TRAIN, aa_policy=policy,
                         **kw)
        ds = Dataset(pattern, 2, mode=DatasetMode.TRAIN, device="cpu", anchors=ANCHORS,
                     num_classes=C, aa_policy=policy, **kw)
        plain = Dataset(pattern, 2, mode=DatasetMode.TRAIN, device="cpu", anchors=ANCHORS,
                        num_classes=C, **kw)
        for skip in (0, 4):
            want = list(jds._host_batches(epochs=3, skip=skip))
            got = list(ds._host_batches(epochs=3, skip=skip))
            assert len(got) == len(want) == 9 - skip
            for g, w in zip(got, want):
                for k in ("images", "boxes", "valid", "image_hw", "n_valid"):
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        # the seeds are drawn after the qualities: the first batch's order and
        # qualities are the plain stream's; AutoAugment changed pixels
        (idx, _, qs, seeds), (pidx, _, pqs, pseeds) = (next(d.host_plan(epochs=1))
                                                       for d in (ds, plain))
        assert (idx.tolist(), qs) == (pidx.tolist(), pqs)
        assert None not in seeds and pseeds == [None, None]
        assert any(not np.array_equal(g["images"], p["images"]) for g, p in zip(
            ds._host_batches(epochs=1), plain._host_batches(epochs=1)))


def test_mixed_train_batch_matches_jax(tmp_path, monkeypatch):
    pattern = _write_dataset(str(tmp_path), n_list=5, n_shard=2)
    aug = dict(mosaic_prob=0.5, mixup_prob=0.9)
    key = jax.random.PRNGKey(11)
    jcfg = JaxAugmentConfig(input_hw=(64, 64), **aug)
    mix_key = jax.random.fold_in(key, 0x6D6978)
    k1, k2, k3 = jax.random.split(mix_key, 3)
    do_mosaic = np.array(jax.random.uniform(k1, (4,)) < jcfg.mosaic_prob)
    mix = {"do_mosaic": torch.from_numpy(do_mosaic),
           "do_mixup": torch.from_numpy(
               ~do_mosaic & np.array(jax.random.uniform(k2, (4,)) < jcfg.mixup_prob)),
           "lam": torch.from_numpy(np.array(jax.random.uniform(k3, (4, 1, 1, 1))))}
    assert mix["do_mosaic"].any() and mix["do_mixup"].any() and not mix["do_mosaic"].all()
    monkeypatch.setattr(pipeline, "draw_augment", lambda b, cfg, g, dev: jax_augment_draws(
        key, b, jcfg))
    monkeypatch.setattr(pipeline, "draw_mix", lambda b, cfg, g, dev: mix)
    with pinned_decoder("pil", tmp_path):
        jds = JaxDataset(pattern, 4, ANCHORS, C, input_hw=(64, 64), mode=JaxDatasetMode.TRAIN,
                         augment_config=jcfg, num_workers=2)
        ds = Dataset(pattern, 4, input_hw=(64, 64), mode=DatasetMode.TRAIN, device="cpu",
                     anchors=ANCHORS, num_classes=C, augment_config=AugmentConfig(**aug),
                     num_workers=2)
        host = next(ds._host_batches(epochs=1))
    want = jds._finalize_train(host, key)
    got = ds._finalize_train(host, 0)
    assert set(got) == set(want) and got["gt_boxes"].shape == (4, 80, 4)
    for k, w in want.items():
        w, g = np.asarray(w), got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if g.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=k)


def stub_step(record, stop_at=None):
    """A train step that records each batch's images and trains nothing
    (the schedule does not depend on the weights)."""
    def step(state, batch, cfg, seed=0):
        record.append(batch["images"].clone())
        if stop_at is not None and len(record) == stop_at:
            raise Preempted
        return {"loss": torch.tensor(1.0)}
    return step


def test_multi_scale_schedule_and_resume(data, tmp_path, monkeypatch, capsys):  # noqa: F811
    argv = ["--mode=TRAIN"] + common(data, tmp_path)[:-1] + [
        f"--config={data / 'ckpt.yaml'}", "--epochs", "4", "1", "--multi_scale", "64", "96"]
    whole = []
    monkeypatch.setattr(trainer, "train_step", stub_step(whole))
    assert cli_main(argv + [f"--log_dir={tmp_path / 'whole'}"]) == 0
    out = capsys.readouterr().out
    sizes = [64, 96, 64, 96]  # epoch e at size e % 2, 3 steps an epoch (the first size's)
    for e, s in enumerate(sizes):
        assert f"epoch {e}: input size ({s}, {s})\n" in out
    assert [tuple(b.shape[1:3]) for b in whole] == [(s, s) for s in sizes for _ in range(3)]

    cut = []
    monkeypatch.setattr(trainer, "train_step", stub_step(cut, stop_at=8))  # in epoch 2
    with pytest.raises(Preempted):
        cli_main(argv + [f"--log_dir={tmp_path / 'cut'}"])
    resumed = []
    monkeypatch.setattr(trainer, "train_step", stub_step(resumed))
    assert cli_main(argv + ["--resume", f"--log_dir={tmp_path / 'cut'}"]) == 0
    assert "resumed from epoch 1 checkpoint" in capsys.readouterr().out
    assert len(resumed) == 6  # epochs 2 and 3
    for g, w in zip(resumed, whole[6:]):
        assert torch.equal(g, w)


def events(path):
    return [read_record_at(path, off, ln) for off, ln in index_tfrecord(path)]


def test_all_four_options_write_tb_images(data, tmp_path):  # noqa: F811
    argv = ["--mode=TRAIN"] + common(data, tmp_path)[:-1] + [
        "--batch_size=4", "--epochs", "2", "1", "--autoaugment_policy=v0", "--mosaic=0.5",
        "--mixup=0.5", "--multi_scale", "64", "96", "--tb_images=2",
        f"--log_dir={tmp_path / 'logs'}"]
    assert cli_main(argv) == 0
    stage = tmp_path / "logs" / "mobilenetv2x75_stage1"
    losses = [r["loss"] for r in records(stage / "metrics.jsonl") if "loss" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()
    (tb,) = os.listdir(stage / "tb")
    images = [r for r in events(str(stage / "tb" / tb)) if b"\x89PNG" in r]
    assert len(images) == 4  # 2 an epoch
    for i, (rec, size) in enumerate(zip(images, (64, 64, 96, 96))):
        assert f"train_input/{i % 2}".encode() in rec
        with Image.open(io.BytesIO(rec[rec.index(b"\x89PNG"):])) as im:
            assert im.size == (size, size) and im.mode == "RGB"


def test_add_image_writes_the_jax_event_bytes(tmp_path):
    rs = np.random.RandomState(0)
    u8 = rs.randint(0, 256, (20, 30, 3), dtype=np.uint8)
    f32 = rs.rand(12, 10, 3).astype(np.float32)
    gray = rs.randint(0, 256, (8, 9), dtype=np.uint8)
    paths = []
    for cls, d in ((SummaryWriter, "port"), (JaxSummaryWriter, "jax")):
        w = cls(str(tmp_path / d))
        for i, img in enumerate((u8, f32, gray)):
            w.add_image(f"train_input/{i}", img, 3 + i, wall_time=1234.5)
        w.add_scalar("loss", 0.25, 7, wall_time=1234.5)
        w.close()
        paths.append(w.path)
    got, want = (events(p) for p in paths)
    assert len(got) == len(want) == 5
    assert got[1:] == want[1:]  # the banner carries the time of day


def test_draw_detections_gives_the_jax_pixels():
    rs = np.random.RandomState(1)
    img = rs.randint(0, 256, (300, 420, 3), dtype=np.uint8)  # thickness 1; 700 px wide: 2
    big = rs.randint(0, 256, (500, 700, 3), dtype=np.uint8)
    names = ["cat", "dog", "person", "car"]
    for arr in (img, big):
        dets = [((10.4, 20.6, 200.2, 150.9), 0.91, 0), ((50.0, 5.0, 80.5, 40.5), 0.3, 2),
                ((0.0, 0.0, 419.0, 299.0), 0.55, 3), ((300.3, 200.7, 310.1, 250.2), 0.42, 1)]
        got = draw_detections(Image.fromarray(arr), [Detection(b, s, c, names[c])
                                                     for b, s, c in dets], names)
        want = jax_draw_detections(Image.fromarray(arr), [JaxDetection(b, s, c, names[c])
                                                         for b, s, c in dets], names)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert not np.array_equal(np.asarray(got), arr)
