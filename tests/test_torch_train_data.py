"""The port's training data path against the JAX package's
(``yoloret_tpu/data/pipeline.py``, ``yoloret_tpu/data/augment.py``), on
the CPU at 64x64.

Held: the host stream bitwise (sample order over epochs, the per-sample
JPEG re-encode qualities, ``skip_batches``), with both packages pinned
to one decoder; ``augment_batch`` with the JAX package's draws injected
(this file replays its key splits: one key per batch, split into one
key per sample, each split into 12, ``uniform(keys[k], (), lo, hi)``)
within 1e-4 on the images and 1e-4 px on the boxes, the default chain
and one with brightness, noise and blur on; TRAIN and VALIDATE batches
with the JAX package's keys, shapes and dtypes (VALIDATE's values too:
its letterbox and targets are deterministic); and a stream resumed at
batch k giving batch k of the uninterrupted stream."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import ANCHORS
from test_torch_data import _write_dataset, pinned_decoder
from yoloret_tpu.data.augment import AugmentConfig as JaxAugmentConfig
from yoloret_tpu.data.augment import augment_batch as jax_augment_batch
from yoloret_tpu.data.pipeline import Dataset as JaxDataset
from yoloret_tpu.data.pipeline import DatasetMode as JaxDatasetMode
from yoloret_tpu_torch.data.augment import AugmentConfig, augment_batch
from yoloret_tpu_torch.data.pipeline import Dataset, DatasetMode

C = 3


@pytest.mark.parametrize("decoder", ["pil", "native"])
def test_host_stream_bitwise(tmp_path, decoder):
    pattern = _write_dataset(str(tmp_path), n_list=5, n_shard=2)
    with pinned_decoder(decoder, tmp_path):
        jds = JaxDataset(pattern, 2, ANCHORS, C, input_hw=(64, 64), mode=JaxDatasetMode.TRAIN,
                         seed=3, num_workers=2)
        ds = Dataset(pattern, 2, input_hw=(64, 64), mode=DatasetMode.TRAIN, device="cpu",
                     anchors=ANCHORS, num_classes=C, seed=3, num_workers=2)
        assert ds.steps_per_epoch() == jds.steps_per_epoch() == 3
        for skip in (0, 4):
            want = list(jds._host_batches(epochs=3, skip=skip))
            got = list(ds._host_batches(epochs=3, skip=skip))
            assert len(got) == len(want) == 9 - skip  # drop_last: 3 of 7 samples per epoch
            for g, w in zip(got, want):
                for k in ("images", "boxes", "valid", "image_hw", "n_valid"):
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        qualities = [q for _, _, qs, _ in ds.host_plan(epochs=3) for q in qs]
        assert len(set(qualities)) > 1 and all(80 <= q <= 100 for q in qualities)
        assert ds.decodes[decoder] > 0 and sum(ds.decodes.values()) == ds.decodes[decoder]


def jax_draws(rng, batch, cfg):
    """The per-sample draws of ``yoloret_tpu/data/augment.py::_augment_one``
    for ``augment_batch(..., rng)``, as the port's draw dict."""
    out = {k: [] for k in ("ar_num", "ar_den", "scale", "fx", "fy", "flip", "hue", "sat",
                           "val", "gamma", "contrast", "noise")}
    j, c = cfg.jitter, cfg.contrast
    for r in jax.random.split(rng, batch):
        keys = jax.random.split(r, 12)

        def u(k, lo, hi):
            return float(jax.random.uniform(keys[k], (), jnp.float32, lo, hi))

        for name, k, lo, hi in (("ar_num", 0, 1 - j, 1 + j), ("ar_den", 1, 1 - j, 1 + j),
                                ("scale", 2, cfg.min_scale, cfg.max_scale),
                                ("fx", 3, 0.0, 1.0), ("fy", 4, 0.0, 1.0),
                                ("hue", 6, -cfg.hue, cfg.hue), ("sat", 7, 1 - cfg.sat, 1 + cfg.sat),
                                ("val", 11, -cfg.val, cfg.val),
                                ("gamma", 8, cfg.min_gamma, cfg.max_gamma),
                                ("contrast", 9, 1 - c, 1 + c)):
            out[name].append(u(k, lo, hi))
        out["flip"].append(bool(jax.random.uniform(keys[5], ()) < 0.5))
        out["noise"].append(np.asarray(jax.random.uniform(
            keys[10], (*cfg.input_hw, 3), jnp.float32, 0.0, cfg.noise)))
    draws = {k: torch.tensor(v) for k, v in out.items() if k != "noise"}
    draws["noise"] = torch.from_numpy(np.stack(out["noise"]))
    return draws


@pytest.mark.parametrize("extra", [{}, {"val": 0.2, "noise": 0.05, "blur": True}])
def test_augment_batch_with_jax_draws(extra):
    b, s = 8, 80
    rs = np.random.RandomState(1)
    images = rs.randint(0, 256, (b, s, s, 3), dtype=np.uint8)
    lo = rs.uniform(0.0, 0.6, (b, 6, 2))
    boxes = np.concatenate([lo, lo + rs.uniform(0.05, 0.4, (b, 6, 2)),
                            rs.randint(0, C, (b, 6, 1))], -1).astype(np.float32)
    valid = rs.rand(b, 6) < 0.8
    jcfg = JaxAugmentConfig(input_hw=(64, 64), **extra)
    rng = jax.random.PRNGKey(7)
    wi, wb, wk = jax_augment_batch(jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(valid),
                                   rng, jcfg)
    draws = jax_draws(rng, b, jcfg)
    assert draws["scale"].min() < 0.5 < 1.5 < draws["scale"].max()  # shrink and grow
    assert 0 < int(draws["flip"].sum()) < b
    cfg = AugmentConfig(**dataclasses.asdict(jcfg))
    gi, gb, gk = augment_batch(torch.from_numpy(images), torch.from_numpy(boxes),
                               torch.from_numpy(valid), cfg, draws)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=0, atol=1e-4)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=0, atol=1e-4)


def test_train_and_validate_batches_match_jax(tmp_path):
    pattern = _write_dataset(str(tmp_path), n_list=5, n_shard=2)
    with pinned_decoder("pil", tmp_path):
        for jmode, mode in ((JaxDatasetMode.TRAIN, DatasetMode.TRAIN),
                            (JaxDatasetMode.VALIDATE, DatasetMode.VALIDATE)):
            jds = JaxDataset(pattern, 2, ANCHORS, C, input_hw=(64, 64), mode=jmode,
                             num_workers=2)
            ds = Dataset(pattern, 2, input_hw=(64, 64), mode=mode, device="cpu",
                         anchors=ANCHORS, num_classes=C, num_workers=2)
            want = next(iter(jds.build(epochs=1)))
            got = next(iter(ds.build(epochs=1)))
            assert set(got) == set(want), mode
            for k, w in want.items():
                g = got[k]
                if k == "n_valid":
                    assert g == w
                    continue
                w = np.asarray(w)
                g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
                assert g.shape == w.shape and g.dtype == w.dtype, (mode, k)
                if mode == DatasetMode.VALIDATE:
                    if g.dtype == bool:
                        np.testing.assert_array_equal(g, w, err_msg=k)
                    else:
                        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=k)


def test_resume_at_a_batch_gives_that_batch(tmp_path):
    pattern = _write_dataset(str(tmp_path), n_list=5, n_shard=2)
    ds = Dataset(pattern, 2, input_hw=(64, 64), mode=DatasetMode.TRAIN, device="cpu",
                 anchors=ANCHORS, num_classes=C, num_workers=2)
    it = ds.build()
    full = [next(it) for _ in range(5)]
    it.close()
    it = ds.build(skip_batches=3)
    resumed = [next(it) for _ in range(2)]
    it.close()
    for g, w in zip(resumed, full[3:]):
        assert set(g) == set(w)
        for k in g:
            assert torch.equal(g[k], w[k]), k
    assert not torch.equal(full[0]["images"], full[3]["images"])
