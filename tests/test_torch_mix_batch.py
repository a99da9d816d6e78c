"""The port's online mosaic and mixup (``yoloret_tpu_torch/data/augment.py::
mix_batch``) against the JAX package's (``yoloret_tpu/data/augment.py``),
on the CPU in float32.

With the JAX package's own draws (its key split in three: mosaic, mixup,
the mixup weight), the same [4, 64, 64, 3] batch gives JAX's images
within 1e-5, its boxes within 1e-4 px, its ``valid`` exactly and its
shapes (the box capacity), for mosaic only, mixup only, both and
neither. Then the properties of the JAX package's tests/test_mix_batch.py
on the port's own draws (``draw_mix``): the mosaic's quadrants and
boxes, the mixup's blend and box union, mosaic winning when both fire,
the pass-through, the capacity, and the small-batch warnings."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloret_tpu.data.augment import AugmentConfig as JaxAugmentConfig
from yoloret_tpu.data.augment import mix_batch as jax_mix_batch
from yoloret_tpu_torch.data import Dataset, DatasetMode
from yoloret_tpu_torch.data.augment import AugmentConfig, draw_mix, mix_batch

H = W = 64
T = 5
B = 4


def augmented_batch(seed=0):
    """What ``augment_batch`` hands on: images in [0, 1], boxes in input
    pixels (some at the border, some a pixel wide, padding rows), valid."""
    rs = np.random.RandomState(seed)
    imgs = rs.rand(B, H, W, 3).astype(np.float32)
    boxes = np.zeros((B, T, 5), np.float32)
    valid = np.zeros((B, T), bool)
    for i in range(B):
        n = 2 + i % 3
        xy = rs.uniform(0, W - 10, (n, 2))
        wh = rs.uniform(1.0, 40.0, (n, 2))
        boxes[i, :n, :2] = xy
        boxes[i, :n, 2:4] = np.minimum(xy + wh, W - 1)
        boxes[i, :n, 4] = rs.randint(0, 3, n)
        valid[i, :n] = True
    boxes[0, 1, :4] = [60.0, 61.0, 63.0, 63.0]  # at the corner: clipped in its quadrant
    boxes[1, 0, :4] = [5.0, 5.0, 7.5, 30.0]  # 2.5 px wide: 1.25 px at half scale
    boxes[2, 1, :4] = [5.0, 5.0, 6.9, 30.0]  # 0.95 px at half scale: dropped
    valid[3, 1] = False  # a padding row inside the real ones
    return imgs, boxes, valid


def jax_draws(key, cfg):
    """``mix_batch``'s draws from ``key``, as the port's draw dict."""
    k1, k2, k3 = jax.random.split(key, 3)
    do_mosaic = np.array(jax.random.uniform(k1, (B,)) < cfg.mosaic_prob)
    do_mixup = ~do_mosaic & np.array(jax.random.uniform(k2, (B,)) < cfg.mixup_prob)
    lam = np.array(jax.random.uniform(k3, (B, 1, 1, 1)))
    return {"do_mosaic": torch.from_numpy(do_mosaic), "do_mixup": torch.from_numpy(do_mixup),
            "lam": torch.from_numpy(lam)}


@pytest.mark.parametrize("mosaic,mixup", [(0.6, 0.0), (0.0, 0.6), (0.5, 0.7), (0.0, 0.0)],
                         ids=["mosaic", "mixup", "both", "neither"])
def test_mix_batch_matches_jax(mosaic, mixup):
    imgs, boxes, valid = augmented_batch()
    cfg = AugmentConfig(input_hw=(H, W), mosaic_prob=mosaic, mixup_prob=mixup)
    jcfg = JaxAugmentConfig(input_hw=(H, W), mosaic_prob=mosaic, mixup_prob=mixup)
    fired = {"do_mosaic": 0, "do_mixup": 0}
    for seed in (0, 1, 2):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 0x6D6978)  # as the pipeline folds
        draws = jax_draws(key, cfg)
        for k in fired:
            fired[k] += int(draws[k].sum())
        want = [np.asarray(v) for v in jax_mix_batch(
            jnp.asarray(imgs), jnp.asarray(boxes), jnp.asarray(valid), key, jcfg)]
        got = [v.numpy() for v in mix_batch(torch.from_numpy(imgs), torch.from_numpy(boxes),
                                            torch.from_numpy(valid), cfg, draws)]
        assert [g.shape for g in got] == [w.shape for w in want]
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(got[2], want[2])
    # each enabled mode fired on some row and left others alone
    assert (fired["do_mosaic"] > 0) == (mosaic > 0) and fired["do_mosaic"] < 3 * B
    assert (fired["do_mixup"] > 0) == (mixup > 0) and fired["do_mixup"] < 3 * B


def solid_batch():
    """4 solid-colour images, one box each, classes 0-3 (the JAX test's)."""
    imgs = np.zeros((B, H, W, 3), np.float32)
    boxes = np.zeros((B, T, 5), np.float32)
    valid = np.zeros((B, T), bool)
    for i, c in enumerate([(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0)]):
        imgs[i] = c
        boxes[i, 0] = [10, 14, 40, 50, i]
        valid[i, 0] = True
    return torch.from_numpy(imgs), torch.from_numpy(boxes), torch.from_numpy(valid)


def own_draws(mosaic, mixup, seed=0):
    cfg = AugmentConfig(input_hw=(H, W), mosaic_prob=mosaic, mixup_prob=mixup)
    return cfg, draw_mix(B, cfg, torch.Generator().manual_seed(seed), torch.device("cpu"))


def test_mosaic_composes_quadrants_and_boxes():
    cfg, draws = own_draws(1.0, 0.0)
    oi, ob, ov = (v.numpy() for v in mix_batch(*solid_batch(), cfg, draws))
    h2, w2 = H // 2, W // 2
    for row, quads in ((0, (0, 1, 2, 3)), (2, (2, 3, 0, 1))):  # row 2 wraps
        colors = [solid_batch()[0][q, 0, 0].numpy() for q in quads]
        for (ys, xs), c in zip(((slice(0, h2), slice(0, w2)), (slice(0, h2), slice(w2, W)),
                                (slice(h2, H), slice(0, w2)), (slice(h2, H), slice(w2, W))),
                               colors):
            np.testing.assert_allclose(oi[row, ys, xs], np.broadcast_to(c, (h2, w2, 3)),
                                       atol=1e-6)
    assert ov[0].sum() == 4
    got = {tuple(np.round(b, 3)) for b in ob[0][ov[0]]}
    want = {(10 * 0.5 + ox, 14 * 0.5 + oy, 40 * 0.5 + ox, 50 * 0.5 + oy, float(q))
            for q, (ox, oy) in enumerate([(0, 0), (w2, 0), (0, h2), (w2, h2)])}
    assert got == want


def test_mixup_blends_pixels_and_unions_boxes():
    cfg, draws = own_draws(0.0, 1.0)
    oi, ob, ov = (v.numpy() for v in mix_batch(*solid_batch(), cfg, draws))
    lam = float(draws["lam"][0])
    assert 0.0 <= lam <= 1.0
    # the partner of row 0 is row 2 (B/2 on): lam * red + (1 - lam) * blue
    np.testing.assert_allclose(oi[0, :, :, 0], lam, atol=1e-6)
    np.testing.assert_allclose(oi[0, :, :, 2], 1.0 - lam, atol=1e-6)
    np.testing.assert_allclose(oi[0, :, :, 1], 0.0, atol=1e-6)
    assert ov[0].sum() == 2 and sorted(ob[0][ov[0]][:, 4].tolist()) == [0.0, 2.0]
    for b in ob[0][ov[0]]:
        np.testing.assert_allclose(b[:4], [10, 14, 40, 50], atol=1e-6)


def test_mosaic_wins_when_both_fire():
    cfg, draws = own_draws(1.0, 1.0)
    assert draws["do_mosaic"].all() and not draws["do_mixup"].any()
    _, _, ov = mix_batch(*solid_batch(), cfg, draws)
    assert int(ov[0].sum()) == 4  # the mosaic's 4-box union, not mixup's 2


def test_passthrough_identity_and_capacity():
    imgs, boxes, valid = solid_batch()
    cfg, draws = own_draws(0.0, 0.0)
    oi, ob, ov = mix_batch(imgs, boxes, valid, cfg, draws)
    assert oi is imgs and ob is boxes and ov is valid
    for (mosaic, mixup), cap in (((0.0, 0.5), 2), ((0.5, 0.0), 4), ((0.5, 0.5), 4)):
        cfg, draws = own_draws(mosaic, mixup)
        _, ob, ov = mix_batch(imgs, boxes, valid, cfg, draws)
        assert ob.shape == (B, cap * T, 5) and ov.shape == (B, cap * T)


def test_small_batch_mixing_warns(tmp_path):
    from PIL import Image

    img = tmp_path / "w.jpg"
    Image.fromarray(np.full((32, 32, 3), 50, np.uint8)).save(img)
    ann = tmp_path / "w_2.txt"
    ann.write_text(f"{img} 2,2,20,20,0\n{img} 2,2,20,20,0\n")
    kw = dict(anchors=np.array([[10, 13]] * 9, np.float32), num_classes=1,
              input_hw=(32, 32), mode=DatasetMode.TRAIN, device="cpu")
    for batch, aug, word in ((2, dict(mosaic_prob=0.5), "mosaic"),
                             (1, dict(mixup_prob=0.5), "mixup"), (2, dict(mixup_prob=0.5), None)):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            Dataset(str(ann), batch, augment_config=AugmentConfig(**aug), **kw)
        if word:
            assert any(word in str(r.message) for r in rec)
        else:
            assert not rec  # batch 2 mixup is fine
