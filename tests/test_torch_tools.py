"""The port's dataset-preparation tools (``yoloret_tpu_torch/tools/voc.py``,
``update_paths.py``, ``offline_augment.py``) against the JAX package's:
the same inputs and seed give the same outputs, byte for byte (files)
or array for array."""

import os
import random

import numpy as np
import pytest
from PIL import Image

from yoloret_tpu.tools import offline_augment as jax_aug
from yoloret_tpu.tools import update_paths as jax_update
from yoloret_tpu.tools import voc as jax_voc
from yoloret_tpu_torch.tools import offline_augment as aug
from yoloret_tpu_torch.tools import update_paths, voc

CLASSES = ["person", "dog", "cat"]


def _xml(fname, objects):
    objs = "".join(
        f"<object><name>{n}</name><difficult>{d}</difficult><bndbox><xmin>{b[0]}</xmin>"
        f"<ymin>{b[1]}</ymin><xmax>{b[2]}</xmax><ymax>{b[3]}</ymax></bndbox></object>"
        for n, d, b in objects)
    return f"<annotation><filename>{fname}</filename>{objs}</annotation>"


@pytest.fixture(scope="module")
def voc_dir(tmp_path_factory):
    """Twelve seeded VOC XMLs (known, unknown and difficult objects; one
    image with no kept object) and their JPEGs."""
    root = tmp_path_factory.mktemp("voc")
    ann, img = root / "ann", root / "img"
    ann.mkdir(), img.mkdir()
    rs = np.random.RandomState(0)
    for i in range(12):
        h, w = int(rs.randint(40, 90)), int(rs.randint(40, 90))
        Image.fromarray(rs.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(img / f"im{i}.jpg")
        objects = []
        for _ in range(int(rs.randint(0, 4))):
            x0, y0 = int(rs.randint(0, w // 2)), int(rs.randint(0, h // 2))
            box = (x0, y0, x0 + int(rs.randint(5, w // 2)), y0 + int(rs.randint(5, h // 2)))
            name = ["person", "dog", "cat", "zebra"][int(rs.randint(0, 4))]
            objects.append((name, int(rs.rand() < 0.2), box))
        (ann / f"im{i}.xml").write_text(_xml(f"im{i}.jpg", objects))
    return root


@pytest.mark.parametrize("keep_difficult", [False, True])
def test_parse_voc_xml_matches_jax(voc_dir, keep_difficult):
    for xml in sorted((voc_dir / "ann").glob("*.xml")):
        got = voc.parse_voc_xml(str(xml), CLASSES, keep_difficult)
        want = jax_voc.parse_voc_xml(str(xml), CLASSES, keep_difficult)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].dtype == want[1].dtype


def _bytes(paths):
    return [open(p, "rb").read() for p in paths]


def test_voc_lists_and_tfrecords_match_jax(voc_dir, tmp_path):
    got = voc.voc_to_lists(str(voc_dir / "ann"), str(voc_dir / "img"), str(tmp_path / "p"),
                           CLASSES, seed=3)
    want = jax_voc.voc_to_lists(str(voc_dir / "ann"), str(voc_dir / "img"),
                                str(tmp_path / "j"), CLASSES, seed=3)
    assert [os.path.basename(p)[1:] for p in got.values()] == [
        os.path.basename(p)[1:] for p in want.values()]
    assert _bytes(got.values()) == _bytes(want.values())
    assert sum(len(b.splitlines()) for b in _bytes(got.values())) > 0
    shards = voc.voc_to_tfrecords(got["train"], str(tmp_path / "pt"), shard_size=3)
    jshards = jax_voc.voc_to_tfrecords(got["train"], str(tmp_path / "jt"), shard_size=3)
    assert len(shards) == len(jshards) > 1
    assert _bytes(shards) == _bytes(jshards)


def test_update_paths_matches_jax(voc_dir, tmp_path):
    lines = "".join(f"/data/voc/im{i}.jpg 1,2,30,40,{i % 3}\n/other/im{i}.jpg\n"
                    for i in range(4))
    for name in ("p.txt", "j.txt", "p_in.txt", "j_in.txt"):
        (tmp_path / name).write_text(lines)
    update_paths.main(["/data/voc", "/mnt/v", str(tmp_path / "p.txt")])
    jax_update.main(["/data/voc", "/mnt/v", str(tmp_path / "j.txt")])
    got = (tmp_path / "p.txt.rewritten").read_bytes()
    assert got == (tmp_path / "j.txt.rewritten").read_bytes() and b"/mnt/v/im3.jpg" in got
    update_paths.main(["/data/voc", "/mnt/v", str(tmp_path / "p_in.txt"), "--in-place"])
    jax_update.main(["/data/voc", "/mnt/v", str(tmp_path / "j_in.txt"), "--in-place"])
    assert (tmp_path / "p_in.txt").read_bytes() == (tmp_path / "j_in.txt").read_bytes() == got


def _images(seed, n=4):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        h, w = int(rs.randint(50, 120)), int(rs.randint(50, 120))
        boxes = np.asarray([[5, 5, w // 2, h // 2, 0], [w // 3, h // 3, w - 2, h - 2, 1]],
                           np.float32)
        out.append((rs.randint(0, 256, (h, w, 3), dtype=np.uint8), boxes))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_cutout_mixup_mosaic_match_jax(seed):
    ims = _images(seed)
    got = aug.cutout(ims[0][0], ims[0][1], n_holes=2, rng=random.Random(seed))
    want = jax_aug.cutout(ims[0][0], ims[0][1], n_holes=2, rng=random.Random(seed))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(aug.mixup(*ims[1], *ims[2]), jax_aug.mixup(*ims[1], *ims[2])):
        np.testing.assert_array_equal(g, w)
    imgs, boxes = zip(*ims)
    got = aug.mosaic(imgs, boxes, size=160, rng=random.Random(seed))
    want = jax_aug.mosaic(imgs, boxes, size=160, rng=random.Random(seed))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got[1]) > 0


def test_augment_dataset_matches_jax(tmp_path):
    lines = []
    for i, (im, boxes) in enumerate(_images(5)):
        p = tmp_path / f"src{i}.jpg"
        Image.fromarray(im).save(p)
        lines.append(aug._fmt_line(str(p), boxes))
    src = tmp_path / "list.txt"
    src.write_text("\n".join(lines) + "\n")
    kw = dict(n_cutout=2, n_mixup=2, n_mosaic=2, n_autoaugment=2, seed=7)
    n = aug.augment_dataset(str(src), str(tmp_path / "p"), str(tmp_path / "p.txt"), **kw)
    jn = jax_aug.augment_dataset(str(src), str(tmp_path / "j"), str(tmp_path / "j.txt"), **kw)
    assert n == jn > len(lines)
    got = (tmp_path / "p.txt").read_text().replace(str(tmp_path / "p"), "OUT")
    assert got == (tmp_path / "j.txt").read_text().replace(str(tmp_path / "j"), "OUT")
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == sorted(os.listdir(tmp_path / "j")) and len(names) == n - len(lines)
    assert _bytes([tmp_path / "p" / f for f in names]) == _bytes(
        [tmp_path / "j" / f for f in names])
