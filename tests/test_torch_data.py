"""The port's evaluation data path vs the JAX package: annotation parsing,
the TFRecord codec both ways, the device letterbox (``eval_batch``) and
the whole ``Dataset(mode=TEST)`` on a small mixed dataset, with both
packages decoding by PIL and by the native loader (staging images equal
bit for bit), and the choice of decoder per sample.

Float32 on the CPU; inputs made with numpy from a seed. The letterbox is
a resampling by two contractions whose summation order differs between
XLA and PyTorch: images at atol 1e-5 (values in [0, 1]), boxes at atol
1e-4 px, keep flags exact.
"""

import contextlib
import io
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import yoloret_tpu.native
import yoloret_tpu_torch.native
from test_torch_native import jax_native_built, need_toolchain
from yoloret_tpu.data import annotations as jax_annotations
from yoloret_tpu.data import tfrecord as jax_tfrecord
from yoloret_tpu.data.augment import AugmentConfig as JaxAugmentConfig
from yoloret_tpu.data.augment import eval_batch as jax_eval_batch
from yoloret_tpu.data.pipeline import Dataset as JaxDataset
from yoloret_tpu.data.pipeline import DatasetMode as JaxDatasetMode
from yoloret_tpu_torch.data import annotations, tfrecord
from yoloret_tpu_torch.data.augment import AugmentConfig, eval_batch, to_unit_float
from yoloret_tpu_torch.data.pipeline import Dataset, DatasetMode

torch.set_num_threads(1)

ANCHORS = np.asarray([[10, 13], [16, 30], [33, 23], [30, 61], [62, 45],
                      [59, 119], [116, 90], [156, 198], [373, 326]], np.float32)

LINES = [
    "img/a.jpg 10,20,30,40,1 5,5,60,70,0",  # keras-yolo3 comma format
    "img/b.jpg 10 20 30 40 1 5 5 60 70 0",  # the reference's flat quintuples
    "img/c.jpg",  # no boxes
    "img/d.jpg 1.5,2.5,3.5,4.5,2,0.9",  # extra comma field ignored
    "   ",  # empty
    "img/e.jpg  7 8 9 10 3  ",  # extra spaces
]


@pytest.mark.parametrize("line", LINES)
def test_parse_annotation_line_matches_jax(line):
    got = annotations.parse_annotation_line(line)
    want = jax_annotations.parse_annotation_line(line)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == np.float32 and got[1].shape[1] == 5


def test_malformed_line_raises_like_jax():
    line = "img/a.jpg 1 2 3 4"
    with pytest.raises(ValueError):
        jax_annotations.parse_annotation_line(line)
    with pytest.raises(ValueError, match="malformed"):
        annotations.parse_annotation_line(line)


def test_list_files_classes_and_anchors_match_jax(tmp_path):
    (tmp_path / "voc_test_3.txt").write_text("\n".join(LINES[:3]) + "\n\n")
    (tmp_path / "voc_val_2.txt").write_text("\n".join(LINES[3:]) + "\n")
    (tmp_path / "classes.txt").write_text("cat\n\ndog\n bird \n")
    (tmp_path / "anchors.txt").write_text(", ".join(str(v) for v in ANCHORS.ravel()) + "\n")
    pattern = str(tmp_path / "voc_*.txt")
    assert annotations.load_annotation_lines(pattern) == \
        jax_annotations.load_annotation_lines(pattern)
    assert annotations.load_annotation_lines(pattern)[1] == 5  # from the names' _N
    single = str(tmp_path / "voc_val_2.txt")
    assert annotations.load_annotation_lines(single) == \
        jax_annotations.load_annotation_lines(single)
    classes = str(tmp_path / "classes.txt")
    assert annotations.load_classes(classes) == jax_annotations.load_classes(classes) == \
        ["cat", "dog", "bird"]
    anchors = str(tmp_path / "anchors.txt")
    np.testing.assert_array_equal(annotations.load_anchors(anchors),
                                  jax_annotations.load_anchors(anchors))
    assert annotations.rewrite_image_paths(LINES, "img/", "/data/") == \
        jax_annotations.rewrite_image_paths(LINES, "img/", "/data/")


def _examples(rs, n):
    return [{
        "image/encoded": rs.bytes(int(rs.randint(1, 3000))),
        "image/filename": f"img_{i}.jpg",
        "image/object/bbox/xmin": [float(v) for v in rs.rand(i + 1).astype(np.float32)],
        "image/object/bbox/label": [int(v) for v in rs.randint(0, 80, i + 1)],
        "image/height": [int(rs.randint(1, 2 ** 40))],
    } for i in range(n)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tfrecord_both_ways(tmp_path, writer):
    """Written by one package, read by the other: the same bytes on disk,
    the same parsed Examples, and the CRC32C of the JAX package."""
    feats = _examples(np.random.RandomState(3), 6)
    paths = {}
    for name, mod in (("jax", jax_tfrecord), ("port", tfrecord)):
        paths[name] = str(tmp_path / f"{name}.tfrecord")
        with mod.TFRecordWriter(paths[name]) as w:
            for f in feats:
                w.write(mod.Example(f).serialize())
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    reader = tfrecord if writer == "jax" else jax_tfrecord
    records = list(reader.read_tfrecords(paths[writer], verify=True))
    assert reader.index_tfrecord(paths[writer]) == \
        (jax_tfrecord if reader is tfrecord else tfrecord).index_tfrecord(paths[writer])
    for rec, f in zip(records, feats):
        got = reader.Example.parse(rec).features
        want = f | {"image/filename": f["image/filename"].encode()}
        assert set(got) == set(want)
        for k, v in want.items():
            if k == "image/object/bbox/xmin":
                np.testing.assert_array_equal(np.float32(got[k]), np.float32(v))
            else:
                assert got[k] == v, k
        assert tfrecord.crc32c(rec) == jax_tfrecord.crc32c(rec)
        assert tfrecord.masked_crc(rec) == jax_tfrecord.masked_crc(rec)
    assert len(records) == len(feats)


def test_crc32c_known_values():
    # RFC 3720 B.4 test vectors
    assert tfrecord.crc32c(b"\x00" * 32) == 0x8A9136AA
    assert tfrecord.crc32c(b"\xff" * 32) == 0x62A8AB43
    assert tfrecord.crc32c(bytes(range(32))) == 0x46DD794E


def test_corrupt_record_is_refused(tmp_path):
    path = str(tmp_path / "x.tfrecord")
    with tfrecord.TFRecordWriter(path) as w:
        w.write(b"payload")
    data = bytearray(open(path, "rb").read())
    data[14] ^= 1
    open(path, "wb").write(bytes(data))
    with pytest.raises(IOError, match="corrupt"):
        list(tfrecord.read_tfrecords(path))


# -- the device letterbox ---------------------------------------------------

# (H, W) of the originals: wide, tall, square, smaller than the input
IMAGE_HW = [(100.0, 300.0), (300.0, 100.0), (200.0, 200.0), (30.0, 40.0)]


@pytest.mark.parametrize("input_hw", [(64, 64), (64, 96)])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_eval_batch_matches_jax(input_hw, dtype):
    rs = np.random.RandomState(sum(input_hw))
    b, s, t = len(IMAGE_HW), 64, 6
    images = rs.randint(0, 256, (b, s, s, 3), dtype=np.uint8)
    if dtype == "float32":
        images = (images / 255.0).astype(np.float32)
    xy = rs.rand(b, t, 2).astype(np.float32) * 0.8
    boxes = np.concatenate([xy, xy + rs.rand(b, t, 2).astype(np.float32) * 0.3,
                            rs.randint(0, 20, (b, t, 1)).astype(np.float32)], -1)
    boxes[0, 0, 2] = boxes[0, 0, 0] + 1e-3  # under a pixel wide: dropped
    valid = rs.rand(b, t) < 0.8
    hw = np.asarray(IMAGE_HW, np.float32)
    want = jax_eval_batch(jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(valid),
                          jnp.asarray(hw), JaxAugmentConfig(input_hw=input_hw))
    got = eval_batch(torch.from_numpy(images), torch.from_numpy(boxes), torch.from_numpy(valid),
                     torch.from_numpy(hw), AugmentConfig(input_hw=input_hw))
    assert got[0].shape == (b, *input_hw, 3) and got[0].dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert not got[2][0, 0] and got[2].any()
    # the letterbox leaves black bars outside the content
    assert float(got[0][0, 0].abs().max()) == 0.0 and float(got[0][0].max()) > 0.5


def test_to_unit_float():
    u8 = torch.tensor([0, 128, 255], dtype=torch.uint8)
    np.testing.assert_array_equal(to_unit_float(u8).numpy(),
                                  np.float32([0, 128, 255]) * np.float32(1 / 255.0))
    f = torch.tensor([0.25, 1.0], dtype=torch.float64)
    assert to_unit_float(f).dtype == torch.float32 and to_unit_float(f).tolist() == [0.25, 1.0]


# -- the whole eval dataset -------------------------------------------------


def _write_dataset(root, n_list=3, n_shard=2, seed=0):
    """A text list of ``n_list`` JPEGs (comma format) and one TFRecord
    shard of ``n_shard`` more (normalised boxes), images of mixed sizes."""
    rs = np.random.RandomState(seed)
    lines = []
    with tfrecord.TFRecordWriter(os.path.join(root, "b.tfrecord")) as w:
        for i in range(n_list + n_shard):
            h, wd = (int(v) for v in rs.randint(40, 160, 2))
            path = os.path.join(root, f"im{i}.jpg")
            Image.fromarray(rs.randint(0, 256, (h, wd, 3), dtype=np.uint8)).save(path)
            k = int(rs.randint(0, 4))
            x1, y1 = rs.rand(k) * wd * 0.6, rs.rand(k) * h * 0.6
            bw, bh = 5 + rs.rand(k) * wd * 0.3, 5 + rs.rand(k) * h * 0.3
            cls = rs.randint(0, 3, k)
            if i < n_list:
                lines.append(path + "".join(f" {a:.2f},{b:.2f},{a + c:.2f},{b + d:.2f},{e}"
                                            for a, b, c, d, e in zip(x1, y1, bw, bh, cls)))
            else:
                with open(path, "rb") as f:
                    raw = f.read()
                w.write(tfrecord.Example({
                    "image/encoded": raw,
                    "image/object/bbox/xmin": [float(v) for v in x1 / wd],
                    "image/object/bbox/ymin": [float(v) for v in y1 / h],
                    "image/object/bbox/xmax": [float(v) for v in (x1 + bw) / wd],
                    "image/object/bbox/ymax": [float(v) for v in (y1 + bh) / h],
                    "image/object/bbox/label": [float(v) for v in cls],
                }).serialize())
    with open(os.path.join(root, "a.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return os.path.join(root, "*.*[dt]")  # a.txt and b.tfrecord, not the JPEGs


@contextlib.contextmanager
def pinned_decoder(decoder, tmp_dir):
    """Both packages decode with ``decoder``: "pil" (the native loaders
    reported unavailable) or "native" (both loaders built,
    ``test_torch_native.jax_native_built``)."""
    if decoder == "native":
        with jax_native_built(tmp_dir):
            yield
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(yoloret_tpu.native, "available", lambda: False)
        mp.setattr(yoloret_tpu_torch.native, "available", lambda: False)
        yield


@pytest.mark.parametrize("decoder", ["pil", "native"])
def test_dataset_matches_jax(tmp_path, decoder):
    """Text list + TFRecord shard, 5 images at batch 2: three batches, the
    last padded with n_valid = 1. Both sides decode with ``decoder``; the
    staging images are equal bit for bit."""
    pattern = _write_dataset(str(tmp_path))
    with pinned_decoder(decoder, tmp_path):
        jds = JaxDataset(pattern, 2, ANCHORS, 3, input_hw=(64, 64), mode=JaxDatasetMode.TEST)
        want = list(jds.build(epochs=1))
        ds = Dataset(pattern, 2, input_hw=(64, 64), mode=DatasetMode.TEST, device="cpu",
                     num_workers=2)
        assert len(ds) == 5 and ds.staging == 64
        got = list(ds.build(epochs=1))
        assert ds.decodes == {decoder: 6}  # the padded row of the last batch is decoded too
        for i in range(len(ds)):
            g, w = ds._load_sample(i), jds._load_sample(i, None)
            np.testing.assert_array_equal(g[0], w[0])
            assert g[0].dtype == w[0].dtype == np.uint8 and g[3] == w[3]
    assert [g["n_valid"] for g in got] == [w["n_valid"] for w in want] == [2, 2, 1]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["images"].numpy(), np.asarray(w["images"]), rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(g["image_hw"].numpy(), np.asarray(w["image_hw"]))
        np.testing.assert_allclose(g["boxes_px"].numpy(), np.asarray(w["boxes_px"]), rtol=0,
                                   atol=1e-4)
        np.testing.assert_array_equal(g["boxes_valid"].numpy(), np.asarray(w["boxes_valid"]))
        np.testing.assert_array_equal(g["orig_boxes"], np.asarray(w["orig_boxes"]))
        np.testing.assert_array_equal(g["orig_valid"], np.asarray(w["orig_valid"]))
    assert sum(int(g["orig_valid"].sum()) for g in got[:2]) + int(got[2]["orig_valid"][0].sum()) > 0


def test_png_payload_goes_to_pil(tmp_path):
    """A TFRecord payload the native loader refuses (PNG) and a ``.png``
    path decode with PIL, JPEGs natively; the counts say which."""
    need_toolchain()
    rs = np.random.RandomState(9)
    im = rs.randint(0, 256, (40, 60, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(im).save(buf, format="PNG")
    with tfrecord.TFRecordWriter(str(tmp_path / "p.tfrecord")) as w:
        w.write(tfrecord.Example({"image/encoded": buf.getvalue()}).serialize())
    Image.fromarray(im).save(tmp_path / "p.png")
    Image.fromarray(im).save(tmp_path / "p.JPG")
    (tmp_path / "p.txt").write_text(f"{tmp_path / 'p.png'}\n{tmp_path / 'p.JPG'}\n")
    ds = Dataset(str(tmp_path / "p.*[dt]"), 3, input_hw=(32, 32), device="cpu", num_workers=1)
    batch = next(ds.build(epochs=1))
    assert ds.decodes == {"pil": 2, "native": 1} and batch["n_valid"] == 3
    np.testing.assert_array_equal(batch["image_hw"].numpy(), [[40, 60]] * 3)


def test_dataset_errors_and_early_close(tmp_path):
    pattern = _write_dataset(str(tmp_path))
    with pytest.raises(ValueError, match="anchors and num_classes"):
        Dataset(pattern, 2, mode=DatasetMode.TRAIN, device="cpu")
    with pytest.warns(UserWarning, match="mosaic"):  # mosaic below 4 rows repeats tiles
        Dataset(pattern, 2, mode=DatasetMode.TRAIN, device="cpu", anchors=np.ones((9, 2)),
                num_classes=2, augment_config=AugmentConfig(mosaic_prob=0.5))
    with pytest.raises(FileNotFoundError):
        Dataset(str(tmp_path / "missing_*.txt"), 2, device="cpu")
    # an error in the prefetch thread is raised in the consumer
    os.remove(tmp_path / "im1.jpg")
    with pytest.raises(FileNotFoundError):
        list(Dataset(pattern, 2, input_hw=(64, 64), device="cpu").build(epochs=1))
    # closing the iterator early stops the prefetch thread
    ds = Dataset(str(tmp_path / "b.tfrecord"), 1, input_hw=(64, 64), device="cpu", prefetch=1)
    before = threading.active_count()
    it = ds.build()  # forever
    next(it)
    it.close()
    assert threading.active_count() == before
