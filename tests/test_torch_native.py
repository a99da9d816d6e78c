"""The port's copy of the native JPEG loader vs the JAX package's own
source and wrapper (``yoloret_tpu/native``), bit for bit.

Both are built here with the same ``g++`` flags. The JAX loader builds
into its source tree at first use, where test workers race on one file,
so ``jax_native_built`` points it at a private directory for the length
of a test (module globals only; nothing in the JAX package changes).
Cases: the repo's demo photo at staging 224, 320 and 416; seeded JPEGs
that take libjpeg's DCT scaling at 1/2, 1/4 and 1/8; a grayscale JPEG;
an image smaller than the staging square; TFRecord bytes; a PNG payload,
which both refuse with ``IOError``.
"""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest
from PIL import Image

import yoloret_tpu.native as jax_native
from yoloret_tpu_torch import native
from yoloret_tpu_torch.data import tfrecord

DEMO = os.path.join(os.path.dirname(__file__), os.pardir, "yoloret_tpu", "assets", "demo.jpg")


def need_toolchain():
    """Skip where the loader cannot be built here: no ``g++``, or no
    ``jpeglib.h`` (the port's build error names it)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native loader cannot be built")
    if not native.available() and "jpeglib.h" in (native.build_error() or ""):
        pytest.skip("no jpeglib.h: the native loader cannot be built")


@contextlib.contextmanager
def jax_native_built(tmp_dir):
    """Both loaders built: the JAX package's into ``tmp_dir`` (its module
    globals ``_SO``, ``_lib``, ``_build_failed`` patched for the block), the
    port's into its build directory."""
    need_toolchain()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_SO", os.path.join(str(tmp_dir), "libyoloret_native.so"))
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_build_failed", False)
        assert jax_native.available(), "the JAX package's loader did not build"
        assert native.available(), native.build_error()
        yield


@pytest.fixture(scope="module")
def loaders(tmp_path_factory):
    with jax_native_built(tmp_path_factory.mktemp("jax_native")):
        yield


def _jpeg(rs, h, w, gray=False, quality=90):
    yy, xx = np.mgrid[0:h, 0:w]
    img = 127 + 100 * np.sin(xx[..., None] * rs.uniform(0.01, 0.05, 3)
                             + yy[..., None] * rs.uniform(0.01, 0.05, 3))
    img = np.clip(img + rs.randn(h, w, 3) * 10, 0, 255).astype(np.uint8)
    pil = Image.fromarray(img[..., 0] if gray else img)
    buf = io.BytesIO()
    pil.save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _same(got, want):
    assert got[1] == want[1]
    assert got[0].dtype == want[0].dtype and got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[0], want[0])


def _check_file(path, staging):
    for fn in ("decode_resize_u8", "decode_resize"):
        _same(getattr(native, fn)(path, staging), getattr(jax_native, fn)(path, staging))
    for q in (0, 75):
        _same(native.decode_resize_q_u8(path, staging, q),
              jax_native.decode_resize_q_u8(path, staging, q))
    with open(path, "rb") as f:
        raw = f.read()
    _check_bytes(raw, staging)
    got = native.decode_resize_batch([path, path + ".missing"], staging, threads=2)
    want = jax_native.decode_resize_batch([path, path + ".missing"], staging, threads=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2] == 1


def _check_bytes(raw, staging):
    for fn in ("decode_resize_bytes_u8", "decode_resize_bytes"):
        _same(getattr(native, fn)(raw, staging), getattr(jax_native, fn)(raw, staging))
    for q in (0, 60):
        _same(native.decode_resize_q_bytes_u8(raw, staging, q),
              jax_native.decode_resize_q_bytes_u8(raw, staging, q))


@pytest.mark.parametrize("staging", [224, 320, 416])
def test_demo_photo_matches_jax(loaders, staging):
    _check_file(DEMO, staging)
    img, hw = native.decode_resize_q_u8(DEMO, staging, 0)
    assert hw == (375, 500) and img.shape == (staging, staging, 3) and img.std() > 10


@pytest.mark.parametrize("staging,denom", [(320, 2), (200, 4), (64, 8)])
def test_dct_scaled_decode_matches_jax(loaders, tmp_path, staging, denom):
    """1400 x 1000 (w x h): libjpeg decodes at 1/denom, the smallest scale
    that still covers the staging square."""
    h, w = 1000, 1400
    assert min(h, w) // denom >= staging and (denom == 8 or min(h, w) // (2 * denom) < staging)
    path = str(tmp_path / "big.jpg")
    with open(path, "wb") as f:
        f.write(_jpeg(np.random.RandomState(denom), h, w))
    _check_file(path, staging)


@pytest.mark.parametrize("kind", ["grayscale", "smaller_than_staging"])
def test_odd_images_match_jax(loaders, tmp_path, kind):
    rs = np.random.RandomState(3)
    raw = _jpeg(rs, 90, 130, gray=True) if kind == "grayscale" else _jpeg(rs, 30, 50)
    path = str(tmp_path / f"{kind}.jpg")
    with open(path, "wb") as f:
        f.write(raw)
    _check_file(path, 96)
    img, _ = native.decode_resize_u8(path, 96)
    if kind == "grayscale":  # the one channel, broadcast
        assert (img[..., 0] == img[..., 1]).all() and (img[..., 1] == img[..., 2]).all()


def test_tfrecord_bytes_match_jax(loaders, tmp_path):
    """The payload of a TFRecord written and read back by the port's codec,
    and the native CRC32C of the record against both packages."""
    rs = np.random.RandomState(4)
    raws = [_jpeg(rs, 120, 160), _jpeg(rs, 200, 90, quality=70)]
    path = str(tmp_path / "x.tfrecord")
    with tfrecord.TFRecordWriter(path) as w:
        for raw in raws:
            w.write(tfrecord.Example({"image/encoded": raw}).serialize())
    for (off, ln), raw in zip(tfrecord.index_tfrecord(path), raws):
        record = tfrecord.read_record_at(path, off, ln)
        payload = tfrecord.Example.parse(record).features["image/encoded"]
        assert payload == raw
        _check_bytes(payload, 64)
        assert native.crc32c(record) == jax_native.crc32c(record) == tfrecord.crc32c(record)


def test_png_payload_raises_ioerror(loaders, tmp_path):
    buf = io.BytesIO()
    Image.fromarray(np.zeros((20, 20, 3), np.uint8)).save(buf, format="PNG")
    raw = buf.getvalue()
    path = str(tmp_path / "mislabelled.jpg")
    with open(path, "wb") as f:
        f.write(raw)
    for mod in (native, jax_native):
        with pytest.raises(IOError):
            mod.decode_resize_q_bytes_u8(raw, 32, 0)
        with pytest.raises(IOError):
            mod.decode_resize_q_u8(path, 32, 0)
        with pytest.raises(IOError):
            mod.decode_resize_u8(str(tmp_path / "missing.jpg"), 32)
