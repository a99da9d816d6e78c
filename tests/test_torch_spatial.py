"""The port's spatial sharding (``yoloret_tpu_torch/parallel/spatial.py``:
the mesh's ``model`` axis splits each image's rows) against the JAX
package's one-device forward and the port's own, on the CPU.

Held: ``make_mesh`` with a model axis and the JAX mesh's message; the row
partition and its refusal; the halo primitive where a halo is deeper
than a shard; the fused MobileNetV2 block on row slabs against the crop
of the whole-map block (and a zero-row halo shown wrong);
``spatial_apply`` on a (4, 2) mesh of CPU entries against the JAX
forward, as ``tests/test_spatial_sharding.py`` holds the JAX spatial
forward (atol 2e-4), for MobileNetV2 x0.75 at 128x128 and the other
backbones and fusions at 64x64, and against the port's one-device
forward (1e-5); ``Predictor(mesh=)`` with ``model=2``.

The int8 backbone and the zoom ensemble on ``make_mesh(["cpu"] * 4,
data=2, model=2)``, float32, are held against the port's one device and
against the JAX package on the same weights and images: the int8 codes
(the dequantized taps c2..c5) bit for bit against one device's,
MobileNetV2 x0.75 at 96 (shards of 64 and 32 rows) and EfficientNet-B0
at 64; the zoom crop (64 of a 96 input: it starts at row 16, off the
32-row grid) split over the row shards as an image of its own; both
flags together. The mesh's heads within 1e-5 of one device's, and of
the JAX ``Predictor``'s forward (``int8_detector_apply`` on the JAX
package's own calibration, or ``model.apply``, and the centre crop's)
within ``INT8_HEADS_TOL`` (int8) or the file's JAX tolerance (float32);
its slates matched to
one device's and to the JAX postprocess (``detect_batch`` at the
predictor's settings) of its heads. The int8 squeeze-excite mean of
codes equals the JAX block's ``jnp.mean`` bit for bit, on one device
and over uneven row shards. (The float32 neck on a shard's rows sums in
another order than on the whole map: its heads sit ~5e-7 from one
device's, so no slate is bit for bit; the neck on the gathered taps
gives one device's heads bit for bit.)
"""

import concurrent.futures
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity
from _torch_parity import ANCHORS, calibrated_pair, peaked_variables, port_variables
from yoloret_tpu.nn import build_detector as jax_build
from yoloret_tpu.nn import int8_infer as jax_int8
from yoloret_tpu.ops import detect_batch as jax_detect_batch
from yoloret_tpu.parallel import make_mesh as jax_make_mesh
from yoloret_tpu_torch.data.augment import to_unit_float
from yoloret_tpu_torch.infer import Predictor
from yoloret_tpu_torch.nn.detector import YoloReT
from yoloret_tpu_torch.nn.fused_infer import block_on_slab, fused_detector_apply, slab_window
from yoloret_tpu_torch.nn.int8_infer import efficientnet_int8_features, mobilenetv2_int8_features
from yoloret_tpu_torch.nn.layers import conv2d_same, mean_hw
from yoloret_tpu_torch.ops.mbconv import fused_mbconv, reference_mbconv
from yoloret_tpu_torch.parallel import make_mesh, partition_rows, spatial_apply, spatial_params
from yoloret_tpu_torch.parallel.spatial import current, run_groups, spatial_forward

torch.set_num_threads(1)

C = 4
JAX_TOL = dict(atol=2e-4, rtol=2e-4)  # tests/test_spatial_sharding.py's atol
PORT_TOL = dict(atol=1e-5, rtol=1e-5)


def test_make_mesh_with_a_model_axis():
    mesh = make_mesh(["cpu"] * 8, data=4, model=2)
    assert (mesh.data, mesh.model, len(mesh.devices)) == (4, 2, 8)
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh.group(1) == mesh.devices[2:4] and len(mesh.data_devices) == 4
    assert make_mesh(["cpu"] * 8, model=4).data == 2  # data = n // model, as JAX
    with pytest.raises(ValueError) as port:
        make_mesh(["cpu"] * 3, data=2, model=2)
    with pytest.raises(ValueError) as ref:
        jax_make_mesh(jax.devices()[:3], data=2, model=2)
    assert str(port.value) == str(ref.value) == "mesh 2x2 needs 4 devices, have 3"


def test_partition_rows():
    assert partition_rows(320, 4) == [(0, 96), (96, 160), (160, 256), (256, 320)]
    assert partition_rows(320, 2) == [(0, 160), (160, 320)]
    assert partition_rows(128, 4) == [(0, 32), (32, 64), (64, 96), (96, 128)]
    assert partition_rows(96, 1) == [(0, 96)]
    with pytest.raises(ValueError, match=r"model axis \(4\) exceeds the 2 rows"):
        partition_rows(64, 4)
    model = YoloReT("yolo_fastest", num_classes=C).eval()
    mesh = make_mesh(["cpu"] * 4, data=1, model=4)
    with pytest.raises(ValueError, match=r"model axis \(4\) exceeds the 2 rows"):
        spatial_apply(model, mesh, torch.zeros(1, 64, 64, 3), spatial_params(model, mesh))


def test_halo_deeper_than_a_shard():
    """Model 4 on 128 rows: the /32 map has one row a shard, so a 5x5
    conv's 2-row halo comes from two shards on each side; rows asked for
    outside the map are zeros."""
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 128, 8, 6).astype(np.float32))
    w = torch.from_numpy(np.random.RandomState(1).randn(6, 1, 5, 5).astype(np.float32))
    mesh = make_mesh(["cpu"] * 4, data=1, model=4)

    def fn(rows):  # the /32 map (image rows 0, 32, ...) and the /16 map
        deep, mid = rows[:, ::32], rows[:, ::16]
        return (current().rows(deep, -2, 3), conv2d_same(deep, w, groups=6),
                conv2d_same(mid, w, stride=2, groups=6), conv2d_same(mid, w, groups=6))

    out = run_groups(fn, mesh, [x])[0]
    deep, mid = x[:, ::32], x[:, ::16]
    want_rows = torch.cat([torch.zeros(2, 2, 8, 6), deep[:, :3]], dim=1)
    for k, (rows, a, b, c) in enumerate(out):
        assert torch.equal(rows, want_rows)
        torch.testing.assert_close(a, conv2d_same(deep, w, groups=6)[:, k:k + 1])
        torch.testing.assert_close(b, conv2d_same(mid, w, stride=2, groups=6)[:, k:k + 1])
        torch.testing.assert_close(c, conv2d_same(mid, w, groups=6)[:, 2 * k:2 * k + 2])


def _block_weights(cin, ce, cout, seed):
    rs = np.random.RandomState(seed)
    t = lambda *s, scale=1.0, shift=0.0: torch.from_numpy(
        (rs.randn(*s) * scale + shift).astype(np.float32))
    # positive expand biases: ReLU6(bias) of a zero row is not zero
    return (t(cin, ce, scale=0.3), t(ce, scale=0.1, shift=0.5), t(3, 3, ce, scale=0.3),
            t(ce, scale=0.1), t(ce, cout, scale=0.3), t(cout, scale=0.1))


@pytest.mark.parametrize("stride", [1, 2])
def test_fused_block_on_slabs(stride):
    """``block_on_slab`` over 3 row shards (the image's top, middle and
    bottom) of a 24-row map gives the crop of the whole-map block; the
    slab of a zero-row halo in its place gives another answer."""
    residual = stride == 1
    args = _block_weights(8, 16, 8, seed=stride)
    x = torch.from_numpy(np.random.RandomState(5).rand(2, 96, 10, 8).astype(np.float32))
    mesh = make_mesh(["cpu"] * 3, data=1, model=3)
    kw = dict(stride=stride, residual=residual)

    def fn(rows):  # the /4 map: image rows 0, 4, ...; 8 rows a shard
        return block_on_slab(fused_mbconv, rows[:, ::4].contiguous(), *args, **kw)

    out = run_groups(fn, mesh, [x])[0]
    whole = reference_mbconv(x[:, ::4].contiguous(), *args, **kw)
    n = 8 // stride
    for k, got in enumerate(out):
        torch.testing.assert_close(got, whole[:, k * n:(k + 1) * n], atol=1e-6, rtol=1e-6)
    assert slab_window(4, 4, 12, 2) == (8, 12, 0)  # the bottom: to the map's end
    assert slab_window(0, 4, 12, 2) == (0, 10, 0)
    assert slab_window(8, 8, 24, 1) == (7, 17, 1)
    # the middle shard with zero rows as its halo, padded as a conv would be
    mid = x[:, ::4][:, 8:16]
    if stride == 1:
        zero = torch.zeros(2, 1, 10, 8)
        wrong = reference_mbconv(torch.cat([zero, mid, zero], dim=1), *args, **kw)[:, 1:-1]
    else:
        zero = torch.zeros(2, 2, 10, 8)
        wrong = reference_mbconv(torch.cat([mid, zero], dim=1), *args, **kw)[:, :n]
    assert (wrong - whole[:, n:2 * n]).abs().max() > 0.1


CASES = [("mobilenetv2x75", "weighted_sum", 128), ("efficientnetb0", "weighted_sum", 64),
         ("darknet53", "weighted_sum", 64), ("yolo_nano", "weighted_sum", 64),
         ("yolo_fastest", "weighted_sum", 64), ("mobilenetv2x75", "concat", 64),
         ("mobilenetv2x75", "none", 64)]


@pytest.mark.parametrize("backbone,rfcr,size", CASES)
def test_spatial_apply_matches_jax(backbone, rfcr, size, monkeypatch):
    """``spatial_apply`` on ``make_mesh(["cpu"] * 8, data=4, model=2)``, b4:
    the JAX one-device heads within 2e-4 (the JAX spatial test's
    tolerance), float32; the port's one-device heads within 1e-5, float32
    on the fused MobileNetV2 path (its kernels compute in float32),
    float64 compute on the stock forward of the others (the first image,
    its rows over 2 shards): in float32,
    oneDNN's kernels, chosen by shape, sum a slab's rows in another order
    than the whole map's (DarkNet-53: 2.8e-5 at heads of 3.8).

    YOLO-Nano runs both sides at float64 compute (float32 heads): with
    these weights its float32 heads sit 3.8e-4 from JAX's on one device
    already, both 3-4e-4 from float64 (``tests/test_torch_legacy.py``
    takes the JAX init for it, whose compile costs ~23 s here)."""
    monkeypatch.setattr(_torch_parity, "SIZE", size)
    wide = backbone == "yolo_nano"
    jax_model = jax_build(backbone, num_classes=C, rfcr=rfcr)
    model = YoloReT(backbone, num_classes=C, rfcr=rfcr)
    x, variables = calibrated_pair(jax_model, model, port_variables, batch=4)
    if wide:
        jax_model = jax_build(backbone, num_classes=C, rfcr=rfcr, dtype=jnp.float64)
    with jax.enable_x64(wide):
        want = jax.jit(lambda v, xx: jax_model.apply(v, xx, False))(
            variables, jnp.asarray(x, jnp.float64 if wide else jnp.float32))
        want = [np.asarray(w) for w in want]
    mesh = make_mesh(["cpu"] * 8, data=4, model=2)
    images = torch.from_numpy(x)
    if wide:
        model.dtype = torch.float64
    params = spatial_params(model, mesh)
    got = spatial_apply(model, mesh, images, params)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        assert np.abs(np.asarray(w)).max() > 0.5
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **JAX_TOL)
    if model.kind != "mobilenetv2":  # float64: the first image over one data shard
        model.dtype, images = torch.float64, images[:1].double()
        mesh = make_mesh(["cpu"] * 2, data=1, model=2)
        got = spatial_apply(model, mesh, images, spatial_params(model, mesh))
    for g, o in zip(got, fused_detector_apply(model, images)):
        torch.testing.assert_close(g, o, **PORT_TOL)


def _predictor(v, size=64, **kw):
    return Predictor(weights=v, class_names=[str(i) for i in range(C)], anchors=ANCHORS,
                     input_hw=(size, size), bf16=False, device="cpu", score_threshold=0.2, **kw)


def test_predictor_with_a_model_axis():
    """``Predictor(mesh=)`` over 2 data x 2 row shards gives one device's
    slates, the int8 backbone and the zoom ensemble included (the cases
    below); ``evaluate_map`` keeps the JAX divisibility message."""
    from yoloret_tpu_torch.eval import evaluate_map

    mesh = make_mesh(["cpu"] * 4, data=2, model=2)
    v = peaked_variables(jax_build("mobilenetv2x75", num_classes=C), C)
    one, sp = _predictor(v), _predictor(v, mesh=mesh)
    rs = np.random.RandomState(0)
    images = [rs.randint(0, 256, (48 + 8 * i, 64 + 4 * i, 3), dtype=np.uint8) for i in range(6)]
    want, got = one.detect_arrays(images), sp.detect_arrays(images)
    assert sum(map(len, want)) > 0
    for g_img, w_img in zip(got, want):
        assert [d.class_id for d in g_img] == [d.class_id for d in w_img]
        for g, w in zip(g_img, w_img):
            np.testing.assert_allclose(g.box, w.box, atol=1e-3)
            assert abs(g.score - w.score) <= 1e-5
    with pytest.raises(ValueError, match=r"multiple of the mesh data axis \(2\)"):
        evaluate_map(sp, types.SimpleNamespace(batch_size=3), ["a"] * C)


@functools.lru_cache(maxsize=None)
def _peaked():
    return peaked_variables(jax_build("mobilenetv2x75", num_classes=C), C)


@pytest.fixture(scope="module")
def peaked(_jax_refs_started):
    _jax_refs_started["peaked"].result()  # made once, in the background
    return _peaked()


def _images(seed, size):
    """b2 uint8 images and their [h, w] for the int8 and zoom cases."""
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randint(0, 256, (2, size, size, 3), dtype=np.uint8))
    hw = (torch.from_numpy(rs.randint(32, 200, (2, 2)).astype(np.float32)) if size == 64
          else torch.full((2, 2), float(size)))
    return x, hw


def _efficientnet_variables():
    """EfficientNet-B0's port init in the Flax tree, BatchNorm calibrated
    (``calibrated_pair``), so that its activations are of unit scale."""
    return calibrated_pair(jax_build("efficientnetb0", num_classes=C),
                           YoloReT("efficientnetb0", num_classes=C), port_variables)[1]


def _jax_heads(backbone, variables, x, zoom=None, int8=False):
    """The JAX ``Predictor``'s forward on the same weights and images:
    ``int8_detector_apply`` on the JAX package's own calibration of 16
    seeded noise images, as its ``Predictor`` makes them, or
    ``model.apply``; with ``zoom`` its centre crop's too. The
    quantization is traced into the same jit (the JAX ``Predictor`` runs
    it eagerly, a compile per op). Returns (heads, crop heads or None) as
    numpy."""
    size = x.shape[1]
    jm = jax_build(backbone, num_classes=C, dtype=jnp.float32)
    quant = None
    if int8:
        calib = np.random.RandomState(0).randint(0, 256, (16, size, size, 3), np.uint8)
        batches = [b / np.float32(255.0) for b in (calib[:8], calib[8:])]
        if backbone.startswith("mobilenetv2"):
            alpha = jax_int8._ALPHAS[backbone]
            scales = jax_int8.calibrate_mobilenetv2(variables, batches, alpha=alpha)
            quant = lambda: jax_int8.quantize_mobilenetv2(variables, scales, alpha=alpha)
        else:
            scales = jax_int8.calibrate_efficientnet(variables, batches, variant="b0")
            quant = lambda: jax_int8.quantize_efficientnet(variables, scales, variant="b0")

    @jax.jit
    def forward(images):
        qp = quant() if int8 else None
        fwd = ((lambda z: jax_int8.int8_detector_apply(jm, variables, qp, z)) if int8
               else (lambda z: jm.apply(variables, z, False)))
        images = images.astype(jnp.float32) * (1.0 / 255.0)
        if not zoom:
            return fwd(images), None
        o = (size - zoom) // 2
        return fwd(images), fwd(images[:, o:o + zoom, o:o + zoom, :])

    return jax.device_get(forward(jnp.asarray(x.numpy())))


def _jax_detect(heads, hw, zoom_heads=None):
    """The JAX ``Predictor``'s postprocess (``detect_batch`` at the port
    predictor's settings) of the port's heads, as numpy."""
    infer = jax.jit(lambda h, image_hw, z: jax_detect_batch(
        h, jnp.asarray(ANCHORS), num_classes=C, image_hw=image_hw, score_threshold=0.2,
        iou_threshold=0.5, zoom_outputs=z, num_candidates=256))
    as_j = lambda hs: None if hs is None else [jnp.asarray(h.numpy()) for h in hs]
    return jax.device_get(infer(as_j(heads), jnp.asarray(hw.numpy()), as_j(zoom_heads)))


def _jax_job(name, peaked):
    """One of the JAX references ``jax_refs`` holds; ``peaked``: the
    future of ``_peaked()``."""
    if name == "efficientnetb0":
        eff = _efficientnet_variables()
        return eff, _jax_heads("efficientnetb0", eff, _images(1, 64)[0], None, True)
    if name == "mobilenetv2x75":  # the int8 forward at 96 and its 64 crop
        return _jax_heads("mobilenetv2x75", peaked.result(), _images(1, 96)[0], 64, True)
    return _jax_heads("mobilenetv2x75", peaked.result(), _images(2, 96)[0], 64, False)  # zoom


@pytest.fixture(scope="module", autouse=True)
def _jax_refs_started():
    """Starts, at this file's first test, the JAX package's heads for the
    int8 and zoom cases at its end, in threads (XLA compiles without the
    interpreter lock), so that they compile while the tests before them
    run: the int8 MobileNetV2 at 96 and its 64 crop (one calibration and
    one program), the int8 EfficientNet-B0 at 64, the float MobileNetV2 at
    96 and its crop; and the peaked weights first."""
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        futures = {"peaked": pool.submit(_peaked)}
        futures.update({name: pool.submit(_jax_job, name, futures["peaked"])
                        for name in ("mobilenetv2x75", "efficientnetb0", "zoom")})
        yield futures


@pytest.fixture(scope="module")
def jax_refs(_jax_refs_started):
    refs = {k: f.result() for k, f in _jax_refs_started.items() if k != "peaked"}
    refs["efficientnet_variables"], refs["efficientnetb0"] = refs["efficientnetb0"]
    return refs


def _matched(got, want):
    """The slates of the same detections: valid and classes equal, scores
    within 1e-5, boxes within 1e-3 px. The neck and RFCR run float32
    convolutions on each shard's rows, which sum in another order than the
    whole map's (heads ~5e-7 apart), so the slates are not bit for bit."""
    assert int(want.valid.sum()) > 0
    for field in ("valid", "classes"):
        assert torch.equal(getattr(got, field), getattr(want, field))
    torch.testing.assert_close(got.scores, want.scores, **PORT_TOL)
    torch.testing.assert_close(got.boxes, want.boxes, atol=1e-3, rtol=0)


def _mesh_heads(sp, mesh, x, crop=None):
    """The 2x2 mesh predictor's heads of ``x`` (uint8 [2, H, W, 3]), each
    whole, and with ``crop`` its centre crop's (else None): what its
    ``infer`` postprocesses (its input scaled as there)."""
    xf = [to_unit_float(z) for z in (x[:1], x[1:])]
    whole = lambda heads: [torch.cat([h[j] for h in heads]) for j in range(3)]
    main = whole(spatial_forward(sp.model, mesh, xf, sp._spatial))
    return main, None if crop is None else whole(spatial_forward(sp.model, mesh, xf, sp._spatial,
                                                                 crop=crop))


def _matches_jax(got, heads, hw, zoom_heads=None):
    """The mesh's slates against the JAX ``Predictor``'s postprocess of
    the mesh's heads, as ``tests/test_torch_zoom.py`` holds it: valid and
    classes equal, scores within 1e-6 relative, boxes within 1e-5
    relative and 1e-4 px. (Its slates of its own heads are not compared
    directly: where two overlapping boxes' scores lie close, a head
    difference in the 6th digit may flip which of them the suppression
    keeps, one more reason the heads are held at their own tolerance.)"""
    want = _jax_detect(heads, hw, zoom_heads)
    assert int(want.valid.sum()) > 0
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.classes.numpy(), want.classes)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, rtol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), want.boxes, rtol=1e-5, atol=1e-4)


def _heads_close(got, want, max_rel, rms_rel):
    """``tests/test_torch_int8.py``'s measure of the whole int8 detector:
    the largest difference over the largest |head|, and the relative RMS
    difference (heads of at least 0.1 somewhere: the peaked MobileNetV2's
    reach 0.33, the calibrated EfficientNet's above 1)."""
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0.1
        d = np.abs(g.numpy() - w)
        assert d.max() <= max_rel * np.abs(w).max(), (d.max(), np.abs(w).max())
        assert np.sqrt((d ** 2).mean() / (w ** 2).mean()) <= rms_rel


# The int8 heads against the JAX int8 forward's: (largest difference over
# the largest |head|, relative RMS difference). Each side calibrates on its
# own float32 forward (scales up to 1e-5 apart, tests/test_torch_int8.py's
# SCALE_RTOL) and the port's stem runs in float64, so a code may flip, and
# the chain after it carries the flip: MobileNetV2 x0.75's heads of the 96
# input sit up to 3.8e-3 and 1.9e-3 from the JAX forward's, its crop's
# 2.3e-6 (a flip moves a head by ~1e-3 of its largest, a wrong halo or a
# wrong mean by far more). EfficientNet: tests/test_torch_int8.py's
# HEADS_TOL (swish and squeeze-excite flip more codes).
INT8_HEADS_TOL = {"mobilenetv2x75": (1e-2, 5e-3), "efficientnetb0": (0.15, 0.1)}


@pytest.mark.parametrize("backbone", ["mobilenetv2x75", "efficientnetb0"])
def test_int8_on_row_shards(peaked, jax_refs, backbone):
    """``use_int8`` on the 2x2 mesh, float32, b2 (MobileNetV2 x0.75 at
    96x96, its rows 64 and 32 a shard; EfficientNet-B0 at 64x64): the int8
    codes of every tap (dequantized by one scale each) of the row-sharded
    backbone equal one device's bit for bit, the heads within 1e-5 and the
    slates matched; the int8 params are calibrated once and copied to
    each device of the mesh. Against the JAX package on the same weights
    and images: the mesh's heads at ``INT8_HEADS_TOL``, its slates
    against the JAX postprocess of its heads. The
    neck run on one device from the gathered taps gives one device's
    heads bit for bit: what keeps the mesh's slates from being bit for bit
    is the float32 neck on a shard's rows, not the int8 backbone."""
    mesh = make_mesh(["cpu"] * 4, data=2, model=2)
    v = peaked if backbone == "mobilenetv2x75" else jax_refs["efficientnet_variables"]
    size = 96 if backbone == "mobilenetv2x75" else 64
    one, sp = (_predictor(v, size=size, backbone=backbone, use_int8=True, mesh=m)
               for m in (None, mesh))
    assert sp._fused is None and all(r.qp is not None for r in sp._spatial.values())
    x, hw = _images(1, size)
    got = sp.infer(x, hw)
    _matched(got, one.infer(x, hw))
    heads, _ = _mesh_heads(sp, mesh, x)
    _matches_jax(got, heads, hw)
    _heads_close(heads, jax_refs[backbone][0], *INT8_HEADS_TOL[backbone])
    if backbone == "mobilenetv2x75":
        feats = lambda z: mobilenetv2_int8_features(one._qp, z, torch.float32, folded=True)
    else:
        feats = lambda z: efficientnet_int8_features(one._qp, z, torch.float32)
    xf = to_unit_float(x)
    want = feats(xf)
    taps = run_groups(feats, mesh, [xf[:1], xf[1:]])
    gathered = {k: torch.cat([torch.cat([r[k] for r in g], dim=1) for g in taps]) for k in want}
    for k, w in want.items():
        assert torch.equal(gathered[k], w), k
    one_heads = one._forward(xf)
    for g, w in zip(heads, one_heads):
        torch.testing.assert_close(g, w, **PORT_TOL)
    with torch.no_grad():
        for g, w in zip(one.model.neck_heads(gathered), one_heads):
            assert torch.equal(g, w)


def test_int8_squeeze_excite_mean_matches_jax():
    """The int8 squeeze-excite mean (``layers.mean_hw`` of int8 codes, the
    exact int32 sum over the whole map's count) equals ``jnp.mean`` of the
    codes as float32, the JAX int8 block's, bit for bit: on one device and
    over a model group of 2 whose shards are 64 and 32 rows (a mean of
    shard means would weigh them wrong)."""
    codes = np.random.RandomState(4).randint(-127, 128, (2, 96, 40, 24)).astype(np.int8)
    want = torch.from_numpy(np.array(jnp.mean(jnp.asarray(codes).astype(jnp.float32),
                                              axis=(1, 2), keepdims=True)))
    t = torch.from_numpy(codes)
    assert torch.equal(mean_hw(t, keepdim=True), want)
    mesh = make_mesh(["cpu"] * 2, data=1, model=2)
    got = run_groups(lambda z: (z.shape[1], mean_hw(z, keepdim=True)), mesh, [t])[0]
    assert [rows for rows, _ in got] == [64, 32]
    for _, m in got:
        assert torch.equal(m, want)


def test_zoom_on_row_shards(peaked, jax_refs):
    """``zoom_ensemble`` on the 2x2 mesh, float32: the centre 64 crop of a
    96 input (rows [16, 80), off the 32-row grid) split over the row
    shards as an image of its own (rows [0, 32) and [32, 64)), its heads
    within 1e-5 of one device's and within the file's JAX tolerance of
    the JAX forward's, the whole input's too; the slates (per-class
    pools) matched to one device's and to the JAX postprocess of the
    mesh's heads."""
    mesh = make_mesh(["cpu"] * 4, data=2, model=2)
    one, sp = (_predictor(peaked, size=96, zoom_ensemble=True, zoom_hw=(64, 64), mesh=m)
               for m in (None, mesh))
    x, hw = _images(2, 96)
    xf = x.float() / 255.0
    box = sp._zoom_box(xf)
    assert box == (16, 16, 64, 64)
    heads, crop_heads = _mesh_heads(sp, mesh, x, crop=box)
    for g, w in zip(crop_heads, fused_detector_apply(one.model, xf[:, 16:80, 16:80], one._fused)):
        torch.testing.assert_close(g, w, **PORT_TOL)
    for got, want in zip((heads, crop_heads), jax_refs["zoom"]):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, **JAX_TOL)
    got = sp.infer(x, hw)
    _matched(got, one.infer(x, hw))
    _matches_jax(got, heads, hw, crop_heads)
    with pytest.raises(ValueError, match="must be a multiple of 32"):
        spatial_forward(sp.model, mesh, [xf[:1], xf[1:]], sp._spatial, crop=(8, 8, 80, 80))


def test_int8_and_zoom_on_row_shards(peaked, jax_refs):
    """Both flags on the 2x2 mesh, float32: the int8 backbone on the full
    96 input and on its centre 64 crop, the heads of both within
    ``INT8_HEADS_TOL`` of the JAX int8 forward's,
    the slates matched to one device's and to the JAX postprocess of the
    mesh's heads."""
    mesh = make_mesh(["cpu"] * 4, data=2, model=2)
    one, sp = (_predictor(peaked, size=96, zoom_ensemble=True, zoom_hw=(64, 64), use_int8=True,
                          mesh=m) for m in (None, mesh))
    x, hw = _images(1, 96)
    got = sp.infer(x, hw)
    _matched(got, one.infer(x, hw))
    heads, crop_heads = _mesh_heads(sp, mesh, x, crop=sp._zoom_box(x))
    for mesh_heads, want in zip((heads, crop_heads), jax_refs["mobilenetv2x75"]):
        _heads_close(mesh_heads, want, *INT8_HEADS_TOL["mobilenetv2x75"])
    _matches_jax(got, heads, hw, crop_heads)
