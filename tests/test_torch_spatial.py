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
forward (1e-5); ``Predictor(mesh=)`` with ``model=2``; its int8 and zoom
refusals.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity
from _torch_parity import ANCHORS, calibrated_pair, peaked_variables, port_variables
from yoloret_tpu.nn import build_detector as jax_build
from yoloret_tpu.parallel import make_mesh as jax_make_mesh
from yoloret_tpu_torch.infer import Predictor
from yoloret_tpu_torch.nn.detector import YoloReT
from yoloret_tpu_torch.nn.fused_infer import block_on_slab, fused_detector_apply, slab_window
from yoloret_tpu_torch.nn.layers import conv2d_same
from yoloret_tpu_torch.ops.mbconv import fused_mbconv, reference_mbconv
from yoloret_tpu_torch.parallel import make_mesh, partition_rows, spatial_apply, spatial_params
from yoloret_tpu_torch.parallel.spatial import current, run_groups

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


def _predictor(v, **kw):
    return Predictor(weights=v, class_names=[str(i) for i in range(C)], anchors=ANCHORS,
                     input_hw=(64, 64), bf16=False, device="cpu", score_threshold=0.2, **kw)


def test_predictor_with_a_model_axis():
    """``Predictor(mesh=)`` over 2 data x 2 row shards gives one device's
    slates; int8 and the zoom ensemble refuse a model axis above 1;
    ``evaluate_map`` keeps the JAX divisibility message."""
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
    for flag in ("use_int8", "zoom_ensemble"):
        with pytest.raises(ValueError, match="queue 1 item 2b"):
            _predictor(v, mesh=mesh, **{flag: True})
    with pytest.raises(ValueError, match=r"multiple of the mesh data axis \(2\)"):
        evaluate_map(sp, types.SimpleNamespace(batch_size=3), ["a"] * C)
