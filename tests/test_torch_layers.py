"""PyTorch port (yoloret_tpu_torch) vs the JAX package: layers, the
stock and fused detector forward, the weight bridge, and the port's
package rules (no JAX import, no quiet CPU fallback).

Float32 on the CPU; inputs made with numpy from a seed and handed to
both. Forward tolerance atol/rtol 2e-4, as tests/test_fused_infer.py
holds the BN fold.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloret_tpu.nn import build_detector as jax_build_detector
from yoloret_tpu.nn.layers import maxpool_downsample as jax_maxpool
from yoloret_tpu.nn.layers import upsample2x as jax_upsample
from yoloret_tpu_torch.nn.detector import YoloReT, build_detector
from yoloret_tpu_torch.nn.fused_infer import fused_detector_apply
from yoloret_tpu_torch.nn.layers import conv2d_same, maxpool_downsample, upsample2x
from yoloret_tpu_torch.weights import from_flax

torch.set_num_threads(1)

NUM_CLASSES = 3
SIZE = 64


def _perturbed(variables, seed=1):
    """Non-trivial BN statistics, BN affine and fusion weights, so that a
    swapped or dropped leaf in the bridge shows."""
    rs = np.random.RandomState(seed)

    def walk(tree, fn):
        return {k: walk(v, fn) if isinstance(v, dict) else fn(k, np.asarray(v))
                for k, v in tree.items()}

    def stats(k, v):
        return (v + 0.05 * rs.rand(*v.shape)).astype(np.float32)

    def params(k, v):
        if k == "scale":
            return (v * (1.0 + 0.1 * rs.randn(*v.shape))).astype(np.float32)
        if k in ("bias", "alpha"):
            return (v + 0.05 * rs.randn(*v.shape)).astype(np.float32)
        return v

    return {"params": walk(variables["params"], params),
            "batch_stats": walk(variables["batch_stats"], stats)}


@pytest.fixture(scope="module")
def ref():
    """One JAX init and forward shared by the file's tests."""
    model = jax_build_detector("mobilenetv2x75", num_classes=NUM_CLASSES)
    x = np.random.RandomState(0).rand(2, SIZE, SIZE, 3).astype(np.float32)
    # jitted: one compile each beats dispatching every op eagerly (~3x faster)
    variables = jax.jit(lambda k: model.init(k, jnp.asarray(x), False))(jax.random.PRNGKey(0))
    variables = _perturbed(jax.device_get(variables))
    heads = [np.asarray(h) for h in
             jax.jit(lambda v, xx: model.apply(v, xx, False))(variables, jnp.asarray(x))]
    taps = jax.jit(lambda v, xx: model.apply(
        v, xx, method=lambda m, xi: m.body(xi.astype(m.dtype), False)))(variables, jnp.asarray(x))
    port = YoloReT("mobilenetv2x75", num_classes=NUM_CLASSES)
    port.load_state_dict(from_flax(variables, port), strict=True)
    port.eval()
    return dict(x=x, variables=variables, heads=heads,
                taps={k: np.asarray(v) for k, v in taps.items()}, port=port)


def test_stock_detector_matches_flax(ref):
    with torch.no_grad():
        got = ref["port"](torch.from_numpy(ref["x"]))
    for g, w in zip(got, ref["heads"]):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=2e-4, rtol=2e-4)


def test_fused_detector_matches_flax(ref):
    got = fused_detector_apply(ref["port"], torch.from_numpy(ref["x"]))
    assert [tuple(g.shape) for g in got] == [w.shape for w in ref["heads"]]
    for g, w in zip(got, ref["heads"]):
        np.testing.assert_allclose(g.numpy(), w, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("tap", ["c2", "c3", "c4", "c5"])
def test_backbone_taps_match_flax(ref, tap):
    with torch.no_grad():
        got = ref["port"].body(torch.from_numpy(ref["x"]))
    np.testing.assert_allclose(got[tap].numpy(), ref["taps"][tap], atol=2e-4, rtol=2e-4)


def test_from_flax_rejects_unknown_and_missing_keys(ref):
    v = ref["variables"]
    bad = {"params": dict(v["params"], extra={"kernel": np.zeros((1, 1, 1, 1))}),
           "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError):
        from_flax(bad, ref["port"])
    rfcr = {k: val for k, val in v["params"]["rfcr"].items() if k != "fuse_weights"}
    missing = {"params": dict(v["params"], rfcr=rfcr), "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError):
        from_flax(missing, ref["port"])
    with pytest.raises(KeyError):
        from_flax({"params": {"conv": {"gamma": np.ones(2)}}})


@pytest.mark.parametrize("k,stride,h,groups", [
    (3, 2, 16, 1), (3, 2, 15, 1), (3, 1, 9, 1), (5, 1, 8, 4), (3, 2, 10, 4), (1, 1, 6, 1),
])
def test_conv2d_same_matches_flax_padding(k, stride, h, groups):
    rs = np.random.RandomState(k * 100 + h)
    cin, cout = 4, 8
    x = rs.randn(2, h, h + 2, cin).astype(np.float32)
    w = rs.randn(k, k, cin // groups, cout).astype(np.float32)  # HWIO
    want = jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups)
    got = conv2d_same(torch.from_numpy(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                      stride=stride, groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_resample_matches_flax():
    x = np.random.RandomState(5).randn(2, 8, 12, 3).astype(np.float32)
    np.testing.assert_array_equal(upsample2x(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_upsample(jnp.asarray(x))))
    for s in (2, 4):
        np.testing.assert_array_equal(maxpool_downsample(torch.from_numpy(x), s).numpy(),
                                      np.asarray(jax_maxpool(jnp.asarray(x), s)))


def test_port_imports_without_jax():
    """Every module of the port imports with jax, flax and yoloret_tpu
    blocked (a fresh interpreter, so the block touches nothing else)."""
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'yoloret_tpu'): sys.modules[m] = None\n"
        "import importlib, pkgutil, yoloret_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(yoloret_tpu_torch.__path__,"
        " 'yoloret_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'flax', 'yoloret_tpu.'))"
        " for m in sys.modules if sys.modules[m] is not None), 'jax leaked'\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15


def test_entry_points_raise_without_cuda(monkeypatch):
    from yoloret_tpu_torch.infer import Predictor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(class_names=["a"], anchors=np.ones((9, 2), np.float32))
    with pytest.raises(RuntimeError):
        build_detector(num_classes=2)
    assert build_detector(num_classes=2, device="cpu").body.stem.conv.weight.device.type == "cpu"


@pytest.mark.parametrize("hw", [40, 12])
def test_spatial_attention_mbconv_matches_jax(hw):
    """``MBConv(spatial_attention=True)`` against the JAX block with the
    weights carried by ``from_flax`` (the ``spatial`` subtree: the
    ``squeeze`` conv, the ``reduce``/``expand`` dense layers), float32:
    at 40x40 the gate resizes to 20x20 and back (JAX's resize antialiases
    the downsample), at 12x12 it does not resize. The gate alone too."""
    from yoloret_tpu.nn.layers import MBConv as JaxMBConv
    from yoloret_tpu_torch.nn.layers import MBConv

    x = np.random.RandomState(3).rand(2, hw, hw, 8).astype(np.float32)
    jax_block = JaxMBConv(8, 8, expand_ratio=2, spatial_attention=True)
    variables = _perturbed(jax.device_get(jax_block.init(jax.random.PRNGKey(1),
                                                         jnp.asarray(x), False)))
    sp = variables["params"]["spatial"]
    assert set(sp) == {"squeeze", "reduce", "expand"}
    block = MBConv(8, 8, expand_ratio=2, spatial_attention=True, spatial_hw=(hw, hw))
    block.load_state_dict(from_flax(variables, block), strict=True)
    block.eval()
    want = np.asarray(jax_block.apply(variables, jnp.asarray(x), False))
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    from yoloret_tpu.nn.layers import SpatialAttention as JaxSpatialAttention

    gate_vars = {"params": sp}
    y = np.random.RandomState(4).randn(2, hw, hw, 16).astype(np.float32)
    want = np.asarray(JaxSpatialAttention().apply(gate_vars, jnp.asarray(y)))
    with torch.no_grad():
        got = block.spatial(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
