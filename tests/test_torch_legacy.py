"""The port's legacy bodies, DarkNet-53 and the RFCR variants vs the JAX
package: YOLO-Nano, Yolo-Fastest (and -XL) and SkyNet whole, DarkNet-53
and MobileNetV2 x0.75 with RFCR ``concat`` and ``none`` as detectors, and
the weight bridge's dense leaf (``FCA``).

Float32 on the CPU at 64x64, batch 2, inputs from a numpy seed; one JAX
init per model (``tests/_torch_parity.py``), heads within atol = rtol =
2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_heads_close, jax_variables, make_pair
from yoloret_tpu.nn import build_detector as jax_build_detector
from yoloret_tpu.nn import legacy as jax_legacy
from yoloret_tpu_torch.nn import legacy
from yoloret_tpu_torch.nn.detector import YoloReT
from yoloret_tpu_torch.nn.fused_infer import fused_detector_apply, fused_params
from yoloret_tpu_torch.weights import from_flax

torch.set_num_threads(1)

NUM_CLASSES = 3
# name -> (JAX model, port model)
MODELS = {
    "yolo_nano": lambda: (jax_build_detector("yolo_nano", num_classes=NUM_CLASSES),
                          YoloReT("yolo_nano", num_classes=NUM_CLASSES)),
    "yolo_fastest": lambda: (jax_build_detector("yolo_fastest", num_classes=NUM_CLASSES),
                             YoloReT("yolo_fastest", num_classes=NUM_CLASSES)),
    "yolo_fastest_xl": lambda: (jax_build_detector("yolo_fastest_xl", num_classes=NUM_CLASSES),
                                YoloReT("yolo_fastest_xl", num_classes=NUM_CLASSES)),
    "skynet": lambda: (jax_legacy.SkyNet(num_classes=NUM_CLASSES),
                       legacy.SkyNet(num_classes=NUM_CLASSES)),
    "darknet53": lambda: (jax_build_detector("darknet53", num_classes=NUM_CLASSES),
                          YoloReT("darknet53", num_classes=NUM_CLASSES)),
    **{f"mobilenetv2x75_{rfcr}": (lambda rfcr=rfcr: (
        jax_build_detector("mobilenetv2x75", num_classes=NUM_CLASSES, rfcr=rfcr),
        YoloReT("mobilenetv2x75", num_classes=NUM_CLASSES, rfcr=rfcr)))
       for rfcr in ("concat", "none")},
}


@pytest.fixture(scope="module")
def pairs():
    """One JAX init and forward per model, made on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = make_pair(*MODELS[name](), jax_variables)
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(MODELS))
def test_heads_match_jax(pairs, name):
    x, _, want, port = pairs(name)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert_heads_close(got if isinstance(got, tuple) else [got], want)


@pytest.mark.parametrize("rfcr", ["concat", "none"])
def test_rfcr_variants_on_the_fused_path(pairs, rfcr):
    x, _, want, port = pairs(f"mobilenetv2x75_{rfcr}")
    assert_heads_close(fused_detector_apply(port, torch.from_numpy(x), fused_params(port)), want)


def test_rfcr_variant_layouts():
    concat = YoloReT("mobilenetv2x75", rfcr="concat")
    assert concat.rfcr.fuse_conv.depthwise.dwconv.weight.shape[0] == 4 * 48
    assert not hasattr(concat.rfcr, "fuse_weights")
    none = YoloReT("mobilenetv2x75", rfcr="none")
    assert not hasattr(none, "rfcr")
    # the neck takes the taps without the fused 96 channels: 160*0.75 -> 120
    assert none.neck.fpn_head_32.expand.conv.weight.shape[1] == 120
    assert YoloReT("mobilenetv2x75").neck.fpn_head_32.expand.conv.weight.shape[1] == 120 + 96


@pytest.mark.parametrize("name", ["yolo_nano", "yolo_fastest"])
def test_full_bodies_take_the_stock_forward(pairs, name):
    x, _, want, port = pairs(name)
    assert fused_params(port) is None and not hasattr(port, "neck")
    got = fused_detector_apply(port, torch.from_numpy(x))
    assert all(g.dtype == torch.float32 for g in got)
    assert_heads_close(got, want)


def test_dense_kernels_round_trip_through_the_bridge():
    rs = np.random.RandomState(0)
    x = rs.rand(2, 8, 8, 16).astype(np.float32)
    fca = jax_legacy.FCA(reduction=4)
    variables = jax.device_get(fca.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    port = legacy.FCA(16, reduction=4)
    state = from_flax(variables, port)
    assert tuple(state["reduce.weight"].shape) == (4, 16)  # nn.Linear: [out, in]
    np.testing.assert_array_equal(state["expand.weight"].numpy(),
                                  np.asarray(variables["params"]["expand"]["kernel"]).T)
    port.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(fca.apply(variables, jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape", [(3,), (3, 3, 4), (1, 1, 1, 2, 2)])
def test_bridge_refuses_kernels_of_other_ranks(shape):
    with pytest.raises(KeyError, match="kernel"):
        from_flax({"params": {"conv": {"kernel": np.zeros(shape, np.float32)}}})


def test_space_to_depth_matches_jax():
    x = np.random.RandomState(1).rand(2, 8, 6, 5).astype(np.float32)
    np.testing.assert_array_equal(legacy.space_to_depth(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_legacy.space_to_depth(jnp.asarray(x))))
