"""The port's Keras H5 import (``yoloret_tpu_torch/utils/keras_import.py``)
against the JAX package's (``yoloret_tpu/utils/keras_import.py``), on H5
files written from the published layer inventories of
tests/test_keras_inventory.py (keras-applications MobileNetV2 x0.75 and
x1.4 with their ``Conv_1`` top, qubvel EfficientNet-B3 by position),
with seeded values at unit scale (fan-in normal kernels, BatchNorm near
identity).

Held: the port's import equals the JAX import followed by
``weights.from_flax`` bit for bit (every key of the state dict: the
backbone replaced, the rest kept); a shape the model does not have
raises; and the detector's heads on the imported weights agree with the
JAX ``model.apply`` at 64 px in float32 (tests/_torch_parity.py's
tolerance), the neck's statistics calibrated on the inputs alike."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SIZE, TOL, _map, port_variables
from test_keras_inventory import efficientnet_inventory, h5py, mobilenetv2_inventory
from yoloret_tpu.nn import build_detector
from yoloret_tpu.utils.keras_import import load_backbone_weights as jax_load_backbone_weights
from yoloret_tpu_torch.nn.detector import YoloReT
from yoloret_tpu_torch.nn.layers import calibrate_bn
from yoloret_tpu_torch.utils.keras_import import load_backbone_weights
from yoloret_tpu_torch.weights import from_flax

CASES = [("mobilenetv2x75", lambda: mobilenetv2_inventory(0.75)),
         ("mobilenetv2x14", lambda: mobilenetv2_inventory(1.4)),
         ("efficientnetb3", lambda: efficientnet_inventory(width=1.2, depth=1.4)[0])]


def write_h5(path, inventory, seed=0):
    """An H5 file of ``inventory`` ((layer, weight, shape) in file order),
    laid out as keras-applications nests it, with seeded values."""
    rs = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        for layer, wname, shape in inventory:
            if wname in ("kernel", "depthwise_kernel"):
                fan_in = int(np.prod(shape[:2])) * (1 if wname == "depthwise_kernel"
                                                    else shape[2])
                val = rs.randn(*shape) / np.sqrt(fan_in)
            elif wname in ("gamma", "moving_variance"):
                val = rs.uniform(0.8, 1.2, shape)
            else:  # beta, moving_mean, conv bias
                val = 0.1 * rs.randn(*shape)
            f.create_dataset(f"{layer}/{layer}/{wname}:0", data=val.astype(np.float32))


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def imported(request, tmp_path_factory):
    """(backbone, the port's imported state dict, the JAX import's
    variables, the port model, the JAX model, the H5 path)."""
    backbone, inventory = request.param
    path = str(tmp_path_factory.mktemp("h5") / f"{backbone}.h5")
    write_h5(path, inventory())
    jm = build_detector(backbone, num_classes=3)
    pm = YoloReT(backbone, num_classes=3)
    variables = port_variables(jm, pm)
    got = load_backbone_weights(pm.state_dict(), path, backbone)
    want = jax_load_backbone_weights(variables, path, backbone)
    return backbone, got, jax.device_get(want), pm, jm, path


def test_import_equals_jax_import_then_from_flax(imported):
    backbone, got, want_vars, pm, _, _ = imported
    want = from_flax(want_vars, pm)
    assert set(got) == set(want)
    before = pm.state_dict()
    changed = 0
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
        changed += int(not torch.equal(got[k], before[k]))
    body = [k for k in want if k.startswith("body.")]
    assert changed == len(body), (changed, len(body))  # the whole backbone, nothing else


def test_heads_agree_with_jax_apply(imported):
    """The neck's and heads' BatchNorm statistics (seeded, not imported)
    are calibrated on the inputs first, on both sides alike, so that the
    heads are not near zero; the backbone keeps the imported ones."""
    backbone, got, want_vars, pm, jm, _ = imported
    x = np.random.RandomState(1).rand(2, SIZE, SIZE, 3).astype(np.float32)
    pm.load_state_dict(got, strict=True)
    pm.eval()
    calibrate_bn(pm, torch.from_numpy(x))
    state = {k: got[k] if k.startswith("body.") else v for k, v in pm.state_dict().items()}
    pm.load_state_dict(state, strict=True)
    leaf = {"mean": "running_mean", "var": "running_var"}
    want_vars = {"params": want_vars["params"], "batch_stats": _map(
        want_vars["batch_stats"], lambda path, v: v if path[0] == "body" else
        state[".".join(path[:-1] + (leaf[path[-1]],))].numpy())}
    want = jax.jit(lambda v, xx: jm.apply(v, xx, False))(want_vars, jnp.asarray(x))
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    assert len(out) == len(want)
    for g, w in zip(out, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert np.abs(w).max() > 0.5, "outputs too small for the comparison to mean much"
        np.testing.assert_allclose(g.float().numpy(), w, **TOL)


def widened(inventory, layer):
    """``inventory`` with ``layer``'s kernel 8 output channels wider."""
    return [(name, w, shape[:-1] + (shape[-1] + 8,) if (name, w) == (layer, "kernel") else shape)
            for name, w, shape in inventory]


B0_INVENTORY, B0_WHERE = efficientnet_inventory(width=1.0, depth=1.0)


@pytest.mark.parametrize("backbone,inventory", [
    # a Conv1 kernel of 999 filters
    ("mobilenetv2x75", [("Conv1", "kernel", (3, 3, 3, 999))]),
    # B0's file with the last built block's project conv 8 filters wider
    ("efficientnetb0", widened(B0_INVENTORY, B0_WHERE[(5, 3, "project")])),
])
def test_shape_mismatch_raises(tmp_path, backbone, inventory):
    path = str(tmp_path / "bad.h5")
    write_h5(path, inventory)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_backbone_weights(YoloReT(backbone, num_classes=3).state_dict(), path, backbone)
