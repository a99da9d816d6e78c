"""Shared set-up of the port's backbone parity tests
(tests/test_torch_backbones.py, tests/test_torch_legacy.py): one init per
model (``jax_variables``, or ``port_variables``: the port's seeded init
written into the Flax tree's structure), its variables carried into the port by ``from_flax``
with a strict key match, BatchNorm statistics calibrated on the inputs
and written back into the Flax tree, so both sides run the same weights
on unit-scale activations (the seeded fan-out init alone shrinks them
towards zero, where any two forwards agree).

Each calibrated variance is floored at its layer's mean variance. Without
the floor, near-dead channels of seeded weights get gains up to
1/sqrt(eps) and amplify float32 rounding: at EfficientNet-B0 both the JAX
and the port's float32 heads were 4e-4 from a float64 forward of the port
(the same distance each, so no fault of either); with it, 4e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from yoloret_tpu_torch.nn.detector import YoloReT
from yoloret_tpu_torch.nn.layers import BatchNorm, calibrate_bn, init_weights
from yoloret_tpu_torch.weights import from_flax

SIZE = 64
ANCHORS = np.asarray([[10, 13], [16, 30], [33, 23], [30, 61], [62, 45],
                      [59, 119], [116, 90], [156, 198], [373, 326]], np.float32)
TOL = dict(atol=2e-4, rtol=2e-4)  # as tests/test_torch_layers.py holds the forward


def _map(tree, fn, path=()):
    return {k: _map(v, fn, path + (k,)) if isinstance(v, dict) else fn(path + (k,), v)
            for k, v in tree.items()}


def to_flax(shapes, state):
    """A port state dict as the Flax variables whose structure
    ``shapes`` (``jax.eval_shape`` of the init) gives: the inverse of
    ``weights.from_flax``."""
    names = {"kernel": "weight", "scale": "weight", "bias": "bias", "alpha": "alpha",
             "mean": "running_mean", "var": "running_var"}

    def fn(path, _):
        v = state[".".join(path[1:-1] + (names[path[-1]],))].detach().double().numpy()
        if path[-1] == "kernel":
            v = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v.T
        return np.ascontiguousarray(v, np.float32)

    return _map(jax.tree.map(lambda a: a, shapes), fn)


def jax_variables(jax_model, port_model=None):
    """Flax variables of the JAX init (``port_model`` unused: the same
    signature as ``port_variables``)."""
    # jitted: one compile beats dispatching every op of the init eagerly
    return jax.device_get(jax.jit(lambda k: jax_model.init(
        k, jnp.zeros((1, SIZE, SIZE, 3)), False))(jax.random.PRNGKey(0)))


def port_variables(jax_model, port_model, seed=0):
    """Flax variables of ``port_model``'s seeded init, in the structure of
    ``jax_model``'s tree: ``jax.eval_shape`` traces the JAX init without
    compiling it, which spares most of a model's set-up on a CPU."""
    init_weights(port_model, torch.Generator().manual_seed(seed))
    shapes = jax.eval_shape(lambda k: jax_model.init(k, jnp.zeros((1, SIZE, SIZE, 3)), False),
                            jax.random.PRNGKey(0))
    return to_flax({k: dict(t) for k, t in shapes.items()}, port_model.state_dict())


def peaked_variables(jax_model, num_classes, seed=3):
    """Flax variables of a MobileNetV2 x0.75 detector from the port's
    seeded init (``port_variables``), with the head kernels amplified x4,
    so that scores form distinct input-dependent peaks instead of ties at
    0.25."""
    v = port_variables(jax_model, YoloReT("mobilenetv2x75", num_classes=num_classes), seed)
    return _map(v, lambda path, a: a * 4.0 if path[-1] == "kernel" and any(
        "head" in p for p in path) else a)


def perturb_params(params, seed=1):
    """Non-trivial BN affine, conv biases and fusion weights, so that a
    swapped or dropped leaf in the bridge shows."""
    rs = np.random.RandomState(seed)

    def fn(path, v):
        v = np.asarray(v, np.float32)
        if path[-1] == "scale":
            return (v * (1.0 + 0.1 * rs.randn(*v.shape))).astype(np.float32)
        if path[-1] in ("bias", "alpha"):
            return (v + 0.05 * rs.randn(*v.shape)).astype(np.float32)
        return v

    return _map(params, fn)


def make_pair(jax_model, port_model, init, seed=0, batch=2):
    """(inputs [batch, SIZE, SIZE, 3], calibrated Flax variables, the JAX
    forward's outputs as numpy, the port model holding the same weights).
    Module paths are the same in both trees. ``init`` (``jax_variables``
    or ``port_variables``) gives the weights from the two models."""
    x, variables = calibrated_pair(jax_model, port_model, init, seed, batch)
    out = jax.jit(lambda v, xx: jax_model.apply(v, xx, False))(variables, jnp.asarray(x))
    out = [np.asarray(o) for o in (out if isinstance(out, (tuple, list)) else [out])]
    return x, variables, out, port_model


def calibrated_pair(jax_model, port_model, init, seed=0, batch=2):
    """``make_pair`` without the JAX forward: (inputs, calibrated Flax
    variables); ``port_model`` is left holding the same weights."""
    x = np.random.RandomState(seed).rand(batch, SIZE, SIZE, 3).astype(np.float32)
    variables = init(jax_model, port_model)
    variables = {"params": perturb_params(variables["params"]),
                 "batch_stats": variables["batch_stats"]}
    port_model.load_state_dict(from_flax(variables, port_model), strict=True)
    port_model.eval()
    calibrate_bn(port_model, torch.from_numpy(x))
    for m in port_model.modules():
        if isinstance(m, BatchNorm):
            m.running_var.clamp_(min=m.running_var.mean().item())
    state = port_model.state_dict()
    leaf = {"mean": "running_mean", "var": "running_var"}
    variables["batch_stats"] = _map(
        variables["batch_stats"],
        lambda path, v: state[".".join(path[:-1] + (leaf[path[-1]],))].numpy().copy())
    return x, variables


def assert_heads_close(got, want):
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert np.abs(w).max() > 0.5, "outputs too small for the comparison to mean much"
        np.testing.assert_allclose(g.float().numpy(), w, **TOL)
