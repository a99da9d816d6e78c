"""Shared set-up of the port's backbone parity tests
(tests/test_torch_backbones.py, tests/test_torch_legacy.py): one JAX
init per model, its variables carried into the port by ``from_flax``
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

from yoloret_tpu_torch.nn.layers import BatchNorm, calibrate_bn
from yoloret_tpu_torch.weights import from_flax

SIZE = 64
ANCHORS = np.asarray([[10, 13], [16, 30], [33, 23], [30, 61], [62, 45],
                      [59, 119], [116, 90], [156, 198], [373, 326]], np.float32)
TOL = dict(atol=2e-4, rtol=2e-4)  # as tests/test_torch_layers.py holds the forward


def _map(tree, fn, path=()):
    return {k: _map(v, fn, path + (k,)) if isinstance(v, dict) else fn(path + (k,), v)
            for k, v in tree.items()}


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


def make_pair(jax_model, port_model, seed=0, batch=2):
    """(inputs [batch, SIZE, SIZE, 3], calibrated Flax variables, the JAX
    forward's outputs as numpy, the port model holding the same weights).
    Module paths are the same in both trees."""
    x = np.random.RandomState(seed).rand(batch, SIZE, SIZE, 3).astype(np.float32)
    # jitted: one compile beats dispatching every op of the init eagerly
    variables = jax.device_get(
        jax.jit(lambda k: jax_model.init(k, jnp.asarray(x), False))(jax.random.PRNGKey(0)))
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
    out = jax.jit(lambda v, xx: jax_model.apply(v, xx, False))(variables, jnp.asarray(x))
    out = [np.asarray(o) for o in (out if isinstance(out, (tuple, list)) else [out])]
    return x, variables, out, port_model


def assert_heads_close(got, want):
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert np.abs(w).max() > 0.5, "outputs too small for the comparison to mean much"
        np.testing.assert_allclose(g.float().numpy(), w, **TOL)
