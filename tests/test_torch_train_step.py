"""The port's training step against the JAX package's
(``yoloret_tpu/train/step.py``) on the CPU: MobileNetV2 x0.75 and
EfficientNet-B0 (drop-connect rate 0 on both sides) at 64x64, batch 2.

The exact checks run both sides with float32 parameters and a float64
compute dtype (``jax.enable_x64``; BatchNorm statistics follow the input
to float64 on both sides, the heads and the loss stay float32). In
float32 the JAX package's own train-mode gradient on the CPU is 1e-3
from a float64 evaluation of the same function at these shapes (the
port's float32 is 3e-5 from it), and Adam's first step turns such noise
on the parameters whose gradient is zero in exact arithmetic (a bias
whose shift the next training BatchNorm removes) into +-lr, so float32
cannot hold parameters after two steps to 1e-5. Float32 runs the
train-mode forward and the loss (1e-4 relative), bfloat16 one step (its
tolerance below).

Held: the train-mode heads and BatchNorm statistics, the loss and the
parameter gradients (1e-4 relative), the parameters, statistics, step
and EMA after two Adam steps (1e-5), stage 1 with and without
``truncate_block`` (the labels as JAX's; frozen leaves and body
statistics bitwise unchanged; the loss and the neck's statistics against
JAX's stage-1 forward), FGSM updating the statistics once,
``remat`` giving the numbers of the plain step, and the cosine schedule
at every step."""

import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import ANCHORS, SIZE, perturb_params, to_flax
from yoloret_tpu.nn import build_detector as jax_build
from yoloret_tpu.nn import detector as jax_detector
from yoloret_tpu.ops.targets import assign_targets_batch as jax_assign
from yoloret_tpu.ops.targets import true_corner_boxes as jax_corners
from yoloret_tpu.train.freeze import backbone_freeze_mask as jax_freeze_mask
from yoloret_tpu.train.losses import yolo_loss as jax_loss
from yoloret_tpu.train.step import StepConfig as JaxStepConfig
from yoloret_tpu.train.step import TrainState as JaxState
from yoloret_tpu.train.step import cosine_lr_schedule as jax_cosine
from yoloret_tpu.train.step import train_step as jax_train_step
from yoloret_tpu_torch.nn.detector import YoloReT
from yoloret_tpu_torch.nn.layers import BatchNorm, MBConv, calibrate_bn, init_weights
from yoloret_tpu_torch.train.freeze import FROZEN, backbone_freeze_mask
from yoloret_tpu_torch.train.step import (
    StepConfig,
    TrainState,
    batch_loss,
    cosine_lr_schedule,
    train_step,
)
from yoloret_tpu_torch.weights import from_flax

C = 4
ANCHOR_T = tuple(map(tuple, ANCHORS.tolist()))
GRAD_TOL = 1e-4
STEP_TOL = 1e-5


def make_batch(x, seed=0):
    rs = np.random.RandomState(seed)
    boxes = np.zeros((x.shape[0], 6, 5), np.float32)
    xy = rs.uniform(0, SIZE - 24, (x.shape[0], 4, 2))
    wh = rs.uniform(6, SIZE / 2, (x.shape[0], 4, 2))
    boxes[:, :4, :2] = xy
    boxes[:, :4, 2:4] = np.minimum(xy + wh, SIZE - 1)
    boxes[:, :4, 4] = rs.randint(0, C, (x.shape[0], 4))
    ys = jax_assign(jnp.asarray(boxes), (SIZE, SIZE), jnp.asarray(ANCHORS), C, 3)
    gt, gv = jax_corners(jnp.asarray(boxes), (SIZE, SIZE))
    jbatch = {"images": jnp.asarray(x), "gt_boxes": gt, "gt_valid": gv,
              **{f"y_true_{l}": ys[l] for l in range(3)}}
    return jbatch, {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}


def build(backbone):
    """(JAX model at float64 compute, Flax variables, port model at
    float64 compute) holding the same weights: the port's seeded init
    with BatchNorm affine perturbed and running statistics calibrated on
    the inputs (as ``_torch_parity.make_pair`` does from the JAX init),
    written into the Flax tree. The port's EfficientNet blocks get
    drop-connect rate 0."""
    jm = jax_build(backbone, num_classes=C, dtype=jnp.float64)
    pm = YoloReT(backbone, num_classes=C, dtype=torch.float32)
    init_weights(pm, torch.Generator().manual_seed(0))
    for m in pm.modules():
        if isinstance(m, MBConv):
            m.drop_connect_rate = 0.0
    x = np.random.RandomState(0).rand(2, SIZE, SIZE, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.asarray(x), False), jax.random.PRNGKey(0))
    shapes = {k: dict(v) for k, v in shapes.items()}
    params = perturb_params(to_flax({"params": shapes["params"]}, pm.state_dict())["params"])
    pm.load_state_dict(from_flax({"params": params}), strict=False)
    pm.eval()
    calibrate_bn(pm, torch.from_numpy(x))
    for m in pm.modules():
        if isinstance(m, BatchNorm):
            m.running_var.clamp_(min=m.running_var.mean().item())
    variables = to_flax(shapes, pm.state_dict())
    pm.dtype = torch.float64
    return jm, variables, pm, x


def at_dtype(backbone, variables, pm, jdtype, tdtype):
    """The same weights at another compute dtype on both sides."""
    jm = jax_build(backbone, num_classes=C, dtype=jdtype)
    pm = copy.deepcopy(pm)
    pm.dtype = tdtype
    return jm, pm


def stash_grads():
    """An optax stage that keeps the raw gradients in its state and passes
    them on: chained before Adam, the JAX step's own gradients."""
    return optax.GradientTransformation(
        lambda params: {"g": jax.tree.map(jnp.zeros_like, params)},
        lambda updates, state, params=None: (updates, {"g": updates}))


def leaves_close(got, want, rtol, atol, what):
    for k, w in want.items():
        np.testing.assert_allclose(got[k].double().numpy(), w.double().numpy(), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {k}")


def stats_of(variables):
    return from_flax({"batch_stats": jax.device_get(variables)})


BACKBONES = ["mobilenetv2x75", "efficientnetb0"]
mobilenet_only = pytest.mark.parametrize("f64", BACKBONES[:1], indirect=True)


@pytest.fixture(scope="module", params=BACKBONES)
def f64(request):
    """Both sides at float64 compute: the model pair, a batch, and the JAX
    state after each of two Adam steps (EMA on), with the gradients of
    the first."""
    mp = pytest.MonkeyPatch()
    if request.param.startswith("efficientnet"):
        kind, kw = jax_detector.BACKBONES[request.param]
        mp.setitem(jax_detector.BACKBONES, request.param, (kind, dict(kw, drop_connect_rate=0.0)))
    with jax.enable_x64(True):
        jm, variables, pm, x = build(request.param)
        jbatch, tbatch = make_batch(x)
        tx = optax.chain(stash_grads(), optax.adam(jax_cosine(1e-3, 2, 1), eps=1e-8))
        state = jax.jit(lambda p, b: JaxState.create(jm.apply, p, b, tx, use_ema=True))(
            variables["params"], variables["batch_stats"])
        step = jax.jit(partial(jax_train_step, cfg=JaxStepConfig(anchors=ANCHOR_T)))
        states, metrics = [], []
        for _ in range(2):
            state, m = step(state, jbatch, jax.random.PRNGKey(1))
            states.append(jax.device_get(state))
            metrics.append(jax.device_get(m))
            # the float64 forward turns the float32 statistics float64; the
            # next step starts from them at float32, as the port's buffers
            # hold them, and so reuses the first step's compile
            state = state.replace(batch_stats=jax.tree.map(lambda a: a.astype(jnp.float32),
                                                           state.batch_stats))
    yield dict(backbone=request.param, jm=jm, variables=variables, pm=pm, x=x, batch=tbatch,
               jbatch=jbatch, states=states, metrics=metrics,
               grads=from_flax({"params": states[0].opt_state[0]["g"]}))
    mp.undo()


def test_train_forward(f64):
    """The train-mode forward: heads and updated statistics within 1e-6
    (float64 compute, the heads cast to float32 as the JAX model's
    ``head_dtype`` and the port's loss cast them)."""
    with jax.enable_x64(True):
        _, want_stats, want_heads = jax_train_forward(f64["jm"], f64["variables"],
                                                      f64["jbatch"], heads=True)
    pm = copy.deepcopy(f64["pm"])
    heads = pm(f64["batch"]["images"], True)
    for h, w in zip(heads, want_heads):
        h = h.float()
        np.testing.assert_allclose(h.detach().numpy(), w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max())
    scale = max(float(v.abs().max()) for v in want_stats.values())
    leaves_close(pm.state_dict(), want_stats, 1e-6, 1e-9 * scale, "train-mode stats")


def test_train_loss_and_grads(f64):
    pm = copy.deepcopy(f64["pm"])
    cfg = StepConfig(anchors=ANCHOR_T)
    total, _ = batch_loss(pm, f64["batch"]["images"], f64["batch"], cfg, True, None)
    names = [n for n, _ in pm.named_parameters()]
    grads = torch.autograd.grad(total, [p for _, p in pm.named_parameters()])
    np.testing.assert_allclose(float(total.detach()), float(f64["metrics"][0]["loss"]),
                               rtol=GRAD_TOL)
    scale = max(float(v.abs().max()) for v in f64["grads"].values())
    leaves_close(dict(zip(names, grads)), f64["grads"], GRAD_TOL, 1e-7 * scale, "grad")


def params_close(got, want, what):
    """Every element within 1e-4 absolute, and all but one in a thousand
    within 1e-5 (relative, with an absolute floor of 1e-5). Adam's step
    normalises each gradient element, so an element whose gradient sits
    within the float32 loss's last bits of zero moves by an amount
    either side picks at random below lr (1e-3); the bulk is held to
    1e-5."""
    n_out = n = 0
    for k, w in want.items():
        g, w = got[k].double().numpy(), w.double().numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=f"{what} {k}")
        n_out += int((np.abs(g - w) > STEP_TOL + STEP_TOL * np.abs(w)).sum())
        n += w.size
    assert n_out <= n // 1000, f"{what}: {n_out} of {n} elements beyond 1e-5"


def port_state(jstate, pm):
    """A port TrainState holding a JAX state: weights, statistics, Adam
    moments, step and EMA."""
    pm = copy.deepcopy(pm)
    pm.load_state_dict(from_flax({"params": jstate.params, "batch_stats": jstate.batch_stats}))
    state = TrainState(pm, cosine_lr_schedule(1e-3, 2, 1), use_ema=True)
    state.step = int(jstate.step)
    adam = jstate.opt_state[1][0]
    for mine, tree in ((state.mu, adam.mu), (state.nu, adam.nu)):
        flat = from_flax({"params": tree})
        for t, n in zip(mine, state.names):
            t.copy_(flat[n])
    state.ema = from_flax({"params": jstate.ema_params})
    return state


def test_two_adam_steps_with_ema(f64):
    """Each of two steps from the JAX state before it: the parameters and
    EMA within 1e-5 (``params_close``), the statistics within 1e-5
    relative, the step count equal. Step 2 reads the schedule at step 1,
    the bias correction at count 2 and the EMA ramp at t = 1.

    EfficientNet also runs the two steps on its own and is held to JAX's
    second state. MobileNetV2 is not: its seeded init has ReLU6 channels
    that are dead on this batch, whose exact zeros sit on the kinks, and
    there a one-ulp difference of a step-1 weight (the two Adams round
    differently) moves a step-2 gradient by 20%; given JAX's step-1
    state, the port's step-2 gradient is JAX's to 1e-7."""
    cfg = StepConfig(anchors=ANCHOR_T)
    start = port_state(f64["states"][0], f64["pm"])  # the JAX state after step 1
    first = TrainState(copy.deepcopy(f64["pm"]), cosine_lr_schedule(1e-3, 2, 1), use_ema=True)
    runs = [(first, 0), (start, 1)]
    if f64["backbone"] == "efficientnetb0":
        runs.append((first, 1))  # the second step of the port's own run
    for state, i in runs:
        jstate, jm_ = f64["states"][i], f64["metrics"][i]
        m = train_step(state, f64["batch"], cfg)
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]), rtol=GRAD_TOL)
        assert state.step == int(jstate.step) == i + 1
        got = state.model.state_dict()
        params_close(got, from_flax({"params": jstate.params}), f"step {i + 1}")
        stats = stats_of(jstate.batch_stats)
        scale = max(float(v.abs().max()) for v in stats.values())
        leaves_close(got, stats, STEP_TOL, 1e-7 * scale, f"stats {i + 1}")
        params_close(state.ema, from_flax({"params": jstate.ema_params}), f"ema {i + 1}")


def jax_train_forward(jm, variables, jbatch, backbone_train=True, heads=False):
    """The JAX train-mode loss and updated statistics (what a step keeps
    of the forward), and with ``heads`` the heads."""
    def fn(v, batch):
        outs, mutated = jm.apply(v, batch["images"], True, backbone_train,
                                 mutable=["batch_stats"])
        total, _ = jax_loss(outs, [batch[f"y_true_{l}"] for l in range(3)],
                            batch["gt_boxes"], batch["gt_valid"], jnp.asarray(ANCHORS))
        return total, mutated["batch_stats"], outs

    total, stats, outs = jax.jit(fn)(variables, jbatch)
    out = (float(total), stats_of(stats))
    return out + ([np.asarray(o) for o in outs],) if heads else out


@mobilenet_only
def test_stage1_freeze_matches_jax_and_keeps_frozen_leaves(f64):
    with jax.enable_x64(True):
        want_loss, want_stats = jax_train_forward(f64["jm"], f64["variables"], f64["jbatch"],
                                                  backbone_train=False)
    pm = copy.deepcopy(f64["pm"])
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    labels = backbone_freeze_mask(n for n, _ in pm.named_parameters())
    assert labels == flax_labels(jax_freeze_mask(f64["variables"]["params"]), labels)
    state = TrainState(pm, cosine_lr_schedule(1e-3, 2, 1), labels=labels)
    m = train_step(state, f64["batch"], StepConfig(anchors=ANCHOR_T, backbone_train=False))
    np.testing.assert_allclose(float(m["loss"]), want_loss, rtol=GRAD_TOL)
    after = pm.state_dict()
    for k, v in before.items():
        if k.startswith("body."):
            assert torch.equal(after[k], v), k
    assert not torch.equal(after["neck.pan_head_8.pred.weight"], before["neck.pan_head_8.pred.weight"])
    assert all(not n.startswith("body.") for n in state.names)
    assert all(not p.requires_grad for n, p in pm.named_parameters() if n.startswith("body."))
    scale = max(float(v.abs().max()) for v in want_stats.values())
    leaves_close(after, want_stats, STEP_TOL, 1e-7 * scale, "stage-1 stats")


def flax_labels(jlabels, names):
    """The JAX label tree keyed by the port's parameter names."""
    flat = {".".join(p): v for p, v in _flatten(jlabels)}
    out = {}
    for n in names:
        *mods, leaf = n.split(".")
        leaf = {"weight": "scale" if mods[-1] == "bn" else "kernel"}.get(leaf, leaf)
        out[n] = flat[".".join(mods + [leaf])]
    return out


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@mobilenet_only
def test_stage1_truncate_block_freezes_up_to_the_block(f64):
    pm = copy.deepcopy(f64["pm"])
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    labels = backbone_freeze_mask((n for n, _ in pm.named_parameters()), upto_block=5)
    assert labels == flax_labels(jax_freeze_mask(f64["variables"]["params"], upto_block=5),
                                 labels)
    state = TrainState(pm, cosine_lr_schedule(1e-3, 2, 1), labels=labels)
    train_step(state, f64["batch"], StepConfig(anchors=ANCHOR_T, backbone_train=False))
    after = pm.state_dict()
    for n, label in labels.items():
        if label == FROZEN:
            assert torch.equal(after[n], before[n]), n
        elif n.endswith("conv.weight"):
            assert not torch.equal(after[n], before[n]), n
    assert any(labels[n] == FROZEN for n in labels if n.startswith("body.block_5."))
    assert all(labels[n] != FROZEN for n in labels if n.startswith("body.block_6."))
    for k in before:  # the body's statistics stay: backbone_train=False
        if k.startswith("body.") and k.endswith(("running_mean", "running_var")):
            assert torch.equal(after[k], before[k]), k


@mobilenet_only
def test_fgsm_updates_statistics_once(f64):
    plain, adv = copy.deepcopy(f64["pm"]), copy.deepcopy(f64["pm"])
    sched = cosine_lr_schedule(1e-3, 2, 1)
    mp_ = train_step(TrainState(plain, sched), f64["batch"], StepConfig(anchors=ANCHOR_T))
    ma = train_step(TrainState(adv, sched), f64["batch"],
                    StepConfig(anchors=ANCHOR_T, use_adv=True))
    assert torch.equal(ma["loss"], mp_["loss"])
    assert float(ma["loss_total"]) > float(ma["loss"])
    for k, v in plain.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert torch.equal(adv.state_dict()[k], v), k
    assert any(not torch.equal(adv.state_dict()[k], v)
               for k, v in plain.state_dict().items() if k.endswith("weight"))


@mobilenet_only
def test_remat_gives_the_plain_numbers(f64):
    plain, rem = copy.deepcopy(f64["pm"]), copy.deepcopy(f64["pm"])
    rem.remat = True
    sched = cosine_lr_schedule(1e-3, 2, 1)
    a = train_step(TrainState(plain, sched), f64["batch"], StepConfig(anchors=ANCHOR_T))
    b = train_step(TrainState(rem, sched), f64["batch"], StepConfig(anchors=ANCHOR_T))
    assert torch.equal(a["loss"], b["loss"])
    for k, v in plain.state_dict().items():
        torch.testing.assert_close(rem.state_dict()[k], v, rtol=1e-12, atol=1e-12, msg=k)


def test_cosine_schedule_equal_at_every_step():
    jax_s, port_s = jax_cosine(1e-3, 5, 3), cosine_lr_schedule(1e-3, 5, 3)
    got = [port_s(s) for s in range(20)]
    want = [float(jax_s(jnp.asarray(s))) for s in range(20)]
    assert got == want


@mobilenet_only
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_low_precision_step_matches_jax(f64, dtype):
    """One step at float32 or bfloat16 compute (float32 parameters and
    statistics): the loss within 1e-4 (float32) or 2e-2 (bfloat16)
    relative, the updated running statistics within 1e-4 or 5e-2 of
    their largest magnitude. The parameters are not held: the gradients
    of two low-precision computations differ by more than Adam's first
    step can hold (see the module docstring)."""
    tol = 1e-4 if dtype == "float32" else (2e-2, 5e-2)
    loss_tol, stat_tol = (tol, tol) if dtype == "float32" else tol
    jm, pm = at_dtype(f64["backbone"], f64["variables"], f64["pm"], getattr(jnp, dtype),
                      getattr(torch, dtype))
    jbatch = {k: jnp.asarray(np.asarray(v)) for k, v in f64["jbatch"].items()}
    want_loss, want_stats = jax_train_forward(jm, f64["variables"], jbatch)
    m = train_step(TrainState(pm, cosine_lr_schedule(1e-3, 2, 1)), f64["batch"],
                   StepConfig(anchors=ANCHOR_T))
    np.testing.assert_allclose(float(m["loss"]), want_loss, rtol=loss_tol)
    scale = max(float(v.abs().max()) for v in want_stats.values())
    leaves_close(pm.state_dict(), want_stats, 0, stat_tol * scale, f"{dtype} stats")
