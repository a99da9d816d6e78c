"""The training step. Port of ``yoloret_tpu/train/step.py``
(reference: code/yolo3/train.py:18-75).

One step runs the forward with every trainable BatchNorm on batch
statistics, the three-scale loss (``train/losses.py``), the backward,
the Adam update of the trainable parameters, the BatchNorm statistics
update, the optional EMA of the weights (decay 0.9999, warmed up by
``min(decay, (1 + t) / (10 + t))``) and the optional FGSM-style
adversarial term (multiplier 0.2, step 0.2, inf-norm).

Where the JAX step is one pure function of the state, the port's
``TrainState`` holds the model, whose parameters and BatchNorm buffers
it updates in place, the optimizer state of the trainable parameters,
the step and the EMA. The numbers follow optax: the learning rate is
the schedule at the update count before the increment, the bias
correction uses the count after it, ``eps`` is added outside the square
root, and the EMA ramp reads the step before the increment and averages
the new parameters. A step reads nothing back from the device: its
metrics stay device tensors.

In a process group (``parallel.mesh``) each rank runs the step on its
rows of the global batch: the train-mode BatchNorms take the global
batch's statistics (``nn/layers.py``), each rank's loss is its local sum
over its local batch size, and ``train_step`` replaces the gradients by
their mean over the ranks (one flat all-reduce a dtype), which is the
gradient of the JAX step's loss over the global batch because every
rank holds as many rows. The update then runs the same on every rank,
from the same state (``TrainState.broadcast``), so every rank ends the
step with the same bits. The reported losses are global means. The FGSM
image gradient needs no collective of its own: its sign does not depend
on the loss's scale.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from yoloret_tpu_torch.nn.layers import keep_stats
from yoloret_tpu_torch.parallel.mesh import all_reduce_mean_, broadcast_, in_group
from yoloret_tpu_torch.train.freeze import TRAINABLE
from yoloret_tpu_torch.train.losses import yolo_loss

Schedule = Callable[[int], float]


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """What the step's loss and update read."""

    anchors: Tuple[Tuple[float, float], ...]
    num_scales: int = 3
    ignore_thresh: float = 0.5
    box_loss: str = "giou"
    class_loss_kind: str = "bce"  # or "focal"
    backbone_train: bool = True  # False in stage 1 (frozen backbone BatchNorm)
    use_adv: bool = False  # adversarial regularization
    adv_multiplier: float = 0.2
    adv_step: float = 0.2
    ema_decay: float = 0.9999


def cosine_lr_schedule(base_lr: float, epochs: int, steps_per_epoch: int) -> Schedule:
    """Per-epoch cosine decay: ``base_lr / 2 * (1 + cos(pi * epoch /
    epochs))`` with epoch = min(step // steps_per_epoch, epochs), in
    float32 as the JAX schedule computes it."""
    f32 = np.float32

    def schedule(step: int) -> float:
        epoch = min(int(step) // steps_per_epoch, epochs)
        frac = f32(epoch) / f32(epochs)
        cos = f32(math.cos(float(f32(np.pi) * frac)))  # rounded as XLA rounds it
        return float(f32(base_lr * 0.5) * (f32(1.0) + cos))

    return schedule


class TrainState:
    """The model (parameters and BatchNorm buffers, updated in place), the
    Adam state (``mu``, ``nu``) of the parameters ``labels`` marks
    TRAINABLE (all of them when ``labels`` is None), the step count and,
    with ``use_ema``, the EMA of every parameter. Frozen parameters get
    no optimizer state, no update and no gradient."""

    b1, b2, eps = 0.9, 0.999, 1e-8  # optax.adam's defaults, eps as the reference sets it

    def __init__(self, model: torch.nn.Module, schedule: Schedule,
                 labels: Optional[Mapping[str, str]] = None, use_ema: bool = False):
        self.model = model
        self.schedule = schedule
        self.step = 0
        self.names = [n for n, _ in model.named_parameters()
                      if labels is None or labels[n] == TRAINABLE]
        keep = set(self.names)
        for n, p in model.named_parameters():
            p.requires_grad_(n in keep)
        params = dict(model.named_parameters())
        self.params = [params[n] for n in self.names]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.ema: Optional[Dict[str, torch.Tensor]] = (
            {n: p.detach().clone() for n, p in params.items()} if use_ema else None)

    # -- update --------------------------------------------------------------

    @torch.no_grad()
    def apply_gradients(self, grads: Sequence[torch.Tensor], ema_decay: float = 0.9999
                        ) -> None:
        """One Adam update of the trainable parameters with ``grads`` (in
        their order), then the EMA, then the step increment."""
        f32 = np.float32
        count = self.step + 1
        lr = self.schedule(self.step)
        # optax computes the bias corrections in float32, in float64 with
        # JAX's x64: the float64 reference's float64 parameters take that
        ft = np.float64 if self.params and self.params[0].dtype == torch.float64 else f32
        bc1 = float(ft(1.0) - ft(self.b1) ** ft(count))
        bc2 = float(ft(1.0) - ft(self.b2) ** ft(count))
        grads = list(grads)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, sq, alpha=1.0 - self.b2)
        den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)
        if self.ema is not None:
            t = f32(self.step)
            d = min(f32(ema_decay), (f32(1.0) + t) / (f32(10.0) + t))
            params = dict(self.model.named_parameters())
            ema = list(self.ema.values())
            torch._foreach_mul_(ema, float(d))
            torch._foreach_add_(ema, [params[n].detach() for n in self.ema],
                                alpha=float(f32(1.0) - d))
        self.step = count

    def broadcast(self, src: int = 0) -> None:
        """Every parameter, BatchNorm statistic, Adam moment and EMA
        parameter set to rank ``src``'s (a no-op without a process
        group): the start of a data-parallel run."""
        with torch.no_grad():
            broadcast_([*self.model.parameters(), *self.model.buffers(), *self.mu, *self.nu,
                        *(self.ema or {}).values()], src)

    # -- weights ---------------------------------------------------------------

    def eval_state_dict(self, use_ema: bool = False) -> Dict[str, torch.Tensor]:
        """The model's state dict, with the EMA parameters in place of the
        parameters when ``use_ema`` (the BatchNorm statistics stay the
        model's, as the JAX package evaluates EMA weights)."""
        sd = {k: v.detach() for k, v in self.model.state_dict().items()}
        if use_ema and self.ema is not None:
            sd.update(self.ema)
        return sd

    def state_dict(self) -> dict:
        """Everything a resumed run needs, as tensors and ints."""
        out = {"model": self.model.state_dict(), "step": self.step,
               "mu": dict(zip(self.names, self.mu)), "nu": dict(zip(self.names, self.nu))}
        if self.ema is not None:
            out["ema"] = self.ema
        return out

    @torch.no_grad()
    def load_state_dict(self, sd: Mapping) -> None:
        self.model.load_state_dict(sd["model"], strict=True)
        self.step = int(sd["step"])
        for mine, key in ((self.mu, "mu"), (self.nu, "nu")):
            for t, n in zip(mine, self.names):
                t.copy_(sd[key][n])
        if self.ema is not None and "ema" in sd:
            for n, t in self.ema.items():
                t.copy_(sd["ema"][n])


@functools.lru_cache(maxsize=8)
def _anchors_on(anchors: Tuple[Tuple[float, float], ...], device: torch.device) -> torch.Tensor:
    return torch.tensor(anchors, dtype=torch.float32, device=device)


def batch_loss(model, images, batch, cfg: StepConfig, train: bool, drop_seed: Optional[int]):
    """The loss of one batch: a forward (train mode, or inference), the
    three-scale loss; (total, per-scale parts)."""
    outs = model(images, train, cfg.backbone_train if train else False, drop_seed)
    return yolo_loss(
        outs, tuple(batch[f"y_true_{l}"] for l in range(cfg.num_scales)),
        batch["gt_boxes"], batch["gt_valid"], _anchors_on(cfg.anchors, images.device),
        num_scales=cfg.num_scales,
        ignore_thresh=cfg.ignore_thresh, box_loss=cfg.box_loss,
        class_loss_kind=cfg.class_loss_kind)


def _drop_seed(seed: int, step: int) -> int:
    """The drop-connect seed of one step (the JAX step folds the step
    into its dropout key)."""
    return (int(seed) * 1_000_003 + int(step)) % (2 ** 63)


def step_gradients(state: TrainState, batch: Mapping[str, torch.Tensor], cfg: StepConfig,
                   seed: int = 0) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """The forwards and the backward of one step, without the update: the
    gradients of the trainable parameters (in ``state.names``' order) and
    the step's losses as device scalars. The BatchNorm statistics are
    updated. ``batch``: images [B, H, W, 3] float32 in [0, 1],
    y_true_{0,1,2}, gt_boxes [B, T, 4], gt_valid [B, T].

    With ``use_adv`` three forwards run, all on the statistics from
    before the step: one for the input gradient, the clean one and the
    adversarial one. Only the clean forward updates the BatchNorm
    statistics, and the adversarial images are constants of the
    parameter gradient."""
    model = state.model
    images = batch["images"]
    ds = _drop_seed(seed, state.step)
    if cfg.use_adv:
        with keep_stats(model):
            x = images.detach().requires_grad_(True)
            g_img, = torch.autograd.grad(batch_loss(model, x, batch, cfg, True, ds)[0], x)
        adv_images = torch.clamp(images + cfg.adv_step * torch.sign(g_img), 0.0, 1.0)
        base, parts = batch_loss(model, images, batch, cfg, True, ds)
        with keep_stats(model):
            adv, _ = batch_loss(model, adv_images.detach(), batch, cfg, True, ds)
        total = base + cfg.adv_multiplier * adv
    else:
        base, parts = batch_loss(model, images, batch, cfg, True, ds)
        total = base
    grads = torch.autograd.grad(total, state.params, allow_unused=True,
                                materialize_grads=True)
    return list(grads), {
        "loss": base.detach(),
        "loss_total": total.detach(),
        "box_loss": sum(p.box for p in parts).detach(),
        "conf_loss": sum(p.confidence for p in parts).detach(),
        "class_loss": sum(p.classification for p in parts).detach(),
    }


def train_step(state: TrainState, batch: Mapping[str, torch.Tensor], cfg: StepConfig,
               seed: int = 0) -> Dict[str, torch.Tensor]:
    """One optimizer step (``step_gradients``, in a process group the
    gradients' and the losses' mean over the ranks, then the update);
    returns the step's losses as device scalars."""
    grads, metrics = step_gradients(state, batch, cfg, seed)
    if in_group():
        all_reduce_mean_(grads)
        metrics = mean_over_ranks_dict(metrics)
    state.apply_gradients(grads, cfg.ema_decay)
    return metrics


def mean_over_ranks_dict(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Scalar device tensors replaced by their means over the ranks, in
    one all-reduce."""
    keys = list(metrics)
    flat = torch.stack([metrics[k].detach() for k in keys])
    all_reduce_mean_([flat])
    return dict(zip(keys, flat.unbind()))


@torch.no_grad()
def eval_step(state: TrainState, batch: Mapping[str, torch.Tensor], cfg: StepConfig
              ) -> Dict[str, torch.Tensor]:
    """Validation loss with the running statistics (inference mode)."""
    total, _ = batch_loss(state.model, batch["images"], batch, cfg, False, None)
    return {"val_loss": total}
