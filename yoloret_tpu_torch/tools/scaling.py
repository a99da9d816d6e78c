"""Scaling accounting of the data-parallel programs. Port of
``yoloret_tpu/tools/scaling.py``.

For world sizes 1 (no process group: the one-device program) and n (a
process group of n ranks on the given devices), a row a rank, one train
step of the stage-2 configuration (every parameter
trainable, EMA off; MobileNetV2 x0.75, 20 classes) reports:

  * the FLOPs of a rank (``torch.utils.flop_counter.FlopCounterMode``):
    weak scaling keeps them constant as the world grows;
  * the payload bytes of every collective of the step by kind, counted
    where the port hands a tensor to the process group
    (``parallel.mesh.count_collectives``): the gradient all-reduce (the
    trainable parameters' bytes), the BatchNorm statistics' all-reduces
    in the forward and the backward, and the losses' mean;
  * the trainable parameter bytes;
  * the collective bytes of the serving program (``Predictor(mesh=)``
    over n replicas): zero, the replicas share nothing.

It projects nothing onto a multi-GPU interconnect: that waits for a
machine with more than one card. Run:

    python -m yoloret_tpu_torch.tools.scaling --device cpu --world 2
    python -m yoloret_tpu_torch.tools.scaling --device cuda --world 2   # ranks share cuda:0

(ranks on one CUDA device meet over gloo: NCCL refuses two ranks on one
GPU). Prints one ``SCALING_RESULT`` JSON line a world size.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from yoloret_tpu_torch.parallel.mesh import (
    count_collectives,
    in_group,
    make_mesh,
    rank,
    spawn,
    world,
)

ANCHORS = np.asarray([[10, 13], [16, 30], [33, 23], [30, 61], [62, 45],
                      [59, 119], [116, 90], [156, 198], [373, 326]], np.float32)
NUM_CLASSES = 20
PROJECTION = ("projection to a multi-GPU interconnect: not made; it waits for a machine with "
              "more than one card")


def _batch(size: int, device: torch.device, seed: int) -> dict:
    """This rank's row of a seeded global batch of a row a rank (one box
    an image)."""
    from yoloret_tpu_torch.ops.targets import assign_targets_batch, true_corner_boxes

    rs = np.random.RandomState(seed)
    images = rs.rand(world(), size, size, 3).astype(np.float32)[rank():rank() + 1]
    boxes = torch.zeros(1, 20, 5, device=device)
    boxes[:, 0, :4] = torch.tensor([8.0, 8.0, size * 0.6, size * 0.6])
    ys = assign_targets_batch(boxes, (size, size), torch.as_tensor(ANCHORS, device=device),
                              NUM_CLASSES, 3)
    gt, gt_valid = true_corner_boxes(boxes, (size, size))
    return {"images": torch.as_tensor(images, device=device), "gt_boxes": gt,
            "gt_valid": gt_valid, **{f"y_true_{l}": ys[l] for l in range(3)}}


def measure(device: torch.device, size: int = 64) -> dict:
    """One rank's accounting of one train step and one serving batch of a
    row a rank (run in every rank of a group, or alone)."""
    from torch.utils.flop_counter import FlopCounterMode

    from yoloret_tpu_torch.infer.predictor import Predictor
    from yoloret_tpu_torch.nn.detector import YoloReT
    from yoloret_tpu_torch.nn.layers import init_weights
    from yoloret_tpu_torch.train.step import StepConfig, TrainState, train_step

    model = YoloReT("mobilenetv2x75", num_classes=NUM_CLASSES)
    init_weights(model, torch.Generator().manual_seed(0))
    model.to(device)
    state = TrainState(model, lambda step: 1e-3)
    state.broadcast()
    cfg = StepConfig(anchors=tuple(map(tuple, ANCHORS.tolist())))
    batch = _batch(size, device, seed=0)
    train_step(state, batch, cfg)  # warm-up: lazy inits out of the counts
    with count_collectives() as coll, FlopCounterMode(display=False) as flops:
        train_step(state, batch, cfg)
    param_bytes = sum(p.numel() * p.element_size() for p in state.params)

    out = {"world": world(), "size": size,
           "train_flops_per_rank": int(flops.get_total_flops()),
           "train_collective_bytes": dict(coll), "param_bytes": int(param_bytes)}
    if rank() == 0:
        # the serving program: one process, a replica a rank's device
        mesh = make_mesh([device] * world())
        pred = Predictor(weights={k: v.detach().cpu() for k, v in model.state_dict().items()},
                         class_names=[str(i) for i in range(NUM_CLASSES)], anchors=ANCHORS,
                         input_hw=(size, size), bf16=False, device=device,
                         mesh=mesh if world() > 1 else None)
        images = torch.zeros(world(), size, size, 3, dtype=torch.uint8, device=device)
        hw = torch.full((images.shape[0], 2), float(size), device=device)
        with count_collectives() as serve:
            pred.infer(images, hw)
        out["serve_collective_bytes"] = dict(serve)
    return out


def data_parallel_steps(device: torch.device, weights: Optional[dict], batch: dict, steps: int,
                        out_path: str, num_classes: int = NUM_CLASSES,
                        start: Optional[dict] = None, horizon: Optional[int] = None) -> None:
    """``steps`` float64 train steps of MobileNetV2 x0.75 (the parameters,
    the compute and the loss in float64: an exact reference; stage 2, EMA
    on, Adam at a cosine schedule of 1e-3 over ``horizon`` epochs of one
    step, default: the steps taken) from ``weights`` (a CPU state dict),
    or from ``start`` (a ``TrainState.state_dict()``), on this rank's rows
    of the global ``batch`` (CPU tensors; all of it without a process
    group). Writes ``<out_path>.rank<r>``: the state
    (``TrainState.state_dict``) after each step (rank 0; the others the
    last), each step's averaged gradients and losses, on the CPU. The same
    call in n ranks and alone gives the data-parallel steps and the
    one-process steps on the global batch."""
    from yoloret_tpu_torch.nn.detector import YoloReT
    from yoloret_tpu_torch.train.step import StepConfig, TrainState, cosine_lr_schedule, train_step

    model = YoloReT("mobilenetv2x75", num_classes=num_classes, dtype=torch.float64).double()
    model.load_state_dict(weights if start is None else start["model"])
    model.to(device)
    first = 0 if start is None else int(start["step"])
    state = TrainState(model, cosine_lr_schedule(1e-3, horizon or first + steps, 1),
                       use_ema=True)
    if start is not None:
        state.load_state_dict(start)
    state.broadcast()
    grads = []
    apply = state.apply_gradients

    def record(g, decay):
        grads.append({n: t.detach().cpu().clone() for n, t in zip(state.names, g)})
        apply(g, decay)

    state.apply_gradients = record
    n, r = world(), rank()
    k = next(iter(batch.values())).shape[0] // n
    local = {key: (v.double() if v.is_floating_point() else v)[r * k:(r + 1) * k].to(device)
             for key, v in batch.items()}
    cfg = StepConfig(anchors=tuple(map(tuple, ANCHORS.tolist())))
    metrics, states = [], []
    for i in range(steps):
        metrics.append({key: float(v) for key, v in train_step(state, local, cfg).items()})
        if r == 0 or i == steps - 1:
            states.append(_to_cpu(state.state_dict()))
    torch.save({"states": states, "grads": grads, "metrics": metrics}, f"{out_path}.rank{r}")


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def _rank_main(device: torch.device, path: str, size: int) -> None:
    out = measure(device, size)
    if rank() == 0:
        with open(path, "w") as f:
            json.dump(out, f)


def analyze(world_size: int, device: str = "cpu", size: int = 64) -> dict:
    """The accounting at ``world_size``: in this process without a group
    for 1, else in ``world_size`` spawned ranks on ``device``."""
    if world_size == 1:
        if in_group():
            raise RuntimeError("world size 1 is the program without a process group")
        return measure(torch.device(device), size)
    with tempfile.TemporaryDirectory(prefix="yoloret-scaling-") as tmp:
        path = os.path.join(tmp, "rank0.json")
        spawn(_rank_main, make_mesh([device] * world_size), (path, size),
              store_path=os.path.join(tmp, "store"))
        with open(path) as f:
            return json.load(f)


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda")
    p.add_argument("--world", type=int, nargs="+", default=[1, 2],
                   help="world sizes (1: no process group)")
    p.add_argument("--input", type=int, default=64)
    a = p.parse_args(argv)
    rows = []
    for n in a.world:
        r = analyze(n, a.device, a.input)
        rows.append(r)
        train = sum(r["train_collective_bytes"].values())
        print(f"world={n}: train FLOPs/rank={r['train_flops_per_rank']:.4e} "
              f"collectives={train} B ({train / r['param_bytes']:.4f}x the "
              f"{r['param_bytes']} B of trainable parameters) "
              f"serve collectives={sum(r['serve_collective_bytes'].values())} B", flush=True)
        print("SCALING_RESULT " + json.dumps(r), flush=True)
    print(PROJECTION)
    return rows


if __name__ == "__main__":
    main()
