#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``yoloret_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero and prints no result):

1. The card's name and power limit (``nvidia-smi``); build both CUDA
   kernels from ``yoloret_tpu_torch/csrc/`` (one ``nvcc`` each, in
   parallel) and print each kernel's ``ptxas`` registers and spills.
2. Each kernel against its plain PyTorch version on the card, at the
   serving path's shapes: the fused MBConv at all 16 backbone blocks of
   MobileNetV2 x0.75 @ 320 (float32 with TF32 off at b2; bfloat16, the
   Hopper kernel on the packed weights, at b2 and at b128, where the
   work items outnumber the persistent CTAs); the suppression kernels,
   exactly: the shared-pool kernel on model candidates at C=20, M=64
   (t=0.3) and M=512 (t=0) for B=128, 8 and 1, on tied scores and on
   pairs at IoU 0.5; the per-class kernel on per-class pools; the
   large-pool kernel on the exact evaluation's per-class pools (model
   candidates, K=6300, B=128 and 1) and on tied scores with pairs at IoU
   0.5.
3. The serving slice through its entry points, with seeded weights
   (BatchNorm calibrated on seeded images, so scores are not all ties): ``Predictor.detect_arrays``
   on 1, 8 and 130 images, the HTTP ``DetectionServer`` on 4 JPEGs, and
   a MAP-grade request. The launch counters must show 16 MBConv launches
   and 1 NMS launch per forward. The float32 Predictor on the card must
   agree with the same Predictor on the CPU (plain versions) on 2 images.
4. Times: serving (t=0.3, M=64) and MAP grade (t=0, M=512) img/s at
   batch 128 with CUDA events.
5. The VOC mAP evaluation path: a seeded synthetic dataset in a
   temporary directory (JPEGs of mixed sizes and aspect ratios, a text
   list and a TFRecord shard of the same images), its ground truth the
   port's own float32 detections on the CPU through the eval pipeline;
   the CPU runs of ``evaluate_map``, float32 and bf16, are the
   references. On the card, with the launch counts set to 0 just before
   and read just after: ``evaluate_map`` float32 shared pool (M=512),
   the CLI's ``--mode=MAP --exact_nms`` float32 (per-class pools of the
   whole grid, the large-pool NMS kernel) and ``evaluate_map`` bf16
   shared. 16 MBConv launches and 1 NMS launch per batch; the float32
   runs' per-class APs within EVAL_AP_TOL of the CPU's float32 ones,
   the bf16 run's mAP within EVAL_BF16_MAP_TOL of the CPU's bf16 one.
   Then the bf16 run again under the
   profiler: the device's idle share of the eval loop; and the host's
   two shares alone: the decode, and the evaluator's filing.
6. Each kernel's device time (L2 flushed, the device kept behind the
   host) beside its plain version, a library yardstick and its bound
   (bytes at 3.35 TB/s, operations at the peak rate of their type); per
   MBConv block also the tile plan (tile, warpgroups, pipeline stages,
   persistent grid, shared memory); NMS at the serving and the MAP-grade
   shape, each with its launch plan, and the large-pool variant at the
   exact evaluation's shape.
7. The paper's two COCO configurations, at full width and depth, 80
   classes (``configs/coco_mobilenetv2x14_224.yaml``,
   ``configs/coco_efficientnetb3_416.yaml``; class names and anchors from
   the files they name), each with seeded, calibrated weights: for
   MobileNetV2 x1.4 @224 the MBConv kernel against its plain version at
   all 16 blocks (float32 b2, bf16 b2 and b128, the tile plan of each
   block and the ptxas line of the NB=11 instance its Cout 136 and 224
   take); for both, the suppression kernels exactly on model candidates
   (shared pool M=64 and M=512 at B=128, 8 and 1; the large-pool kernel
   on the exact evaluation's whole grid, K=3,087 and 10,647, at B=128 and
   1); ``detect_arrays`` on 1, 8 and 130 images (and the HTTP server for
   x1.4) with the launch counts set to 0 just before and read just after
   (x1.4: 16 MBConv + 1 NMS a forward; B3: 0 + 1); float32 card vs CPU
   on 2 images; serving and MAP-grade img/s with the profiler's split;
   the mAP evaluation on a small seeded set (``evaluate_map`` float32 and
   bf16, the CLI's ``--config=... --mode=MAP --exact_nms`` float32), the
   float32 per-class APs within EVAL_AP_TOL of the CPU's; and each
   kernel's time at these shapes.
8. The rest of the backbone registry at 320, b8 (MobileNetV2 x1.0,
   EfficientNet-B0, DarkNet-53, x0.75 with RFCR ``concat`` and ``none``,
   YOLO-Nano, Yolo-Fastest and -XL): one ``detect_arrays`` call each with
   its launch counts, and float32 card vs CPU on 2 images (the raw heads;
   for a MobileNetV2 also the detections).

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense: bytes/s of HBM3, FLOP/s by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}
ANCHORS = [[10, 13], [16, 30], [33, 23], [30, 61], [62, 45],
           [59, 119], [116, 90], [156, 198], [373, 326]]
NUM_CLASSES = 20
DEVICE = "cuda"  # the card; nothing in this script falls back to the CPU
SIZE = 320
BATCH = 128
MBCONV_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # atol = rtol
# float32 operations of one IoU and its threshold test (2 min, 2 max,
# 2 subtractions, 2 clamps, a product, the union's add and subtract, a
# compare), and of one argmax step per candidate per round (nms_bound_ms)
NMS_IOU_OPS = 12
NMS_ARGMAX_OPS = 1
# the per-class count, for comparison with earlier records: every class's
# IoUs in every round, 16 operations per candidate per round
NMS_OPS_PER_CLASS_PAIR = 16
SLEEP_CYCLES = 1_000_000  # ~0.5 ms of GPU spin before each timed window


def exact_k(size: int) -> int:
    """--exact_nms's per-class pool: every position of the grid at size."""
    return sum((size // s) ** 2 * 3 for s in (32, 16, 8))


EXACT_K = exact_k(SIZE)
EVAL_IMAGES = 256  # distinct JPEGs; the text list and the TFRecord shard hold each once
EVAL_GT_PER_IMAGE = 3
# Largest per-class AP difference allowed between a float32 run on the
# card and the float32 run on the CPU: the same detections up to float32
# rounding (and, for --exact_nms, the low-scoring ones a per-class pool
# adds), so only a few swaps in the ranking of near-tied scores, each
# worth under 0.02 of a class's AP with ~77 ground-truth boxes a class.
EVAL_AP_TOL = 0.02
# Largest mAP difference allowed between the bf16 run on the card and the
# bf16 run on the CPU. The MBConv kernel rounds to bf16 at its plain
# version's points, but the sums run in another order, and the other
# layers are the card's and the CPU's own bf16 convolutions: a logit may
# differ by a bf16 ulp (2^-8 of it), so near-tied scores swap. bf16 finds
# few of the float32 ground-truth boxes (mAP ~0.07), so one swap of a
# true and a false detection can move a class's AP by a whole match
# (1/7 in the seed-0 run): the per-class APs are logged, not held, and
# their mean over the 20 classes is held to about three such swaps.
EVAL_BF16_MAP_TOL = 0.02
# The paper's COCO configurations (phase 7): name -> config file. Their
# evaluation set is smaller (COCO_EVAL_IMAGES JPEGs, one b128 batch on the
# card) and the CPU references run at CPU_EVAL_BATCH: the CPU pays for the
# padded rows of a final batch, and B3 @416 costs ~10x x0.75 @320 a row.
COCO_CONFIGS = {
    "mobilenetv2x14_224": "configs/coco_mobilenetv2x14_224.yaml",
    "efficientnetb3_416": "configs/coco_efficientnetb3_416.yaml",
}
COCO_EVAL_IMAGES = 64
CPU_EVAL_BATCH = 16
# The rest of the registry (phase 8), as (backbone, rfcr), at REGISTRY_SIZE
# and batch REGISTRY_BATCH, NUM_CLASSES classes.
REGISTRY_RUNS = (("mobilenetv2x10", "weighted_sum"), ("efficientnetb0", "weighted_sum"),
                 ("darknet53", "weighted_sum"), ("mobilenetv2x75", "concat"),
                 ("mobilenetv2x75", "none"), ("yolo_nano", "weighted_sum"),
                 ("yolo_fastest", "weighted_sum"), ("yolo_fastest_xl", "weighted_sum"))
REGISTRY_SIZE = 320
REGISTRY_BATCH = 8
# The registry's float32 card-vs-CPU check of the raw heads: largest
# difference over the largest |head|. A body with no kernel of the port
# in its forward is held by its heads alone: its detections can differ
# where two boxes overlap at IoU ~0.5, so one NMS decision flips on a
# rounding. YOLO-Nano's seeded boxes are such slivers, a pixel high and
# hundreds wide, and its heads move between two batch sizes on the CPU
# alone: its FCA's global mean is summed in another order and its ~30
# residual blocks grow that difference some hundredfold.
HEADS_RTOL = 1e-3


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_lines(text):
    """The registers, shared memory and spill lines of a ``-Xptxas -v``
    log, each with its kernel (template arguments spelled out). Dynamic
    shared memory is not in the log: the plans print it."""
    out, fn = [], ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(mbconv_wgmma|mbconv_f32|nms_kernel|nms_shared)I((?:Li\d+E)+)E",
                          m.group(1))
            fn = f"{k.group(1)}<{','.join(re.findall(r'Li(\d+)E', k.group(2)))}>" if k else ""
            fn = fn or ("nms_large" if "nms_large" in m.group(1) else "")
        elif re.search(r"Used \d+ registers|spill stores", line):
            out.append(f"{fn + ': ' if fn else ''}{line.split(':', 1)[-1].strip()}")
    return out


def cuda_time_ms(fn, iters=10, warmup=2, flush=None):
    """Mean device ms of ``fn`` over ``iters`` calls, each between CUDA
    events. ``flush`` (kernel timings) evicts L2 first and then queues a
    GPU sleep, so the device is still behind the host when the window
    opens and it holds the kernel's device time, not the wrapper's host
    path; end-to-end timings pass no flush and include the host."""
    import torch

    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
            torch.cuda._sleep(SLEEP_CYCLES)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


# -- phase 2/4 helpers ---------------------------------------------------


def block_inputs(pred, batch, seed):
    """Input of each of the 16 blocks for ``batch`` seeded images, run
    through the kernel path itself (real activation statistics)."""
    import torch

    from yoloret_tpu_torch.nn.layers import conv2d_same, relu6
    from yoloret_tpu_torch.ops.mbconv import fused_mbconv

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.rand((batch, *pred.input_hw, 3), generator=g, device=DEVICE).to(pred.model.dtype)
    ks, bs = pred._fused.stem
    x = relu6(conv2d_same(x, ks, bs, stride=2)).contiguous()
    ins = []
    for meta in pred._fused.blocks:
        ins.append(x)
        x = fused_mbconv(x, *meta.args, stride=meta.stride, residual=meta.residual,
                         packed=meta.packed)
    return ins


def library_mbconv(x, we, be, wd, bd, wp, bp, stride, residual):
    """cuDNN yardstick: the block as three ``F.conv2d`` calls (channels-last),
    bias and clamp fused by nothing. Timed only, never used by the port."""
    import torch.nn.functional as F

    xc = x.permute(0, 3, 1, 2)
    y = xc
    if we is not None:
        y = F.conv2d(y, we.t()[:, :, None, None], be.to(x.dtype)).clamp_(0, 6)
    pad = (1, 1, 1, 1) if stride == 1 else (0, 1, 0, 1)
    y = F.conv2d(F.pad(y, pad), wd.permute(2, 0, 1)[:, None], bd.to(x.dtype), stride,
                 groups=wd.shape[-1]).clamp_(0, 6)
    y = F.conv2d(y, wp.t()[:, :, None, None], bp.to(x.dtype))
    return (y + xc) if residual else y


def mbconv_bound(x, meta, elem):
    b, h, w, cin = x.shape
    we, _, wd, _, wp, _ = meta.args
    ce, cout = wd.shape[-1], wp.shape[-1]
    ho, wo = h // meta.stride, w // meta.stride
    weight_bytes = sum(t.numel() * t.element_size() for t in meta.args if t is not None)
    nbytes = (b * h * w * cin + b * ho * wo * cout) * elem + weight_bytes
    flops = 2 * b * ((h * w * cin * ce if we is not None else 0) + ho * wo * ce * 9
                     + ho * wo * ce * cout)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_OPS["bf16"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def nms_bound_ms(boxes, scores, out_boxes, out_scores, max_det):
    """Least time of the function on this run's data. Bytes: scores, boxes
    and outputs once. Operations: one IoU (NMS_IOU_OPS) per (image,
    distinct picked box, candidate) -- greedy NMS needs no other IoU, and a
    shared pool's classes share them -- plus NMS_ARGMAX_OPS per candidate
    for each round, (picks + a final empty round, capped at max_det) per
    (image, class); float32 peak. Also returns the bound by the per-class
    count (every class's IoUs, NMS_OPS_PER_CLASS_PAIR per candidate per
    round)."""
    import torch

    picked = out_scores > 0
    picks = picked.sum(-1)
    rounds = (picks + (picks < max_det).long()).sum().item()
    m = scores.shape[-1]
    if boxes.dim() == 3:  # shared pool: a box picked by several classes counts once
        distinct = sum(int(torch.unique(out_boxes[i][picked[i]], dim=0).shape[0])
                       for i in range(len(boxes)) if picked[i].any())
    else:
        distinct = int(picks.sum())
    ops = distinct * m * NMS_IOU_OPS + rounds * m * NMS_ARGMAX_OPS
    nbytes = (scores.numel() + boxes.numel() + out_scores.numel() * 5) * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["f32"]
    per_class = max(t_bytes, rounds * m * NMS_OPS_PER_CLASS_PAIR / PEAK_OPS["f32"]) * 1e3
    return (max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"),
            dict(distinct_picks=distinct, rounds=rounds, ops=ops, bytes=nbytes,
                 bound_ms_per_class_count=per_class))


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item() if a.numel() else 0.0


# -- phases ----------------------------------------------------------------


def make_predictor(seed, weights=None, *, size=None, class_names=None, mixed=False, **kw):
    """Serving Predictor on the card. Without ``weights``: seeded init,
    then BatchNorm calibrated on 8 seeded images of uniform noise (with
    ``mixed``, 4 of them and 4 wave images, as the eval set draws).
    Calibration does what the x4 head-kernel amplification of
    tests/test_export.py does for uncalibrated weights -- input-dependent,
    distinct scores instead of ties at 0.25 -- and the x4 on top of it
    would saturate the logits (std ~6, 0.3% of scores exactly 1.0, i.e.
    ties again). EfficientNet-B3 calibrated on noise alone saturates on
    the wave images: most of its eval scores round to 1.0 and tie, and
    float32 rounding then picks other boxes (two CPU batch sizes share
    under a quarter of their picks); calibrated on the mix, its picks
    are as stable as MobileNetV2 x1.4's."""
    import numpy as np
    import torch

    from yoloret_tpu_torch.infer import Predictor
    from yoloret_tpu_torch.nn.layers import calibrate_bn

    names = class_names or [f"class_{i}" for i in range(NUM_CLASSES)]
    size = size or SIZE
    pred = Predictor(class_names=names, anchors=ANCHORS, input_hw=(size, size), seed=seed,
                     weights=weights, device=DEVICE, **kw)
    if weights is None:
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        images = torch.rand((8, size, size, 3), generator=g, device=DEVICE)
        if mixed:
            rs = np.random.RandomState(seed)
            waves = np.stack([wave_image(rs, size, size) for _ in range(4)])
            images[4:] = torch.from_numpy(waves).to(DEVICE).float() / 255.0
        calibrate_bn(pred.model, images)
        pred.refresh()
    return pred


def check_mbconv(pred, report, key="mbconv_check"):
    import torch

    from yoloret_tpu_torch.nn.fused_infer import _block_meta
    from yoloret_tpu_torch.ops.mbconv import fused_mbconv, reference_mbconv

    rows = []
    # float32 (CUDA-core kernel) at b2; bfloat16 (Hopper kernel, on the
    # packed weights of the main path) at b2 and at b128, where the work
    # items outnumber the persistent CTAs
    for dtype, batch in ((torch.float32, 2), (torch.bfloat16, 2), (torch.bfloat16, BATCH)):
        metas = _block_meta(pred.model.body, dtype)
        ins = block_inputs(pred, batch, seed=11)
        for meta, x in zip(metas, ins):
            x = x.to(dtype)
            kw = dict(stride=meta.stride, residual=meta.residual)
            got = fused_mbconv(x, *meta.args, packed=meta.packed, **kw)
            want = reference_mbconv(x, *meta.args, **kw)
            torch.cuda.synchronize()
            tol = MBCONV_TOL[str(dtype).split(".")[-1]]
            err = max_err(got, want)
            ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
            rows.append(dict(block=meta.block_id, dtype=str(dtype), batch=batch,
                             shape=list(x.shape), stride=meta.stride, max_abs_err=err, tol=tol,
                             ok=ok, max_abs_ref=want.float().abs().max().item()))
            if not ok:
                raise AssertionError(f"mbconv block {meta.block_id} {dtype} b{batch}: "
                                     f"max err {err}")
        del ins
    report[key] = rows
    worst = {f"{d} b{n}": max(r["max_abs_err"] for r in rows
                              if r["dtype"] == d and r["batch"] == n)
             for d, n in (("torch.float32", 2), ("torch.bfloat16", 2),
                          ("torch.bfloat16", BATCH))}
    scale = min(r["max_abs_ref"] for r in rows)
    log(f"mbconv kernel vs plain, {pred.model.backbone} @{pred.input_hw[0]}, "
        f"{len(pred._fused.blocks)} blocks x (float32 b2, bfloat16 b2, bfloat16 b{BATCH}): "
        f"max abs err {worst} (tolerance atol=rtol {MBCONV_TOL}; smallest block max |out| "
        f"{scale:.3g})")
    if scale < 0.1:
        raise AssertionError(f"block outputs too small ({scale}) for the check to mean much")
    return max(worst.values())


def candidates_at_b128(pred, k, seed, per_class=False):
    """The NMS inputs of BATCH seeded images through the kernel path: the
    shared pool of ``k`` (boxes [B, k, 4]) or, with ``per_class``, per-class
    pools of ``k`` (boxes [B, C, k, 4]); scores [B, C, k]."""
    import torch

    from yoloret_tpu_torch.nn.fused_infer import fused_detector_apply
    from yoloret_tpu_torch.ops.postprocess import per_class_candidates, shared_pool_candidates

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    images = torch.randint(0, 256, (BATCH, *pred.input_hw, 3), generator=g, device=DEVICE,
                           dtype=torch.uint8)
    hw = torch.full((BATCH, 2), float(pred.input_hw[0]), device=DEVICE)
    pool = per_class_candidates if per_class else shared_pool_candidates
    with torch.inference_mode():
        outs = fused_detector_apply(pred.model, images.float() / 255.0, pred._fused)
        return pool(outs, pred._anchors_t, len(pred.class_names), hw, num_candidates=k)


def nms_cases(pred, synthetic=True):
    """(name, boxes, scores, score threshold, empty score) of every NMS
    check: model candidates of the serving and the MAP-grade shape at
    B=128, 8 and 1; the exact evaluation's per-class pools of the whole
    grid (large-pool kernel, empty slots -inf as on that path) at B=128
    and 1; with ``synthetic``, also tied scores; pairs at IoU 0.5, exactly
    and within rounding; per-class pools; and large pools of tied scores
    and pairs at IoU 0.5."""
    import numpy as np
    import torch

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(DEVICE)

    cases = []
    for m, thr in ((64, 0.3), (512, 0.0)):
        boxes, scores = candidates_at_b128(pred, m, seed=m)
        for b in (BATCH, 8, 1):
            cases.append((f"shared b{b} C={scores.shape[1]} M={m} t={thr} (model candidates)",
                          boxes[:b].contiguous(), scores[:b].contiguous(), thr, 0.0))
    del boxes, scores
    big_k = exact_k(pred.input_hw[0])
    boxes, scores = candidates_at_b128(pred, big_k, seed=7, per_class=True)
    for b in (BATCH, 1):
        cases.append((f"per-class b{b} C={scores.shape[1]} K={big_k} t=0 (model candidates, "
                      "the --exact_nms pools)", boxes[:b].contiguous(), scores[:b].contiguous(),
                      0.0, float("-inf")))
    del boxes, scores
    if not synthetic:
        return cases
    rs = np.random.RandomState(5)
    k = 512
    yx = rs.randint(0, SIZE, (BATCH, k, 2))
    boxes = np.concatenate([yx, yx + rs.randint(8, 80, (BATCH, k, 2))], -1)
    cases.append((f"shared b{BATCH} M={k} t=0.25 (tied scores in eighths, integer boxes)",
                  dev(boxes), dev(rs.randint(0, 9, (BATCH, NUM_CLASSES, k)) / 8), 0.25, 0.0))
    p = np.arange(32)
    y0, x0 = 40.0 * (p // 8), 40.0 * (p % 8)
    side = np.where(p < 16, 1 + p % 5, 0.1 * (p + 1))  # exact 0.5, then 0.5 by rounding
    big = np.stack([y0, x0, y0 + side, x0 + 2 * side], -1)
    small = np.stack([y0, x0, y0 + side, x0 + side], -1)
    pairs = np.stack([big, small], 1).reshape(64, 4).astype(np.float32)
    scores = rs.permutation(BATCH * NUM_CLASSES * 64).reshape(BATCH, NUM_CLASSES, 64)
    cases.append((f"shared b{BATCH} M=64 t=0 (32 pairs at IoU 0.5)",
                  dev(np.repeat(pairs[None], BATCH, 0)), dev(scores / scores.size), 0.0, 0.0))
    b = rs.rand(BATCH, NUM_CLASSES, k, 4).astype(np.float32) * SIZE
    b[..., 2:] = b[..., :2] + rs.rand(BATCH, NUM_CLASSES, k, 2).astype(np.float32) * 80
    s = rs.permutation(BATCH * NUM_CLASSES * k).reshape(BATCH, NUM_CLASSES, k)
    cases.append((f"per-class b{BATCH} K={k} t=0.3 (random)", dev(b), dev(s / s.size), 0.3, 0.0))
    b, c = 8, NUM_CLASSES
    yx = rs.randint(0, SIZE // 8, (b, c, EXACT_K, 2))
    big = np.concatenate([yx, yx + rs.randint(1, 9, (b, c, EXACT_K, 2))], -1).astype(np.float32)
    big[:, :, :len(pairs)] = pairs
    cases.append((f"per-class b{b} K={EXACT_K} t=0.25 (tied scores in eighths, integer boxes, "
                  "32 pairs at IoU 0.5)", dev(big), dev(rs.randint(0, 9, (b, c, EXACT_K)) / 8),
                  0.25, float("-inf")))
    return cases


def check_nms(pred, report, synthetic=True):
    import torch

    from yoloret_tpu_torch.ops.nms_kernel import plan_nms, suppress, suppress_plain

    rows, worst = [], {"small": 0.0, "large": 0.0}
    for name, boxes, scores, thr, empty in nms_cases(pred, synthetic):
        plan = plan_nms(scores.shape[1], scores.shape[2], 20, boxes.dim() == 3)
        kw = dict(max_det=20, iou_threshold=0.5, score_threshold=thr, empty_score=empty)
        got = suppress(boxes, scores, **kw)
        want = suppress_plain(boxes, scores, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        err = 0.0 if same else max(max_err(torch.nan_to_num(g), torch.nan_to_num(w))
                                   for g, w in zip(got, want))
        dets = int((got[1] > 0).sum())
        rows.append(dict(case=name, plan=plan._asdict(), max_abs_err=err, exact=same,
                         detections=dets))
        how = {"shared": f"shared-pool kernel ({plan.warps} warps, {plan.classes_per_pass} "
                         f"classes per pass, {plan.smem} B shared memory)",
               "per_class": "per-class kernel (a warp per image and class)",
               "per_class_large": f"large-pool kernel (a CTA of {plan.warps} warps per image "
                                  f"and class, {plan.smem} B shared memory)"}[plan.variant]
        log(f"nms kernel vs plain, {name}: {how}: max abs err {err} (tolerance 0: exact), "
            f"{dets} detections")
        if not same:
            raise AssertionError(f"nms {name}: kernel differs from plain by {err}")
        key = "large" if plan.variant == "per_class_large" else "small"
        worst[key] = max(worst[key], err)
    report["nms_check"] = rows
    return worst


def drive_main_path(pred, map_pred, seed, report, mbconv_per_forward=16, http=True):
    """The serving slice through its entry points, with the launch counts
    set to 0 just before and read just after: ``mbconv_per_forward`` MBConv
    launches (16 for a MobileNetV2 backbone, 0 for any other) and 1 NMS
    launch a forward. ``http``: also 4 JPEGs through the HTTP server."""
    import numpy as np
    from PIL import Image

    from yoloret_tpu_torch.ops.mbconv import fused_mbconv
    from yoloret_tpu_torch.ops.nms_kernel import plan_nms, suppress
    from yoloret_tpu_torch.serve import DetectionServer

    rs = np.random.RandomState(seed)

    def images(n):
        return [rs.randint(0, 256, (int(rs.randint(200, 500)), int(rs.randint(200, 500)), 3),
                           dtype=np.uint8) for _ in range(n)]

    requests = [images(n) for n in (1, 8, 130)]
    jpegs = []
    for im in images(4 if http else 0):
        buf = io.BytesIO()
        Image.fromarray(im).save(buf, format="JPEG")
        jpegs.append(buf.getvalue())
    map_request = images(8)

    fused_mbconv.launches = suppress.launches = 0
    pred.forwards = map_pred.forwards = 0
    t0 = time.perf_counter()
    counts = []
    for req in requests:
        dets = pred.detect_arrays(req)
        assert len(dets) == len(req), (len(dets), len(req))
        for im, d in zip(req, dets):
            for det in d:
                x1, y1, x2, y2 = det.box
                assert all(np.isfinite(det.box)) and 0 < det.score <= 1
                assert 0 <= x1 <= x2 <= im.shape[1] and 0 <= y1 <= y2 <= im.shape[0], det
        counts.append(sum(len(d) for d in dets))

    replies = [None] * len(jpegs)

    def post(i):
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/detect", data=jpegs[i],
                                     headers={"Content-Type": "image/jpeg"}, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            replies[i] = (r.status, json.loads(r.read()))

    if http:
        server = DetectionServer(pred, host="127.0.0.1", port=0, max_batch=8)
        server.start(block=False)
        try:
            threads = [threading.Thread(target=post, args=(i,)) for i in range(len(jpegs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=180)
            assert not any(t.is_alive() for t in threads), "an HTTP request hung"
        finally:
            server.stop()
    for status, body in replies:
        assert status == 200, status
        assert isinstance(body["detections"], list) and isinstance(body["latency_ms"], float)
        for d in body["detections"]:
            assert len(d["box"]) == 4 and 0 < d["score"] <= 1
            assert d["class_name"] == pred.class_names[d["class_id"]]
    map_dets = map_pred.detect_arrays(map_request)
    seconds = time.perf_counter() - t0
    forwards = pred.forwards + map_pred.forwards
    launches = {"mbconv": fused_mbconv.launches, "nms": suppress.launches}
    log(f"main path, {pred.model.backbone} @{pred.input_hw[0]} C={len(pred.class_names)}: "
        f"detect_arrays 1/8/130 images -> {counts} detections, "
        f"{len(jpegs)} HTTP POSTs -> 200 with {[len(b['detections']) for _, b in replies]} "
        "detections, "
        f"MAP-grade request of 8 -> {sum(len(d) for d in map_dets)} detections; "
        f"{forwards} forwards, launches {launches}, {seconds:.2f} s")
    assert pred.forwards >= 4 + http and map_pred.forwards == 1, (pred.forwards,
                                                                  map_pred.forwards)
    assert launches["mbconv"] == mbconv_per_forward * forwards, (launches, forwards)
    assert launches["nms"] == forwards, (launches, forwards)
    # the shared pool (class stride 0) of both Predictors runs the shared-pool kernel
    variants = {p.num_candidates: plan_nms(len(p.class_names), p.num_candidates, 20,
                                           True).variant for p in (pred, map_pred)}
    log(f"main path: NMS kernel variant by pool size {variants}")
    assert set(variants.values()) == {"shared"}, variants
    report["main_path"] = dict(detections=counts, http=[len(b["detections"]) for _, b in replies],
                               forwards=forwards, launches=launches, seconds=seconds,
                               nms_variants=variants)
    return launches


def check_against_cpu(pred, seed, report):
    """float32 Predictor on the card (TF32 off) vs the same weights on the
    CPU (every kernel's plain version) on 2 images at the Predictor's size."""
    import numpy as np

    from yoloret_tpu_torch.infer import Predictor

    kw = dict(backbone=pred.model.backbone, rfcr=pred.model.rfcr_fusion,
              class_names=pred.class_names, anchors=pred.anchors, input_hw=pred.input_hw,
              score_threshold=0.3, num_candidates=64, bf16=False, batch_buckets=(2,))
    state = {k: v.cpu() for k, v in pred.model.state_dict().items()}
    gpu = Predictor(weights=state, device=DEVICE, **kw)
    cpu = Predictor(weights=state, device="cpu", **kw)
    rs = np.random.RandomState(seed + 1)
    ims = [rs.randint(0, 256, (240, 320, 3), dtype=np.uint8),
           rs.randint(0, 256, (320, 320, 3), dtype=np.uint8)]
    got, want = gpu.detect_arrays(ims), cpu.detect_arrays(ims)

    def same(g, w):
        return (g.class_id == w.class_id and abs(g.score - w.score) <= 1e-4 * abs(w.score)
                and max(abs(a - b) for a, b in zip(g.box, w.box)) <= 0.05)

    n = 0
    for g_img, w_img in zip(got, want):
        assert len(g_img) == len(w_img), (len(g_img), len(w_img))
        free = list(w_img)  # matched, not zipped: scores 1e-6 apart may swap order
        for g in g_img:
            hit = next((w for w in free if same(g, w)), None)
            assert hit is not None, f"no CPU detection matches {g}"
            free.remove(hit)
            n += 1
    assert n > 0, "no detections to compare"
    log(f"float32 Predictor on the card vs on the CPU, {pred.model.backbone} "
        f"(rfcr {pred.model.rfcr_fusion}) @{pred.input_hw[0]}: {n} detections agree "
        "(class, score rtol 1e-4, box atol 0.05 px)")
    report["cpu_agreement"] = n


def check_heads_against_cpu(pred, seed, report):
    """The float32 forward on the card (TF32 off) vs the same weights on
    the CPU, on 2 seeded images at the model's size: the raw heads within
    HEADS_RTOL of the largest |head|."""
    import torch

    from yoloret_tpu_torch.nn.detector import YoloReT
    from yoloret_tpu_torch.nn.fused_infer import fused_detector_apply

    m = pred.model
    state = {k: v.cpu() for k, v in m.state_dict().items()}
    x = torch.rand((2, *pred.input_hw, 3), generator=torch.Generator().manual_seed(seed + 1))
    heads = {}
    for dev in (DEVICE, "cpu"):
        model = YoloReT(m.backbone, m.num_classes, m.num_anchors, rfcr=m.rfcr_fusion)
        model.load_state_dict(state)
        model.to(dev).eval()
        heads[dev] = [h.cpu() for h in fused_detector_apply(model, x.to(dev))]
    scale = max(h.abs().max().item() for h in heads["cpu"])
    err = max((a - b).abs().max().item() for a, b in zip(heads[DEVICE], heads["cpu"]))
    log(f"float32 heads on the card vs on the CPU, {m.backbone} (rfcr {m.rfcr_fusion}) "
        f"@{pred.input_hw[0]}: max abs err {err:.3g} of max |head| {scale:.3g} (tolerance "
        f"{HEADS_RTOL:g} of it)")
    report["heads_err"], report["heads_scale"] = err, scale
    if not err <= HEADS_RTOL * scale:
        raise AssertionError(f"{m.backbone}: heads off the CPU's by {err} (max |head| {scale})")


def time_paths(pred, map_pred, report):
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(0)
    images = torch.randint(0, 256, (BATCH, *pred.input_hw, 3), generator=g, device=DEVICE,
                           dtype=torch.uint8)
    hw = torch.full((BATCH, 2), float(pred.input_hw[0]), device=DEVICE)
    out = {}
    for name, p in (("serving", pred), ("map_grade", map_pred)):
        ms = cuda_time_ms(lambda: p.infer(images, hw), iters=20, warmup=3)
        out[name] = dict(ms_per_batch=ms, img_per_s=BATCH * 1e3 / ms,
                         score_threshold=p.score_threshold, num_candidates=p.num_candidates)
        log(f"{name} {p.model.backbone} (t={p.score_threshold}, M={p.num_candidates}) at "
            f"b{BATCH}@{p.input_hw[0]} bf16: "
            f"{ms:.3f} ms/batch = {BATCH * 1e3 / ms:.1f} img/s (CUDA events, after warm-up)")
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
                             "temperature.gpu", "--format=csv,noheader"], capture_output=True,
                            text=True, timeout=60).stdout.strip()
    log(f"after the end-to-end timing: SM clock, max SM clock, power, temperature = {clocks}")
    out["clocks_after"] = clocks
    report["end_to_end"] = out
    return out


def device_ms_by_group(prof, groups):
    """Device ms of a ``torch.profiler`` run, summed per group of kernel
    names (a kernel joins the first group whose name is in its own, else
    "other"), and the other kernels' ms by name."""
    from torch.autograd import DeviceType

    out, others = dict.fromkeys(list(groups) + ["other"], 0.0), {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if not us or e.device_type != DeviceType.CUDA:  # CPU ops repeat their kernels' time
            continue
        key = next((k for k in groups if k in e.key), "other")
        out[key] += us / 1e3
        if key == "other":
            others[e.key] = others.get(e.key, 0.0) + us / 1e3
    return out, others


def profile_serving(pred, report, batches=3):
    """Where a serving batch's device time goes: torch.profiler kernel
    times over ``batches`` b128 batches, grouped into the two hand kernels
    and the rest, and the device's busy share of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=DEVICE).manual_seed(1)
    images = torch.randint(0, 256, (BATCH, *pred.input_hw, 3), generator=g, device=DEVICE,
                           dtype=torch.uint8)
    hw = torch.full((BATCH, 2), float(pred.input_hw[0]), device=DEVICE)
    pred.infer(images, hw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(batches):
            pred.infer(images, hw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    totals, other_totals = device_ms_by_group(prof, ("mbconv", "nms"))
    groups = {k: v / batches for k, v in totals.items()}
    others = {k: v / batches for k, v in other_totals.items()}
    busy = sum(groups.values())
    if busy == 0.0:
        log("profile: the profiler recorded no device time (not measured)")
        report["profile"] = None
        return
    top = sorted(others.items(), key=lambda kv: -kv[1])[:8]
    report["profile"] = dict(ms_per_batch=groups, wall_ms_per_batch=wall_ms / batches,
                             busy_share=busy * batches / wall_ms, top_other=top)
    rounded = {k: round(v, 3) for k, v in groups.items()}
    log(f"profile, serving {pred.model.backbone} b{BATCH}@{pred.input_hw[0]}: device ms/batch "
        f"{rounded} of {wall_ms / batches:.3f} ms "
        f"wall, device busy {busy * batches / wall_ms:.1%}")
    for name, ms in top:
        log(f"  other: {ms:.4f} ms  {name[:90]}")


# -- phase 5: the mAP evaluation -------------------------------------------


def write_eval_images(root, seed, n):
    """``n`` seeded JPEGs, 120-640 px a side (aspect ratios up to 5.3
    either way): smooth colour waves and noise. Returns [(path, (h, w))]."""
    import numpy as np
    from PIL import Image

    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        h, w = (int(v) for v in rs.randint(120, 641, 2))
        path = os.path.join(root, f"img_{i:04d}.jpg")
        Image.fromarray(wave_image(rs, h, w)).save(path, quality=90)
        out.append((path, (h, w)))
    return out


def wave_image(rs, h, w):
    """One seeded uint8 [h, w, 3] image of smooth colour waves and noise."""
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w]
    waves = np.sin(xx[..., None] * rs.uniform(0.005, 0.06, 3)
                   + yy[..., None] * rs.uniform(0.005, 0.06, 3) + rs.uniform(0, 6.3, 3))
    return np.clip(127 + 100 * waves + rs.randn(h, w, 3) * 12, 0, 255).astype(np.uint8)


def eval_ground_truth(cpu_pred, images, root, batch):
    """Ground truth from the float32 CPU detections of each image through
    the eval pipeline (shared pool, M=512, t=0): the EVAL_GT_PER_IMAGE
    best of an image, [n, 5] (x1, y1, x2, y2, cls) in original pixels."""
    import numpy as np
    import torch

    from yoloret_tpu_torch.data import Dataset

    lst = os.path.join(root, "ground_truth_pass.lst")
    with open(lst, "w") as f:
        f.write("\n".join(p for p, _ in images) + "\n")
    gts = []
    for batch in Dataset(lst, batch, input_hw=cpu_pred.input_hw, device="cpu").build(epochs=1):
        res = cpu_pred.infer(batch["images"], batch["image_hw"], score_threshold=0.0,
                             num_candidates=512)
        for i in range(batch["n_valid"]):
            m = res.valid[i]
            top = torch.argsort(res.scores[i][m], descending=True, stable=True)
            top = top[:EVAL_GT_PER_IMAGE]
            ymin, xmin, ymax, xmax = res.boxes[i][m][top].T.numpy()
            gts.append(np.stack([xmin, ymin, xmax, ymax,
                                 res.classes[i][m][top].numpy().astype(np.float32)], -1))
    return gts


def write_eval_dataset(images, gts, root):
    """A text list (pixel boxes) and a TFRecord shard (normalised boxes)
    of the same images; returns the glob of both."""
    from yoloret_tpu_torch.data.tfrecord import Example, TFRecordWriter

    d = os.path.join(root, "eval")
    os.makedirs(d)
    with open(os.path.join(d, "test.txt"), "w") as f:
        for (path, _), gt in zip(images, gts):
            f.write(path + "".join(" {!r},{!r},{!r},{!r},{}".format(*map(float, g[:4]), int(g[4]))
                                   for g in gt) + "\n")
    with TFRecordWriter(os.path.join(d, "test.tfrecord")) as w:
        for (path, (h, wd)), gt in zip(images, gts):
            with open(path, "rb") as f:
                raw = f.read()
            w.write(Example({
                "image/encoded": raw,
                "image/object/bbox/xmin": [float(v) for v in gt[:, 0] / wd],
                "image/object/bbox/ymin": [float(v) for v in gt[:, 1] / h],
                "image/object/bbox/xmax": [float(v) for v in gt[:, 2] / wd],
                "image/object/bbox/ymax": [float(v) for v in gt[:, 3] / h],
                "image/object/bbox/label": [float(v) for v in gt[:, 4]],
            }).serialize())
    return os.path.join(d, "test.*")


def run_printing(fn, *a, **kw):
    """``fn``'s result and what it printed (the eval lines logged)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    text = buf.getvalue()
    for line in text.splitlines():
        if line.startswith(("eval:", "mAP:")):
            log(f"    {line}")
    return out, text


def eval_rate(text):
    """images, ms/image and images/s from the loop's line that
    ``evaluate_map`` prints (the one number it does not return)."""
    m = re.search(r"eval: (\d+) images, ([\d.]+) ms/image, ([\d.]+) images/s", text)
    return dict(images=int(m.group(1)), ms_per_image=float(m.group(2)),
                img_per_s=float(m.group(3)))


def evaluate(pred, ds, class_names):
    """One ``evaluate_map`` run: its rate, per-class APs and mAP."""
    from yoloret_tpu_torch.eval import evaluate_map

    (mean_ap, aps), text = run_printing(evaluate_map, pred, ds, class_names)
    return dict(eval_rate(text), aps=[aps[c] for c in range(len(class_names))], map=mean_ap)


def evaluate_cli(argv, class_names):
    """One run of the CLI's MAP mode, which returns only its exit code:
    its rate, per-class APs and mAP as it prints them."""
    from yoloret_tpu_torch.cli.main import main as cli_main

    rc, text = run_printing(cli_main, argv)
    if rc != 0:
        raise AssertionError(f"the CLI's MAP mode returned {rc}")
    aps = dict(re.findall(r"^(.+) ap: ([\d.]+)$", text, re.M))
    return dict(eval_rate(text), aps=[float(aps[name]) for name in class_names],
                map=float(re.search(r"^mAP: ([\d.]+)$", text, re.M).group(1)))


def eval_phase(map_pred, state, seed, report, *, n_images=None, config=None,
               mbconv_per_forward=16, flagship=True):
    """The mAP evaluation path through its entry points (phase 5, and for
    each COCO configuration in phase 7); returns its report, with the
    launch counts of its run on the card. ``config``: the YAML file the
    CLI's run takes with ``--config`` (None: the flagship's flags).
    ``flagship``: the CPU references at BATCH with a bf16 one that the
    card's bf16 mAP is held to, the profiled idle share and the host's
    shares alone; otherwise the CPU runs at CPU_EVAL_BATCH and the bf16
    run on the card is logged."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from yoloret_tpu_torch.data import Dataset
    from yoloret_tpu_torch.eval import MAPEvaluator
    from yoloret_tpu_torch.infer import Predictor
    from yoloret_tpu_torch.ops.mbconv import fused_mbconv
    from yoloret_tpu_torch.ops.nms_kernel import suppress

    names = map_pred.class_names
    size = map_pred.input_hw[0]
    kw = dict(backbone=map_pred.model.backbone, rfcr=map_pred.model.rfcr_fusion,
              class_names=names, anchors=map_pred.anchors, input_hw=map_pred.input_hw,
              score_threshold=0.0, num_candidates=512, bf16=False)
    cpu_batch = BATCH if flagship else CPU_EVAL_BATCH
    out = {}
    with tempfile.TemporaryDirectory(prefix="yoloret_eval_") as root:
        t0 = time.perf_counter()
        images = write_eval_images(root, seed, n_images or EVAL_IMAGES)
        cpu = Predictor(weights=state, device="cpu", **kw)
        gts = eval_ground_truth(cpu, images, root, cpu_batch)
        pattern = write_eval_dataset(images, gts, root)
        n_samples, n_gt = 2 * len(images), 2 * sum(len(g) for g in gts)
        n_batches = -(-n_samples // BATCH)
        out["setup_s"] = time.perf_counter() - t0
        log(f"eval dataset, {map_pred.model.backbone} @{size}: {len(images)} JPEGs in a text "
            f"list and a TFRecord shard = {n_samples} samples, {n_gt} ground-truth boxes (the "
            f"CPU's {EVAL_GT_PER_IMAGE} best detections of each image), {len(names)} classes, "
            f"written in {out['setup_s']:.1f} s")

        def dataset(device, batch=BATCH):
            return Dataset(pattern, batch, input_hw=map_pred.input_hw, device=device)

        log(f"eval on the CPU, float32, shared pool M=512, b{cpu_batch} (the reference):")
        runs = {"cpu_f32_shared": evaluate(cpu, dataset("cpu", cpu_batch), names)}
        if not runs["cpu_f32_shared"]["map"] > 0:
            raise AssertionError(f"the CPU run's mAP is {runs['cpu_f32_shared']['map']}: "
                                 "the ground truth matches nothing")
        if flagship:
            log("eval on the CPU, bf16, shared pool M=512 (the bf16 run's reference):")
            cpu16 = Predictor(weights=state, device="cpu", **dict(kw, bf16=True))
            runs["cpu_bf16_shared"] = evaluate(cpu16, dataset("cpu"), names)
            del cpu16
        del cpu

        f32 = Predictor(weights=state, device=DEVICE, **kw)
        weights = os.path.join(root, "weights.pt")
        torch.save(state, weights)
        cli = ["--mode=MAP", f"--model={weights}", f"--test_dataset={pattern}",
               f"--batch_size={BATCH}", "--no-bf16", "--exact_nms", f"--device={DEVICE}"]
        if config is None:
            with open(os.path.join(root, "classes.txt"), "w") as f:
                f.write("\n".join(names) + "\n")
            with open(os.path.join(root, "anchors.txt"), "w") as f:
                f.write(", ".join(f"{v:g}" for v in map_pred.anchors.ravel()) + "\n")
            cli += [f"--classes_path={os.path.join(root, 'classes.txt')}",
                    f"--anchors_path={os.path.join(root, 'anchors.txt')}", f"--input_size={size}"]
        else:
            cli.insert(1, f"--config={config}")

        fused_mbconv.launches = suppress.launches = 0
        suppress.variant_launches.clear()
        log("eval on the card, float32, shared pool M=512 (evaluate_map):")
        runs["card_f32_shared"] = evaluate(f32, dataset(DEVICE), names)
        shown = ' '.join(a for a in cli if not a.startswith(('--model', '--test', '--cl', '--an')))
        log(f"eval on the card, float32, per-class pools K={exact_k(size)} (the CLI: {shown}):")
        with contextlib.chdir(HERE):  # the configs name their class and anchor files from here
            runs["card_f32_exact_cli"] = evaluate_cli(cli, names)
        log("eval on the card, bf16, shared pool M=512 (evaluate_map):")
        runs["card_bf16_shared"] = evaluate(map_pred, dataset(DEVICE), names)
        launches = {"mbconv": fused_mbconv.launches, "nms": suppress.launches,
                    **{f"nms_{k}": v for k, v in suppress.variant_launches.items()}}
        log(f"eval path: 3 runs of {n_batches} batches, launches {launches}")
        assert launches["mbconv"] == mbconv_per_forward * 3 * n_batches, launches
        assert launches["nms"] == 3 * n_batches, launches
        assert launches.get("nms_per_class_large") == n_batches, launches
        assert launches.get("nms_shared") == 2 * n_batches, launches
        for name in runs:
            assert runs[name]["images"] == n_samples, (name, runs[name]["images"])

        diffs, bad = {}, {}
        pairs = [("card_f32_shared", "cpu_f32_shared"), ("card_f32_exact_cli", "cpu_f32_shared")]
        if flagship:
            pairs.append(("card_bf16_shared", "cpu_bf16_shared"))
        else:
            log(f"  card_bf16_shared: mAP {runs['card_bf16_shared']['map']:.6f} (no bf16 CPU "
                "run at this configuration; logged, not held)")
        for name, ref in pairs:
            diffs[name] = max(abs(a - b) for a, b in zip(runs[name]["aps"], runs[ref]["aps"]))
            map_diff = abs(runs[name]["map"] - runs[ref]["map"])
            held = (f"tolerance {EVAL_AP_TOL}" if ref == "cpu_f32_shared" else
                    f"not held; the mAP difference {map_diff:.6f} is, tolerance {EVAL_BF16_MAP_TOL}")
            log(f"  {name}: mAP {runs[name]['map']:.6f} ({ref} {runs[ref]['map']:.6f}), largest "
                f"per-class AP difference from {ref} {diffs[name]:.6f} ({held})")
            if ref == "cpu_f32_shared" and diffs[name] > EVAL_AP_TOL:
                bad[f"{name}, per-class AP"] = diffs[name]
            if ref == "cpu_bf16_shared" and map_diff > EVAL_BF16_MAP_TOL:
                bad[f"{name}, mAP"] = map_diff
        if bad:
            raise AssertionError(f"off the CPU's run by more than the tolerance: {bad}")
        out.update(runs=runs, ap_diff=diffs, launches=launches, batches_per_run=n_batches,
                   samples=n_samples, gt_boxes=n_gt)
        if not flagship:
            report["eval"] = out
            return out

        # the device's idle share of the bf16 eval loop, by the profiler
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            loop = evaluate(map_pred, dataset(DEVICE), names)
        loop_ms = loop["ms_per_image"] * loop["images"]
        groups, _ = device_ms_by_group(prof, ("mbconv", "nms", "Memcpy"))
        busy = sum(groups.values())
        idle = None if busy == 0.0 else 1.0 - busy / loop_ms
        log(f"  profile, bf16 eval loop: {loop_ms:.1f} ms wall ({loop['img_per_s']:.2f} images/s "
            f"under the profiler), device busy {busy:.1f} ms "
            f"({ {k: round(v, 2) for k, v in groups.items()} }): device idle "
            + ("not measured (no device time recorded)" if idle is None else f"{idle:.1%}"))
        # the host's two shares of the loop, each alone: the thread pool's
        # decode of the same samples, and the evaluator filing one image's
        # detections (the whole slate of C x 20 at t=0) per sample
        ds = dataset("cpu")
        t0 = time.perf_counter()
        decoded = sum(h["n_valid"] for h in ds._host_batches(1))
        decode_s = time.perf_counter() - t0
        rs = np.random.RandomState(seed)
        n_det = len(names) * 20
        dets = (rs.rand(n_det, 4) * size, rs.rand(n_det), rs.randint(0, len(names), n_det))
        ev = MAPEvaluator(len(names))
        t0 = time.perf_counter()
        for g in gts + gts:
            ev.add_image(*dets, g)
        filing_s = time.perf_counter() - t0
        log(f"  host alone: decode {decoded} samples ({ds.num_workers} threads, PIL) "
            f"{decode_s * 1e3:.1f} ms = {decoded / decode_s:.1f} images/s; filing {n_det} "
            f"detections an image for {2 * len(gts)} images {filing_s * 1e3:.1f} ms")
        out.update(host_decode_s=decode_s, host_filing_s=filing_s, profile=dict(
            loop_ms=loop_ms, img_per_s=loop["img_per_s"], device_ms=groups, idle_share=idle))
    report["eval"] = out
    return out


def make_flush():
    """A function that evicts the L2 cache (a 128 MB write), for kernel
    timings where the real caller finds the cache cold."""
    import torch

    scratch = torch.empty(128 * 2**20, dtype=torch.uint8, device=DEVICE)  # > 50 MB L2

    def flush():
        scratch.zero_()

    return flush


def time_mbconv(pred, flush):
    """Each block's kernel, plain and cuDNN times at b128 and its bound and
    tile plan; returns (rows, sums)."""
    import torch

    from yoloret_tpu_torch.ops.mbconv import fused_mbconv, plan_tile, reference_mbconv

    rows, tot = [], dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    with torch.inference_mode():
        ins = block_inputs(pred, BATCH, seed=12)
        for meta, x in zip(pred._fused.blocks, ins):
            a = dict(stride=meta.stride, residual=meta.residual)
            ms = cuda_time_ms(lambda: fused_mbconv(x, *meta.args, packed=meta.packed, **a),
                              5, 1, flush)
            plain = cuda_time_ms(lambda: reference_mbconv(x, *meta.args, **a), 3, 1, flush)
            lib = cuda_time_ms(lambda: library_mbconv(x, *meta.args, **a), 5, 1, flush)
            bound, by, nbytes, flops = mbconv_bound(x, meta, 2)
            ce, cout = meta.args[2].shape[-1], meta.args[4].shape[-1]
            plan = plan_tile(x.shape[1] // meta.stride, x.shape[2] // meta.stride, meta.stride,
                             x.shape[3], ce, cout, meta.args[0] is not None, x.shape[0],
                             torch.cuda.get_device_properties(0).multi_processor_count)
            tile = plan._asdict()
            rows.append(dict(block=meta.block_id, shape=list(x.shape), stride=meta.stride,
                             ce=ce, cout=cout, tile=tile, ms=ms,
                             plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                             bytes=nbytes, flops=flops))
            for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", bound)):
                tot[k] += v
            log(f"  mbconv block {meta.block_id:2d} {tuple(x.shape)} s{meta.stride} Ce {ce} Cout "
                f"{cout} tile {plan.th}x{plan.tw} ({plan.nc} warpgroups), stages {plan.xst} "
                f"input / {plan.wst} weights, grid {plan.grid} for {plan.items} items, smem "
                f"{plan.smem}: kernel {ms:.4f} ms, plain {plain:.4f}, cuDNN {lib:.4f}, "
                f"bound {bound:.4f} ({by})")
    for stride in (1, 2):
        sel = [r for r in rows if r["stride"] == stride]
        sums = {k: sum(r[k] for r in sel) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        log(f"  mbconv stride-{stride} blocks ({len(sel)} launches per forward), summed: kernel "
            f"{sums['ms']:.4f} ms, plain {sums['plain_ms']:.4f}, cuDNN {sums['library_ms']:.4f}, "
            f"bound {sums['bound_ms']:.4f}")
    return rows, tot


def time_nms(pred, flush):
    """The suppression kernel at b128 on model candidates: the shared pool
    at serving (M=64, t=0.3) and MAP grade (M=512, t=0), and the
    large-pool variant on the exact evaluation's whole grid; returns
    (serving row, MAP-grade row, large-pool row)."""
    from yoloret_tpu_torch.ops.nms_kernel import plan_nms, suppress, suppress_plain

    rows = []
    big_k = exact_k(pred.input_hw[0])
    for m, thr, per_class in ((64, 0.3, False), (512, 0.0, False), (big_k, 0.0, True)):
        boxes, scores = candidates_at_b128(pred, m, seed=100 + m, per_class=per_class)
        c = scores.shape[1]
        kw = dict(max_det=20, iou_threshold=0.5, score_threshold=thr)
        plan = plan_nms(c, m, 20, shared=not per_class)
        ms = cuda_time_ms(lambda: suppress(boxes, scores, **kw), 10, 2, flush)
        plain = cuda_time_ms(lambda: suppress_plain(boxes, scores, **kw), 3, 1, flush)
        out_b, out_s = suppress(boxes, scores, **kw)
        bound, by, work = nms_bound_ms(boxes, scores, out_b, out_s, 20)
        rows.append(dict(m=m, classes=c, score_threshold=thr, plan=plan._asdict(), ms=ms,
                         plain_ms=plain, bound_ms=bound, bound_by=by,
                         detections=int((out_s > 0).sum()), **work))
        pool = f"per-class K={m}" if per_class else f"shared M={m}"
        log(f"  nms {pool} b{BATCH} C={c} t={thr} ({plan.variant} kernel, {plan.warps} warps, "
            f"{plan.smem} B shared memory): kernel {ms:.4f} ms, plain {plain:.4f}, bound "
            f"{bound:.5f} ({by}; {work['distinct_picks']} distinct picks, {work['rounds']} "
            f"rounds, {work['bytes']} bytes; per-class count "
            f"{work['bound_ms_per_class_count']:.5f})")
        del boxes, scores
    return rows


def kernel_entries(pred, suffix, launches, eval_launches, errs, mbconv, nms):
    """The kernels line's rows of one configuration: ``mbconv`` is
    ``time_mbconv``'s (rows, sums) or None, ``nms`` ``time_nms``'s rows."""
    size, c = pred.input_hw[0], len(pred.class_names)
    out = []
    if mbconv is not None:
        rows, tot = mbconv
        out.append(dict(
            name="mbconv" + suffix, route="cuda", source="yoloret_tpu_torch/csrc/mbconv.cu",
            replaces="yoloret_tpu/ops/mbconv_pallas.py:76",
            also_replaces=["yoloret_tpu/ops/mbconv_pallas.py:109",
                           "yoloret_tpu/ops/mbconv_pallas2.py:86"],
            shapes=f"the {len(rows)} blocks of one {pred.model.backbone} forward at "
                   f"b{BATCH}@{size} bf16 (times summed)",
            launches=launches["mbconv"], eval_launches=eval_launches["mbconv"],
            max_abs_err=errs["mbconv"], ms=tot["ms"],
            plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by=max(("bytes", "operations"),
                         key=lambda by: sum(r["bound_ms"] for r in rows if r["bound_by"] == by)),
            library_ms=tot["library_ms"]))
    serving, mapg, large = nms
    out.append(dict(
        name="nms" + suffix, route="cuda", source="yoloret_tpu_torch/csrc/nms.cu",
        replaces="yoloret_tpu/ops/nms_pallas.py:36",
        also_replaces=["yoloret_tpu/ops/postprocess.py:361"],
        shapes=f"shared pool b{BATCH} C={c} M=64 t=0.3 (serving, {pred.model.backbone} "
               f"@{size}); map_grade_*: M=512 t=0",
        launches=launches["nms"], eval_launches=eval_launches.get("nms_shared", 0),
        max_abs_err=errs["nms"], ms=serving["ms"],
        plain_ms=serving["plain_ms"], bound_ms=serving["bound_ms"],
        bound_by=serving["bound_by"], library_ms=None, map_grade_ms=mapg["ms"],
        map_grade_plain_ms=mapg["plain_ms"], map_grade_bound_ms=mapg["bound_ms"],
        map_grade_bound_by=mapg["bound_by"]))
    out.append(dict(
        name="nms_per_class_large" + suffix, route="cuda", source="yoloret_tpu_torch/csrc/nms.cu",
        replaces="yoloret_tpu/ops/nms_pallas.py:36",
        shapes=f"per-class pools b{BATCH} C={c} K={large['m']} t=0 max_det 20 (the "
               f"--exact_nms eval's at {size}); launches: the eval path's run",
        launches=eval_launches.get("nms_per_class_large", 0), max_abs_err=errs["nms_large"],
        ms=large["ms"], plain_ms=large["plain_ms"], bound_ms=large["bound_ms"],
        bound_by=large["bound_by"], library_ms=None))
    return out


def time_kernels(pred, launches, eval_launches, errs, report):
    import torch

    flush = make_flush()
    # what the timer reads for a kernel that does nothing (a one-element
    # fill): launch latency, the floor under every kernel time below
    tiny = torch.zeros(1, device=DEVICE)
    report["timer_floor_ms"] = cuda_time_ms(lambda: tiny.zero_(), 10, 2, flush)
    log(f"  timer floor: an empty kernel reads {report['timer_floor_ms']:.4f} ms")
    mbconv = time_mbconv(pred, flush)
    report["mbconv_timing"] = mbconv[0]
    report["nms_timing"] = time_nms(pred, flush)
    return kernel_entries(pred, "", launches, eval_launches, errs, mbconv, report["nms_timing"])


# -- phases 7 and 8: the COCO configurations and the rest of the registry ----


def coco_phase(name, config, seed, report):
    """One of the paper's COCO configurations through phases 2-6 at its
    own shapes (phase 7); returns its rows of the kernels line."""
    import torch

    from yoloret_tpu_torch.configs import load_config
    from yoloret_tpu_torch.data import load_anchors, load_classes
    from yoloret_tpu_torch.nn.fused_infer import is_fused
    from yoloret_tpu_torch.ops import _build

    t0 = time.perf_counter()
    cfg = load_config(os.path.join(HERE, config))
    names = load_classes(os.path.join(HERE, cfg.classes_path))
    anchors = load_anchors(os.path.join(HERE, cfg.anchors_path))
    assert cfg.input_size[0] == cfg.input_size[1], cfg.input_size
    size = cfg.input_size[0]
    log(f"== {name}: {config}: {cfg.backbone} @{size}, {len(names)} classes, anchors "
        f"{anchors.astype(int).tolist()}, rfcr {cfg.rfcr}")
    out = report.setdefault("coco", {}).setdefault(name, {})
    kw = dict(size=size, class_names=names, backbone=cfg.backbone, rfcr=cfg.rfcr)
    pred = make_predictor(seed, score_threshold=0.3, num_candidates=64, mixed=True, **kw)
    assert (pred.anchors == anchors).all(), "the configuration's anchors are the smoke's"
    state = {k: v.detach().cpu() for k, v in pred.model.state_dict().items()}
    map_pred = make_predictor(seed, weights=state, score_threshold=0.0, num_candidates=512, **kw)
    fused = is_fused(pred.model)
    per_forward = 16 if fused else 0
    errs = {}
    with torch.no_grad():
        if fused:
            eleven = [ln for ln in ptxas_lines(_build.ptxas_log("mbconv")) if ",11>" in ln]
            for line in eleven:
                log(f"  ptxas mbconv, the NB=11 instances (Cout 144-264): {line}")
            errs["mbconv"] = check_mbconv(pred, out)
        nms_err = check_nms(pred, out, synthetic=False)
        errs.update(nms=nms_err["small"], nms_large=nms_err["large"])
    launches = drive_main_path(pred, map_pred, seed, out, mbconv_per_forward=per_forward,
                               http=fused)
    check_against_cpu(pred, seed, out)
    time_paths(pred, map_pred, out)
    profile_serving(pred, out)
    ev = eval_phase(map_pred, state, seed, out, n_images=COCO_EVAL_IMAGES, config=config,
                    mbconv_per_forward=per_forward, flagship=False)
    flush = make_flush()
    mbconv = time_mbconv(pred, flush) if fused else None
    out["nms_timing"] = time_nms(pred, flush)
    if mbconv is not None:
        out["mbconv_timing"] = mbconv[0]
    out["seconds"] = time.perf_counter() - t0
    log(f"== {name}: {out['seconds']:.1f} s")
    kernels = kernel_entries(pred, f"@{name}", launches, ev["launches"], errs, mbconv,
                             out["nms_timing"])
    del pred, map_pred
    torch.cuda.empty_cache()
    return kernels


def registry_phase(seed, report):
    """The rest of the backbone registry (phase 8): each backbone (and
    RFCR variant) of REGISTRY_RUNS at REGISTRY_SIZE with seeded,
    calibrated weights: one ``detect_arrays`` call of REGISTRY_BATCH
    images with the launch counts set to 0 just before and read just
    after, then float32 card vs CPU on 2 images: the raw heads and, for a
    MobileNetV2 (the MBConv kernel's path), the detections."""
    import numpy as np
    import torch

    from yoloret_tpu_torch.nn.fused_infer import is_fused
    from yoloret_tpu_torch.ops.mbconv import fused_mbconv
    from yoloret_tpu_torch.ops.nms_kernel import suppress

    rs = np.random.RandomState(seed + 2)
    out = report.setdefault("registry", {})
    for backbone, rfcr in REGISTRY_RUNS:
        t0 = time.perf_counter()
        key = backbone if rfcr == "weighted_sum" else f"{backbone}_{rfcr}"
        sub = out.setdefault(key, {})
        pred = make_predictor(seed, size=REGISTRY_SIZE, backbone=backbone, rfcr=rfcr,
                              score_threshold=0.3, num_candidates=64, mixed=True)
        images = [rs.randint(0, 256, (int(rs.randint(200, 500)), int(rs.randint(200, 500)), 3),
                             dtype=np.uint8) for _ in range(REGISTRY_BATCH)]
        fused_mbconv.launches = suppress.launches = 0
        pred.forwards = 0
        dets = pred.detect_arrays(images)
        launches = {"mbconv": fused_mbconv.launches, "nms": suppress.launches}
        per_forward = 16 if is_fused(pred.model) else 0
        assert len(dets) == len(images) and pred.forwards == 1, (len(dets), pred.forwards)
        assert launches == {"mbconv": per_forward, "nms": 1}, (key, launches)
        for im, d in zip(images, dets):
            for det in d:
                x1, y1, x2, y2 = det.box
                assert all(np.isfinite(det.box)) and 0 < det.score <= 1
                assert 0 <= x1 <= x2 <= im.shape[1] and 0 <= y1 <= y2 <= im.shape[0], det
        n = sum(len(d) for d in dets)
        log(f"registry {key} @{REGISTRY_SIZE} b{REGISTRY_BATCH}: detect_arrays -> {n} "
            f"detections, launches {launches}")
        check_heads_against_cpu(pred, seed, sub)
        if is_fused(pred.model):
            check_against_cpu(pred, seed, sub)
        sub.update(detections=n, launches=launches, seconds=time.perf_counter() - t0)
        del pred
        torch.cuda.empty_cache()
    return {k: v["launches"] for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import yoloret_tpu_torch
        from yoloret_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}", file=sys.stderr)
        return 2
    pkg = os.path.dirname(os.path.abspath(yoloret_tpu_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        print(f"chip_smoke: imported the port from {pkg}, not from {HERE}", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    log(smi)
    report = dict(nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
                  device=torch.cuda.get_device_name(0))
    build_s = _build.build_all()
    report["build_seconds"] = build_s
    log(f"built csrc/mbconv.cu and csrc/nms.cu for sm_90a in {build_s:.1f} s")
    for name in ("mbconv", "nms"):
        for line in ptxas_lines(_build.ptxas_log(name)):
            log(f"  ptxas {name}: {line}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    pred = make_predictor(args.seed, score_threshold=0.3, num_candidates=64)
    state = {k: v.detach().cpu() for k, v in pred.model.state_dict().items()}
    map_pred = make_predictor(args.seed, weights=state, score_threshold=0.0, num_candidates=512)

    with torch.no_grad():
        errs = {"mbconv": check_mbconv(pred, report)}
        nms_err = check_nms(pred, report)
        errs.update(nms=nms_err["small"], nms_large=nms_err["large"])
    launches = drive_main_path(pred, map_pred, args.seed, report)
    check_against_cpu(pred, args.seed, report)
    e2e = time_paths(pred, map_pred, report)
    profile_serving(pred, report)
    ev = eval_phase(map_pred, state, args.seed, report)
    kernels = time_kernels(pred, launches, ev["launches"], errs, report)
    log(f"flagship phases done at {time.perf_counter() - t_start:.1f} s")
    del pred, map_pred
    torch.cuda.empty_cache()

    for name, config in COCO_CONFIGS.items():
        kernels += coco_phase(name, config, args.seed, report)
    registry = registry_phase(args.seed, report)

    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    log(f"total: {report['seconds']:.1f} s")
    out = os.path.join(HERE, "chiprun_out", "chip_smoke.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    log(json.dumps({"end_to_end_img_per_s": {k: v["img_per_s"] for k, v in e2e.items()
                                             if isinstance(v, dict)},
                    "eval_img_per_s": {k: v["img_per_s"] for k, v in ev["runs"].items()},
                    "eval_device_idle_share": ev["profile"]["idle_share"],
                    "eval_map": {k: v["map"] for k, v in ev["runs"].items()},
                    "coco": {name: dict(
                        end_to_end_img_per_s={k: v["img_per_s"]
                                              for k, v in c["end_to_end"].items()
                                              if isinstance(v, dict)},
                        eval_map={k: v["map"] for k, v in c["eval"]["runs"].items()},
                        eval_ap_diff=c["eval"]["ap_diff"],
                        main_path_launches=c["main_path"]["launches"])
                        for name, c in report["coco"].items()},
                    "registry_launches": registry,
                    "seconds": report["seconds"],
                    "card": smi}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
