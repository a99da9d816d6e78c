#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``yoloret_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero and prints no result):

1. The card's name and power limit (``nvidia-smi``); build both CUDA
   kernels from ``yoloret_tpu_torch/csrc/`` and the native JPEG loader
   (``yoloret_tpu_torch/native/dataloader.cc``; one compiler each, in
   parallel; the loader may fail to build, which is reported, and the
   data path then decodes with PIL) and print each kernel's ``ptxas``
   registers and spills.
2. Each kernel against its plain PyTorch version on the card, at the
   serving path's shapes: the fused MBConv at all 16 backbone blocks of
   MobileNetV2 x0.75 @ 320 (float32 with TF32 off at b2; bfloat16, the
   Hopper kernel on the packed weights, at b2 and at b128, where the
   work items outnumber the persistent CTAs); the suppression kernels,
   exactly: the shared-pool kernel on model candidates at C=20, M=64
   (t=0.3) and M=512 (t=0) for B=128, 8 and 1, on tied scores and on
   pairs at IoU 0.5; the per-class kernel on per-class pools; the
   large-pool kernels on the exact evaluation's per-class pools (model
   candidates, K=6300, B=128 and 1: sorted, the walk; shuffled and with
   one inversion at the last index, the rounds; doubled to K=12600,
   beyond the rounds' staging limit, sorted and shuffled) and on tied
   scores with pairs at IoU 0.5.
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
   the bf16 run's mAP within EVAL_BF16_MAP_TOL of the CPU's bf16 one;
   the decodes by decoder of every run (all native where the JPEG
   loader built). Then the bf16 run again under the
   profiler: the device's idle share of the eval loop; and the host's
   two shares alone: the decode, and the evaluator's filing.
6. Each kernel's device time (L2 flushed, the device kept behind the
   host) beside its plain version, a library yardstick and its bound
   (bytes at 3.35 TB/s, operations at the peak rate of their type); per
   MBConv block also the tile plan (tile, warpgroups, pipeline stages,
   persistent grid, shared memory); NMS at the serving and the MAP-grade
   shape, each with its launch plan, and the large-pool variant at the
   exact evaluation's shape, its pools sorted as the path gives them and
   shuffled; the bound counts only the boxes a sorted pool needs (up to
   its last pick), and the bound of earlier records (every box) is
   printed beside it.
7. IMAGE, the CLI's default mode: ``--mode=IMAGE`` on the port's
   ``assets/demo.jpg`` with the flagship weights (bf16; the launch counts
   set to 0 just before and read just after: 16 MBConv + 1 NMS), the
   float32 Predictor's detections on it card vs CPU, the MBConv kernel
   against its plain version at batch 1, the batch-1 latency
   (``detect_arrays`` by the host clock, ``infer`` by CUDA events) and
   the MBConv kernel's times at b1.
8. Training, flagship at full width: one float32 train step (TF32 off,
   b8 @320, 20 classes) on the card and on the CPU from the same weights
   and batch, stage 2 and stage 1 (the loss, the parameters and the
   running statistics held; in stage 1 the frozen parameters and the
   backbone's statistics bitwise unchanged on the card); the CLI's
   ``--mode=TRAIN`` with ``configs/voc_mobilenetv2x75_320.yaml`` (bf16,
   b32) on 96 seeded JPEGs whose boxes are the CPU's float32
   detections: stage 1 with a validation loss and the stage-end mAP
   (its loss must fall), then stage 2 from stage 1's file, the launch
   counts of both runs' mAP passes, ``--mode=MAP --model=<final file>``
   giving the trainer's stage-end mAP to 1e-6, and the MBConv kernel
   against its plain version on the trained weights; ``--mode=ANCHORS``
   on the train list (its file equal to ``kmeans_anchors``' in this
   process); the CLI's TRAIN with the options of ROADMAP item 4c
   (AutoAugment v0, mosaic and mixup 0.5, ``--multi_scale 288 352``,
   ``--tb_images 4``: one stage-1 epoch per size from the flagship
   weights; the losses finite, 8 image summaries of the epochs' sizes,
   the launch counts of its detection passes and mAP), the MBConv kernel
   against its plain version on its weights at [4, 288] and [4, 352],
   the host stream's cost of AutoAugment, ``mix_batch`` on the card
   against the CPU with the same draws, and the MBConv times at both
   shapes; then train-step
   img/s of each shipped config at its own width and batch (x0.75
   32@320, x1.4 64@224, B3 16@416; bf16, stage 1 and 2), with the
   profiler's device busy share and the device ms and top kernels of
   the forward, the backward and the optimizer.
9. The paper's two COCO configurations, at full width and depth, 80
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
10. The rest of the backbone registry at 320, b8 (MobileNetV2 x1.0,
   EfficientNet-B0, DarkNet-53, x0.75 with RFCR ``concat`` and ``none``,
   YOLO-Nano, Yolo-Fastest and -XL): one ``detect_arrays`` call each with
   its launch counts, and float32 card vs CPU on 2 images (the raw heads;
   for a MobileNetV2 also the detections).
11. The serving side paths. The W8A8 int8 backbone
   (``Predictor(use_int8=True)``, x0.75 @320 at full width, calibrated on
   16 seeded wave images): ``detect_arrays`` on 1, 8 and 130 images and the
   HTTP server with the launch counts (0 MBConv + 1 NMS a forward); the
   float32 int8 Predictor card vs CPU on 2 images (the scales, each tap's
   int8 codes, the heads, the detections, held to INT8_LIMITS) and every
   block on the card from the CPU's own input codes and weights; serving
   and MAP-grade img/s beside the bf16 fused path's in the same call; the
   profiler's device ms split into ``_int_mm``, depthwise, epilogues,
   stem, neck and postprocess; the CLI's ``--mode=MAP --int8`` on 64 images
   of phase 5's set, calibrated from its text list, float32, the card's
   mAP within EVAL_AP_TOL of the CPU's; EfficientNet-B3 @416
   (``configs/coco_efficientnetb3_416.yaml``) int8 card vs CPU
   (INT8_B3_LIMITS), its serving img/s beside the stock bf16 path's and
   its device split. The
   zoom ensemble (``Predictor(zoom_ensemble=True)``, bf16, the 224 centre
   crop): the main path with 32 MBConv + 1 NMS launches a forward
   (``nms_kernel``, per-class pools of 256 over 9,387 positions), float32
   card vs CPU detections, the MBConv kernel against its plain version at
   x0.75 @224 (b2 and b128) and timed with its tile plan, ``nms_kernel``
   exactly against its plain version on the zoom's pools (B=128 and 1)
   and timed, zoom serving img/s and its profile; then int8 with zoom at
   b8 (0 + 1).

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
import warnings

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
# The paper's COCO configurations (phase 8): name -> config file. Their
# evaluation set is smaller (COCO_EVAL_IMAGES JPEGs, one b128 batch on the
# card) and the CPU references run at CPU_EVAL_BATCH: the CPU pays for the
# padded rows of a final batch, and B3 @416 costs ~10x x0.75 @320 a row.
COCO_CONFIGS = {
    "mobilenetv2x14_224": "configs/coco_mobilenetv2x14_224.yaml",
    "efficientnetb3_416": "configs/coco_efficientnetb3_416.yaml",
}
COCO_EVAL_IMAGES = 64
CPU_EVAL_BATCH = 16
# The rest of the registry (phase 9), as (backbone, rfcr), at REGISTRY_SIZE
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
# The training phase (phase 7). The float32 step card vs CPU: the flagship
# at full width, TRAIN_CPU_BATCH images, Adam at TRAIN_LR; the loss within
# TRAIN_LOSS_RTOL relative. The gradients (grad_diffs), against the same
# step at float64 compute on the CPU, the loss included (float64 targets):
# the card's float64 step within TRAIN_GRAD64_RTOL of it on every leaf,
# which holds the backward's every term; and the card's float32 step no
# more than TRAIN_GRAD_PREC_RATIO times as far from it as the CPU's
# float32 step, in the median over the leaves, which holds the float32
# kernels' precision (TF32 or bfloat16 compute would be many times
# farther). No fixed float32 limit would hold a leaf to much: train-mode
# BatchNorms cancel most of some leaves' gradients, whose float32
# rounding then reaches ~1e-2 of them. A leaf whose float64 gradient is
# below TRAIN_GRAD_NOISE of the largest leaf's (a bias whose shift the
# next train-mode BatchNorm removes: 0 in exact arithmetic) is left out
# and named. After the step every running statistic within
# TRAIN_STATS_RTOL of the larger of its leaf's largest magnitude and
# TRAIN_STATS_FLOOR of the model's largest statistic of its kind, and
# TRAIN_PARAM_CLOSE_SHARE of the parameters within 1e-5 + 1e-4 relative.
TRAIN_CPU_BATCH = 8
TRAIN_LR = 1e-3
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD64_RTOL = 1e-7
TRAIN_GRAD_PREC_RATIO = 30.0
TRAIN_GRAD_NOISE = 1e-9
TRAIN_STATS_RTOL = 1e-3
TRAIN_STATS_FLOOR = 1e-3
TRAIN_PARAM_CLOSE_SHARE = 0.99
# The CLI's TRAIN: the flagship config on TRAIN_IMAGES seeded JPEGs.
TRAIN_CONFIG = "configs/voc_mobilenetv2x75_320.yaml"
TRAIN_IMAGES = 96
TRAIN_E2E_BATCH = 32
TRAIN_EPOCHS = (3, 1)
# Train-step throughput: each shipped config at its own size and batch.
TRAIN_CONFIGS = ("configs/voc_mobilenetv2x75_320.yaml", "configs/coco_mobilenetv2x14_224.yaml",
                 "configs/coco_efficientnetb3_416.yaml")
TRAIN_WARMUP = 3
TRAIN_TIMED = 20
# The CLI's TRAIN with the training options on (ROADMAP item 4c): one
# stage-1 epoch at each multi-scale size, TB_IMAGES detection rows an
# epoch; the MBConv kernel held at those shapes on the trained weights,
# and mix_batch on the card against the CPU (images MIX_TOL, boxes
# MIX_BOX_TOL px, valid equal).
OPTIONS_SIZES = (288, 352)
TB_IMAGES = 4
MIX_TOL = 1e-5
MIX_BOX_TOL = 1e-4
# IMAGE: the demo photo through the CLI (bf16, the user's default) and
# the float32 Predictor card vs CPU (class, score rtol 1e-4, box atol
# IMAGE_BOX_TOL px); the batch-1 latency over IMAGE_TIMED calls.
IMAGE_SCORE = 0.3
IMAGE_BOX_TOL = 0.05
IMAGE_WARMUP = 10
IMAGE_TIMED = 100
# Phase 11, the serving side paths. The int8 Predictors calibrate on
# INT8_CALIB_IMAGES seeded wave images (INT8_B3_CALIB_IMAGES for B3 @416);
# the CLI's --mode=MAP --int8 takes the first INT8_EVAL_IMAGES images of
# phase 5's set; the zoom ensemble's Predictor takes per-class pools of
# ZOOM_K. The float32 int8 Predictor card vs CPU, each calibrated on its
# own device, is held to INT8_LIMITS (x0.75) and INT8_B3_LIMITS (B3):
# scale_rtol on the scales, tap_share / tap_rel_rms on each tap's int8
# codes (share that differ, relative RMS difference), heads_rtol on the
# heads' largest difference over the largest |head|, detections: whether
# every detection must agree (class, score rtol 1e-4, box 0.05 px), and
# block_share on ``check_int8_blocks`` (each block from the same input
# codes and int8 weights on both: codes off by one on at most that share).
# The calibration runs in float64 and the float32 stem in float64 rounded
# once, so both sides get the same scales and stem codes; MobileNetV2's
# relu6 blocks are then exact or one IEEE rounding per op, the same on
# both: codes equal, heads within the neck's float32 rounding (HEADS_RTOL).
# B3's swish and squeeze-excite take each device's own sigmoid and mean, so
# a code flips at a rounding boundary now and then, and on seeded weights a
# flipped code moves the chain after it (on an H100: its blocks one at a
# time within one code on 0.011% of codes, its c4 and c5 taps 88% apart,
# relative RMS 0.12): its taps and heads are only held against garbage
# (relative RMS at most 1, that of uncorrelated codes being ~1.4), its
# blocks by block_share.
INT8_CALIB_IMAGES = 16
INT8_B3_CALIB_IMAGES = 8
INT8_EVAL_IMAGES = 64
ZOOM_K = 256
INT8_LIMITS = dict(scale_rtol=1e-9, tap_share=0.0, tap_rel_rms=0.0, heads_rtol=HEADS_RTOL,
                   detections=True, block_share=0.0)
INT8_B3_LIMITS = dict(scale_rtol=1e-9, tap_share=1.0, tap_rel_rms=1.0, heads_rtol=1.0,
                      detections=False, block_share=1e-3)


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build_libraries(report):
    """Build both CUDA libraries and the native JPEG loader, all compilers
    at once; returns the seconds. The CUDA kernels must build; the loader
    may not (no g++ or no jpeglib.h), and then the data path decodes with
    PIL, as the JAX package does: ``report["native_loader"]`` says which,
    with the compiler's message."""
    from yoloret_tpu_torch import native
    from yoloret_tpu_torch.ops import _build

    t0 = time.perf_counter()
    try:
        _build.build_all(("mbconv", "nms", "native"))
    except RuntimeError:
        _build.build_all(("mbconv", "nms"))  # raises if a kernel failed
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the reason is reported below
        built = native.available()
    report["native_loader"] = ("built" if built else
                               f"not built, PIL decodes: {native.build_error()}")
    report["native_loader_built"] = built
    return time.perf_counter() - t0


def ptxas_lines(text):
    """The registers, shared memory and spill lines of a ``-Xptxas -v``
    log, each with its kernel (template arguments spelled out). Dynamic
    shared memory is not in the log: the plans print it."""
    out, fn = [], ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(mbconv_wgmma|mbconv_f32|nms_kernel|nms_shared|nms_large_rounds)I"
                          r"((?:L[ib]\d+E)+)E", m.group(1))
            fn = f"{k.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', k.group(2)))}>" if k else ""
            fn = fn or ("nms_large_walk" if "nms_large_walk" in m.group(1) else "")
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


def block_inputs(pred, batch, seed, size=None):
    """Input of each of the 16 blocks for ``batch`` seeded images at
    ``size`` (default: the Predictor's), run through the kernel path
    itself (real activation statistics)."""
    import torch

    from yoloret_tpu_torch.nn.layers import conv2d_same, relu6
    from yoloret_tpu_torch.ops.mbconv import fused_mbconv

    hw = (size, size) if size else pred.input_hw
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.rand((batch, *hw, 3), generator=g, device=DEVICE).to(pred.model.dtype)
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


def sorted_pool_reads(boxes, scores, out_boxes, out_scores, max_det, score_threshold):
    """Per-class pools (boxes [B, C, K, 4]): which pools have
    non-increasing keys (inactive candidates, below the threshold, count
    as the lowest key), and how many of each pool's boxes greedy NMS needs
    on such a pool: those up to its last pick when it makes max_det picks
    (the pick is the first candidate with its score and box), else every
    active one. ``out_scores`` must mark empty slots -inf. Returns
    (sorted [B, C] bool, boxes needed [B, C] int64)."""
    import torch

    active = (scores >= score_threshold) & (scores > float("-inf"))
    key = torch.where(active, scores, torch.full_like(scores, float("-inf")))
    in_order = (key[..., :-1] >= key[..., 1:]).all(-1)
    picks = torch.isfinite(out_scores).sum(-1)
    needed = active.sum(-1)
    k = scores.shape[-1]
    for i in range(scores.shape[0]):  # an image at a time: the match is [C, K, 4]
        last_s, last_b = out_scores[i, :, max_det - 1], out_boxes[i, :, max_det - 1]
        match = (scores[i] == last_s[:, None]) & (boxes[i] == last_b[:, None]).all(-1)
        first = torch.where(match.any(-1), match.int().argmax(-1), torch.full_like(picks[i], k))
        needed[i] = torch.where(picks[i] == max_det, first + 1, needed[i])
    return in_order, needed


def nms_bound_ms(boxes, scores, out_boxes, out_scores, max_det, score_threshold):
    """Least time of the function on this run's data, by the count of the
    work the data needs. ``out_scores``' empty slots must be -inf. Bytes:
    scores and outputs once, and boxes once, except that a per-class pool
    whose keys do not increase needs only its boxes up to its last pick
    (``sorted_pool_reads``). Operations: on such a pool, one compare per
    candidate (its order) and one IoU (NMS_IOU_OPS) per box it needs;
    elsewhere one IoU per (image, distinct picked box, candidate) --
    greedy NMS needs no other IoU, and a shared pool's classes share them
    -- plus NMS_ARGMAX_OPS per candidate for each round (picks + a final
    empty round, capped at max_det) per (image, class); float32 peak. Also
    returns the bound by the count of earlier records (every box read, the
    IoUs of every pick) and by the per-class count (every class's IoUs,
    NMS_OPS_PER_CLASS_PAIR per candidate per round)."""
    import torch

    picked = torch.isfinite(out_scores)
    picks = picked.sum(-1)
    rounds = (picks + (picks < max_det).long()).sum().item()
    m = scores.shape[-1]
    if boxes.dim() == 3:  # shared pool: a box picked by several classes counts once
        distinct = sum(int(torch.unique(out_boxes[i][picked[i]], dim=0).shape[0])
                       for i in range(len(boxes)) if picked[i].any())
    else:
        distinct = int(picks.sum())
    ops_all = distinct * m * NMS_IOU_OPS + rounds * m * NMS_ARGMAX_OPS
    bytes_all = (scores.numel() + boxes.numel() + out_scores.numel() * 5) * 4
    n_sorted, box_reads, ops, nbytes = 0, boxes.numel() // 4, ops_all, bytes_all
    if boxes.dim() == 4:
        in_order, needed = sorted_pool_reads(boxes, scores, out_boxes, out_scores, max_det,
                                             score_threshold)
        n_sorted = int(in_order.sum())
        box_reads = int(torch.where(in_order, needed, torch.full_like(needed, m)).sum())
        nbytes = (scores.numel() + 4 * box_reads + out_scores.numel() * 5) * 4
        pool_picks = picks.float()
        unsorted_ops = ((pool_picks * m * NMS_IOU_OPS
                         + (pool_picks + (picks < max_det).float()) * m * NMS_ARGMAX_OPS)
                        * ~in_order).sum().item()
        ops = int(unsorted_ops) + int(((m + needed * NMS_IOU_OPS) * in_order).sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["f32"]
    before = max(bytes_all / HBM_BYTES_PER_S, ops_all / PEAK_OPS["f32"]) * 1e3
    per_class = max(bytes_all / HBM_BYTES_PER_S,
                    rounds * m * NMS_OPS_PER_CLASS_PAIR / PEAK_OPS["f32"]) * 1e3
    return (max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"),
            dict(distinct_picks=distinct, rounds=rounds, ops=ops, bytes=nbytes,
                 sorted_pools=n_sorted, pools=int(picks.numel()), boxes_needed=box_reads,
                 bound_ms_all_boxes=before, bound_ms_per_class_count=per_class))


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


def model_candidates(pred, k, seed, per_class=False, batch=BATCH, size=None, images=None,
                     image_hw=None):
    """The NMS inputs of ``batch`` seeded images at ``size`` (default: the
    Predictor's) through the kernel path, or of ``images`` (uint8
    [B, H, W, 3] on the card, of original sizes ``image_hw`` [B, 2]): the
    shared pool of ``k`` (boxes [B, k, 4]) or, with ``per_class``,
    per-class pools of ``k`` (boxes [B, C, k, 4]); scores [B, C, k]."""
    import torch

    from yoloret_tpu_torch.nn.fused_infer import fused_detector_apply
    from yoloret_tpu_torch.ops.postprocess import per_class_candidates, shared_pool_candidates

    if images is None:
        hw = (size, size) if size else pred.input_hw
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        images = torch.randint(0, 256, (batch, *hw, 3), generator=g, device=DEVICE,
                               dtype=torch.uint8)
        image_hw = torch.tensor([hw], dtype=torch.float32, device=DEVICE).repeat(batch, 1)
    pool = per_class_candidates if per_class else shared_pool_candidates
    with torch.inference_mode():
        outs = fused_detector_apply(pred.model, images.float() / 255.0, pred._fused)
        return pool(outs, pred._anchors_t, len(pred.class_names), image_hw, num_candidates=k)


def nms_cases(pred, synthetic=True):
    """(name, boxes, scores, score threshold, empty score) of every NMS
    check: model candidates of the serving (M=64) and the MAP-grade shape
    (M=512) at B=128, 8 and 1, and of the IMAGE mode's and --tb_images'
    (M=256, t=0.3) at B=128, TB_IMAGES and 1; the exact evaluation's per-class pools of the whole
    grid (large-pool kernels, empty slots -inf as on that path) at B=128
    and 1; with ``synthetic``, also those pools shuffled, with one
    inversion at the last index, and doubled beyond the rounds' staging
    limit (sorted and shuffled); tied scores; pairs at IoU 0.5, exactly
    and within rounding; per-class pools; and large pools of tied scores
    and pairs at IoU 0.5."""
    import numpy as np
    import torch

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(DEVICE)

    cases = []
    for m, thr, batches in ((64, 0.3, (BATCH, 8, 1)), (256, 0.3, (BATCH, TB_IMAGES, 1)),
                            (512, 0.0, (BATCH, 8, 1))):
        boxes, scores = model_candidates(pred, m, seed=m)
        for b in batches:
            cases.append((f"shared b{b} C={scores.shape[1]} M={m} t={thr} (model candidates)",
                          boxes[:b].contiguous(), scores[:b].contiguous(), thr, 0.0))
    del boxes, scores
    big_k = exact_k(pred.input_hw[0])
    boxes, scores = model_candidates(pred, big_k, seed=7, per_class=True)
    c = scores.shape[1]
    for b in (BATCH, 1):
        cases.append((f"per-class b{b} C={c} K={big_k} t=0 (model candidates, "
                      "the --exact_nms pools)", boxes[:b].contiguous(), scores[:b].contiguous(),
                      0.0, float("-inf")))
    if not synthetic:
        return cases
    sb, ss = shuffle_pools(boxes, scores, seed=2)
    cases.append((f"per-class b{BATCH} C={c} K={big_k} t=0 (the same pools shuffled: the "
                  "rounds)", sb, ss, 0.0, float("-inf")))
    inv = scores.clone()
    inv[:, -1, -1] = inv[:, -1, -2] + 0.5  # the last class of each image: the rounds
    cases.append((f"per-class b{BATCH} C={c} K={big_k} t=0 (sorted, one inversion at the last "
                  "index of one pool an image)", boxes, inv, 0.0, float("-inf")))
    # beyond the rounds' staging limit: each of 8 images' pools and a copy of
    # them at half the scores, sorted again (the walk) and shuffled (the
    # rounds, boxes read from device memory)
    b8 = 8
    both_b = torch.cat([boxes[:b8], boxes[:b8]], 2)
    both_s, idx = torch.sort(torch.cat([scores[:b8], scores[:b8] * 0.5], 2), dim=-1,
                             descending=True, stable=True)
    both_b = torch.gather(both_b, 2, idx[..., None].expand(-1, -1, -1, 4)).contiguous()
    cases.append((f"per-class b{b8} C={c} K={2 * big_k} t=0 (model candidates twice, sorted)",
                  both_b, both_s.contiguous(), 0.0, float("-inf")))
    sb, ss = shuffle_pools(both_b, both_s, seed=3)
    cases.append((f"per-class b{b8} C={c} K={2 * big_k} t=0.1 (the same shuffled: the rounds "
                  "from device memory)", sb, ss, 0.1, 0.0))
    del boxes, scores, sb, ss, inv, both_b, both_s
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


def nms_exact(boxes, scores, thr, empty=0.0):
    """``suppress`` against ``suppress_plain`` on one pool (max_det 20, IoU
    0.5, threshold ``thr``): returns (equal, max abs err, detections)."""
    import torch

    from yoloret_tpu_torch.ops.nms_kernel import suppress, suppress_plain

    kw = dict(max_det=20, iou_threshold=0.5, score_threshold=thr, empty_score=empty)
    got = suppress(boxes, scores, **kw)
    want = suppress_plain(boxes, scores, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    err = 0.0 if same else max(max_err(torch.nan_to_num(g), torch.nan_to_num(w))
                               for g, w in zip(got, want))
    return same, err, int((got[1] > 0).sum())


def check_nms(pred, report, synthetic=True):
    from yoloret_tpu_torch.ops.nms_kernel import plan_nms

    rows, worst = [], {"small": 0.0, "large": 0.0}
    for name, boxes, scores, thr, empty in nms_cases(pred, synthetic):
        plan = plan_nms(scores.shape[1], scores.shape[2], 20, boxes.dim() == 3)
        same, err, dets = nms_exact(boxes, scores, thr, empty)
        rows.append(dict(case=name, plan=plan._asdict(), max_abs_err=err, exact=same,
                         detections=dets))
        how = {"shared": f"shared-pool kernel ({plan.warps} warps, {plan.classes_per_pass} "
                         f"classes per pass, {plan.smem} B shared memory)",
               "per_class": "per-class kernel (a warp per image and class)",
               "per_class_large": f"large-pool kernels (the walk, a CTA per image and class; "
                                  f"the rounds, {plan.warps} warps, {plan.smem} B shared "
                                  "memory)"}[plan.variant]
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
    suppress.variant_launches.clear()
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
    variant_launches = dict(suppress.variant_launches)
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
    # the shared pool (class stride 0) of both Predictors runs the shared-pool
    # kernel; with the zoom ensemble, the per-class pools (of up to 512) the
    # per-class kernel
    want = "per_class" if pred.zoom_ensemble else "shared"
    variants = {p.num_candidates: plan_nms(len(p.class_names), p.num_candidates, 20,
                                           want == "shared").variant for p in (pred, map_pred)}
    log(f"main path: NMS kernel variant by pool size {variants}, launches by variant "
        f"{variant_launches}")
    assert set(variants.values()) == {want} and variant_launches == {want: forwards}, (
        variants, variant_launches)
    report["main_path"] = dict(detections=counts, http=[len(b["detections"]) for _, b in replies],
                               forwards=forwards, launches=launches, seconds=seconds,
                               nms_variants=variants, nms_variant_launches=variant_launches)
    return launches


def float32_pair(pred, state=None, **extra):
    """Float32 Predictors on the card and on the CPU with ``pred``'s
    backbone and classes, t=0.3, M=64, batch bucket 2 (``extra``: other
    Predictor options)."""
    from yoloret_tpu_torch.infer import Predictor

    kw = dict(backbone=pred.model.backbone, rfcr=pred.model.rfcr_fusion,
              class_names=pred.class_names, anchors=pred.anchors, input_hw=pred.input_hw,
              score_threshold=0.3, num_candidates=64, bf16=False, batch_buckets=(2,), **extra)
    if state is None:
        state = {k: v.cpu() for k, v in pred.model.state_dict().items()}
    return (Predictor(weights=state, device=DEVICE, **kw),
            Predictor(weights=state, device="cpu", **kw))


def two_images(seed):
    import numpy as np

    rs = np.random.RandomState(seed + 1)
    return [rs.randint(0, 256, (240, 320, 3), dtype=np.uint8),
            rs.randint(0, 256, (320, 320, 3), dtype=np.uint8)]


def matched_detections(got, want):
    """How many detections of ``got`` match one of ``want`` image by image
    (class, score rtol 1e-4, box atol 0.05 px), each used once."""

    def same(g, w):
        return (g.class_id == w.class_id and abs(g.score - w.score) <= 1e-4 * abs(w.score)
                and max(abs(a - b) for a, b in zip(g.box, w.box)) <= 0.05)

    n = 0
    for g_img, w_img in zip(got, want):
        free = list(w_img)  # matched, not zipped: scores 1e-6 apart may swap order
        for g in g_img:
            hit = next((w for w in free if same(g, w)), None)
            if hit is not None:
                free.remove(hit)
                n += 1
    return n


def check_against_cpu(pred, seed, report, **extra):
    """float32 Predictor on the card (TF32 off) vs the same weights on the
    CPU (every kernel's plain version) on 2 images at the Predictor's size
    (``extra``: other Predictor options, e.g. the zoom ensemble)."""
    gpu, cpu = float32_pair(pred, **extra)
    ims = two_images(seed)
    got, want = gpu.detect_arrays(ims), cpu.detect_arrays(ims)
    n = matched_detections(got, want)
    counts = ([len(d) for d in got], [len(d) for d in want])
    assert counts[0] == counts[1] and n == sum(counts[1]) > 0, (counts, n)
    log(f"float32 Predictor on the card vs on the CPU, {pred.model.backbone} "
        f"(rfcr {pred.model.rfcr_fusion}) @{pred.input_hw[0]} {extra or ''}: {n} detections "
        "agree (class, score rtol 1e-4, box atol 0.05 px)")
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
        kind = "int8 backbone, bf16 stem and neck" if p._qp is not None else "bf16"
        log(f"{name} {p.model.backbone} (t={p.score_threshold}, M={p.num_candidates}) at "
            f"b{BATCH}@{p.input_hw[0]} {kind}: "
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
    """images, ms/image, images/s and the decodes by decoder from the
    loop's line that ``evaluate_map`` prints (the numbers it does not
    return)."""
    m = re.search(r"eval: (\d+) images, ([\d.]+) ms/image, ([\d.]+) images/s; "
                  r"decoded: native (\d+), PIL (\d+)", text)
    return dict(images=int(m.group(1)), ms_per_image=float(m.group(2)),
                img_per_s=float(m.group(3)),
                decodes={"native": int(m.group(4)), "pil": int(m.group(5))})


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
               mbconv_per_forward=16, flagship=True, root=None):
    """The mAP evaluation path through its entry points (phase 5, and for
    each COCO configuration in phase 8); returns its report, with the
    launch counts of its run on the card. ``config``: the YAML file the
    CLI's run takes with ``--config`` (None: the flagship's flags).
    ``flagship``: the CPU references at BATCH with a bf16 one that the
    card's bf16 mAP is held to, the profiled idle share and the host's
    shares alone; otherwise the CPU runs at CPU_EVAL_BATCH and the bf16
    run on the card is logged. ``root``: a directory to write the
    dataset, the weights and the class and anchor files into and leave
    them there (phase 11 reads them), instead of a temporary one."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from yoloret_tpu_torch import native
    from yoloret_tpu_torch.data import Dataset
    from yoloret_tpu_torch.eval import MAPEvaluator
    from yoloret_tpu_torch.infer import Predictor
    from yoloret_tpu_torch.ops.mbconv import fused_mbconv
    from yoloret_tpu_torch.ops.nms_kernel import suppress

    names = map_pred.class_names
    size = map_pred.input_hw[0]
    native_built = native.available()  # built (or refused, and reported) in phase 1
    report_native = "built" if native_built else "not built"
    kw = dict(backbone=map_pred.model.backbone, rfcr=map_pred.model.rfcr_fusion,
              class_names=names, anchors=map_pred.anchors, input_hw=map_pred.input_hw,
              score_threshold=0.0, num_candidates=512, bf16=False)
    cpu_batch = BATCH if flagship else CPU_EVAL_BATCH
    out = {}
    where = (tempfile.TemporaryDirectory(prefix="yoloret_eval_") if root is None
             else contextlib.nullcontext(root))
    with where as root:
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
        decodes = {name: runs[name]["decodes"] for name in runs}
        log(f"eval decodes by decoder (native JPEG loader {report_native}): {decodes}")
        if native_built:  # every sample is a JPEG: none may fall back to PIL
            for name, d in decodes.items():
                assert d["pil"] == 0 and d["native"] >= n_samples, (name, d)

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
                   samples=n_samples, gt_boxes=n_gt, decodes=decodes)
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
        by = dict(ds.decodes)
        rs = np.random.RandomState(seed)
        n_det = len(names) * 20
        dets = (rs.rand(n_det, 4) * size, rs.rand(n_det), rs.randint(0, len(names), n_det))
        ev = MAPEvaluator(len(names))
        t0 = time.perf_counter()
        for g in gts + gts:
            ev.add_image(*dets, g)
        filing_s = time.perf_counter() - t0
        log(f"  host alone: decode {decoded} samples ({ds.num_workers} threads; by decoder "
            f"{by}) {decode_s * 1e3:.1f} ms = {decoded / decode_s:.1f} images/s; filing "
            f"{n_det} detections an image for {2 * len(gts)} images {filing_s * 1e3:.1f} ms")
        if native_built:
            assert by.get("pil", 0) == 0, by
        out.update(host_decode_s=decode_s, host_decodes=by, host_filing_s=filing_s, profile=dict(
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


def time_mbconv(pred, flush, batch=BATCH, size=None):
    """Each block's kernel, plain and cuDNN times at ``batch`` and
    ``size`` (default: the Predictor's) and its bound and tile plan;
    returns (rows, sums)."""
    import torch

    from yoloret_tpu_torch.ops.mbconv import fused_mbconv, plan_tile, reference_mbconv

    rows, tot = [], dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    with torch.inference_mode():
        ins = block_inputs(pred, batch, seed=12, size=size)
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
    large-pool variant on the exact evaluation's whole grid, its pools
    sorted as the path gives them and the same pools shuffled; returns
    (serving row, MAP-grade row, large-pool row, shuffled large-pool
    row). Bounds by ``nms_bound_ms`` on this run's picks."""
    rows = []
    big_k = exact_k(pred.input_hw[0])
    for m, thr, per_class, order in ((64, 0.3, False, None), (512, 0.0, False, None),
                                     (big_k, 0.0, True, "sorted"),
                                     (big_k, 0.0, True, "shuffled")):
        boxes, scores = model_candidates(pred, m, seed=100 + m, per_class=per_class)
        if order == "shuffled":
            boxes, scores = shuffle_pools(boxes, scores, seed=1)
        pool = f"per-class K={m} {order}" if per_class else f"shared M={m}"
        rows.append(dict(m=m, order=order, **time_nms_case(boxes, scores, thr, flush, pool)))
        del boxes, scores
    return rows


def time_nms_case(boxes, scores, thr, flush, pool):
    """Kernel and plain times of ``suppress`` on one pool (max_det 20, IoU
    0.5, threshold ``thr``; ``pool`` names it in the log) and its bound by
    ``nms_bound_ms`` on this run's picks."""
    import torch

    from yoloret_tpu_torch.ops.nms_kernel import plan_nms, suppress, suppress_plain

    b, c, m = scores.shape
    kw = dict(max_det=20, iou_threshold=0.5, score_threshold=thr)
    plan = plan_nms(c, m, 20, shared=boxes.dim() == 3)
    ms = cuda_time_ms(lambda: suppress(boxes, scores, **kw), 10, 2, flush)
    plain = cuda_time_ms(lambda: suppress_plain(boxes, scores, **kw), 3, 1, flush)
    out_b, out_s = suppress(boxes, scores, empty_score=float("-inf"), **kw)
    bound, by, work = nms_bound_ms(boxes, scores, out_b, out_s, 20, thr)
    log(f"  nms {pool} b{b} C={c} t={thr} ({plan.variant} kernel, {plan.warps} warps, "
        f"{plan.smem} B shared memory): kernel {ms:.4f} ms, plain {plain:.4f}, bound "
        f"{bound:.5f} ({by}; {work['distinct_picks']} distinct picks, {work['rounds']} "
        f"rounds, {work['bytes']} bytes, {work['sorted_pools']} of {work['pools']} pools "
        f"sorted, {work['boxes_needed']} boxes needed); bound counting every box "
        f"{work['bound_ms_all_boxes']:.5f}, per-class count "
        f"{work['bound_ms_per_class_count']:.5f}")
    return dict(batch=b, classes=c, score_threshold=thr, plan=plan._asdict(), ms=ms,
                plain_ms=plain, bound_ms=bound, bound_by=by,
                detections=int(torch.isfinite(out_s).sum()), **work)


def nms_entry(pred, suffix, boxes, scores, launches, where, flush):
    """The kernels line's ``nms_shared`` row of one shape of the main path:
    ``suppress`` held exactly against ``suppress_plain`` on the shared pool
    (boxes, scores) of t=0.3 and timed; ``launches`` the count of the run
    ``where`` names."""
    b, c, m = scores.shape
    same, err, dets = nms_exact(boxes, scores, 0.3)
    log(f"  nms kernel vs plain, shared b{b} C={c} M={m} t=0.3 ({where}): max abs err {err} "
        f"(tolerance 0: exact), {dets} detections")
    if not same or dets == 0:
        raise AssertionError(f"nms b{b} M={m}: kernel differs from plain by {err}, "
                             f"{dets} detections")
    t = time_nms_case(boxes, scores, 0.3, flush, f"shared M={m}")
    return dict(
        name="nms" + suffix, route="cuda", source="yoloret_tpu_torch/csrc/nms.cu",
        replaces="yoloret_tpu/ops/nms_pallas.py:36",
        also_replaces=["yoloret_tpu/ops/postprocess.py:361"],
        shapes=f"shared pool b{b} C={c} M={m} t=0.3 ({pred.model.backbone} "
               f"@{pred.input_hw[0]}); launches: {where}",
        launches=launches, max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None)


def shuffle_pools(boxes, scores, seed):
    """Per-class pools with their candidates in one seeded random order."""
    import torch

    g = torch.Generator(device=boxes.device).manual_seed(seed)
    perm = torch.randperm(scores.shape[-1], generator=g, device=boxes.device)
    return boxes[:, :, perm].contiguous(), scores[:, :, perm].contiguous()


def check_mbconv_at(pred, size, batch, report, key):
    """The bf16 MBConv kernel (the packed weights of the main path) against
    its plain version at all 16 blocks for ``batch`` seeded images at
    ``size``; returns the largest error."""
    import torch

    from yoloret_tpu_torch.ops.mbconv import fused_mbconv, reference_mbconv

    rows, tol = [], MBCONV_TOL["bfloat16"]
    with torch.no_grad():
        for meta, x in zip(pred._fused.blocks, block_inputs(pred, batch, seed=13, size=size)):
            kw = dict(stride=meta.stride, residual=meta.residual)
            got = fused_mbconv(x, *meta.args, packed=meta.packed, **kw)
            want = reference_mbconv(x, *meta.args, **kw)
            torch.cuda.synchronize()
            err = max_err(got, want)
            rows.append(dict(block=meta.block_id, shape=list(x.shape), max_abs_err=err,
                             max_abs_ref=want.float().abs().max().item()))
            if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
                raise AssertionError(f"mbconv block {meta.block_id} bf16 [{batch}, {size}]: "
                                     f"max err {err}")
    report[key] = rows
    worst = max(r["max_abs_err"] for r in rows)
    scale = min(r["max_abs_ref"] for r in rows)
    log(f"  mbconv kernel vs plain, {pred.model.backbone} bf16 [{batch}, {size}, {size}, 3], 16 "
        f"blocks (last map {rows[-1]['shape'][1]}x{rows[-1]['shape'][2]}): max abs err "
        f"{worst:.3g} (tolerance atol=rtol {tol}; smallest block max |out| {scale:.3g})")
    if scale < 0.1:
        raise AssertionError(f"block outputs too small ({scale}) for the check to mean much")
    return worst


def mbconv_entry(pred, suffix, launches, err, mbconv, batch, size, where):
    """The kernels line's MBConv row of one shape: ``mbconv`` is
    ``time_mbconv``'s (rows, sums); ``launches`` the count of the run
    ``where`` names."""
    rows, tot = mbconv
    return dict(
        name="mbconv" + suffix, route="cuda", source="yoloret_tpu_torch/csrc/mbconv.cu",
        replaces="yoloret_tpu/ops/mbconv_pallas.py:76",
        also_replaces=["yoloret_tpu/ops/mbconv_pallas.py:109",
                       "yoloret_tpu/ops/mbconv_pallas2.py:86"],
        shapes=f"the {len(rows)} blocks of one {pred.model.backbone} forward at b{batch}@{size} "
               f"bf16 (times summed); launches: {where}",
        launches=launches, max_abs_err=err, ms=tot["ms"], plain_ms=tot["plain_ms"],
        bound_ms=tot["bound_ms"],
        bound_by=max(("bytes", "operations"),
                     key=lambda by: sum(r["bound_ms"] for r in rows if r["bound_by"] == by)),
        library_ms=tot["library_ms"])


def kernel_entries(pred, suffix, launches, eval_launches, errs, mbconv, nms):
    """The kernels line's rows of one configuration: ``mbconv`` is
    ``time_mbconv``'s (rows, sums) or None, ``nms`` ``time_nms``'s rows."""
    size, c = pred.input_hw[0], len(pred.class_names)
    out = []
    if mbconv is not None:
        row = mbconv_entry(pred, suffix, launches["mbconv"], errs["mbconv"], mbconv, BATCH, size,
                           "the main path's drive")
        row["eval_launches"] = eval_launches["mbconv"]
        out.append(row)
    serving, mapg, large, shuffled = nms
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
               f"--exact_nms eval's at {size}, sorted as the path gives them); shuffled_*: the "
               "same pools shuffled; launches: the eval path's run",
        launches=eval_launches.get("nms_per_class_large", 0), max_abs_err=errs["nms_large"],
        ms=large["ms"], plain_ms=large["plain_ms"], bound_ms=large["bound_ms"],
        bound_by=large["bound_by"], library_ms=None,
        bound_ms_all_boxes=large["bound_ms_all_boxes"], shuffled_ms=shuffled["ms"],
        shuffled_plain_ms=shuffled["plain_ms"], shuffled_bound_ms=shuffled["bound_ms"],
        shuffled_bound_by=shuffled["bound_by"]))
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
    own shapes (phase 8); returns its rows of the kernels line."""
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
    """The rest of the backbone registry (phase 9): each backbone (and
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


# -- phase 7: training -------------------------------------------------------


def train_batch(size, batch, num_classes, anchors, seed, device):
    """A seeded training batch at ``size``: uniform images and 6 boxes an
    image (5 of them valid), with the targets the data path builds."""
    import numpy as np
    import torch

    from yoloret_tpu_torch.ops.targets import assign_targets_batch, true_corner_boxes

    rs = np.random.RandomState(seed)
    boxes = np.zeros((batch, 6, 5), np.float32)
    xy = rs.uniform(0, size * 0.7, (batch, 5, 2))
    wh = rs.uniform(size * 0.05, size * 0.4, (batch, 5, 2))
    boxes[:, :5, :2] = xy
    boxes[:, :5, 2:4] = np.minimum(xy + wh, size - 1)
    boxes[:, :5, 4] = rs.randint(0, num_classes, (batch, 5))
    b = torch.from_numpy(boxes).to(device)
    a = torch.as_tensor(np.asarray(anchors, np.float32), device=device)
    ys = assign_targets_batch(b, (size, size), a, num_classes)
    gt, gv = true_corner_boxes(b, (size, size))
    g = torch.Generator(device=device).manual_seed(seed)
    out = {"images": torch.rand((batch, size, size, 3), generator=g, device=device),
           "gt_boxes": gt, "gt_valid": gv}
    out.update({f"y_true_{l}": y for l, y in enumerate(ys)})
    return out


def grad_diffs(names, card, cpu, card64, ref):
    """Per-leaf gradients of one step against the CPU's float64 ``ref``,
    for every leaf above TRAIN_GRAD_NOISE: the card's float64 gradient's
    largest ||g - ref|| / ||ref|| and its leaf; that distance of the card's
    and the CPU's float32 gradients, their medians over the leaves and
    the ratio of the medians, and their largest; and the leaves left out."""
    norms = [float(r.norm()) for r in ref]
    top = max(norms)
    noise, kept, rel64, card_rel, cpu_rel = [], [], [], [], []
    for n, c, p, c64, r, nr in zip(names, card, cpu, card64, ref, norms):
        if nr <= TRAIN_GRAD_NOISE * top:
            noise.append(n)
            continue
        kept.append(n)
        rel64.append(float((c64 - r).norm()) / nr)
        card_rel.append(float((c.double() - r).norm()) / nr)
        cpu_rel.append(float((p.double() - r).norm()) / nr)

    def median(v):
        return sorted(v)[len(v) // 2]

    return dict(grad64_rel=max(rel64), grad64_worst_leaf=kept[rel64.index(max(rel64))],
                grad_card_median=median(card_rel), grad_cpu_median=median(cpu_rel),
                grad_median_ratio=median(card_rel) / median(cpu_rel),
                grad_card_max=max(card_rel), grad_cpu_max=max(cpu_rel),
                grad_leaves=len(kept), grad_noise_leaves=noise)


def state_diffs(card, cpu):
    """Card-vs-CPU differences after one Adam step: the share of the
    parameters within 1e-5 + 1e-4 relative (Adam's first step moves an
    element by lr times the sign of its gradient, so this holds the
    update, not the gradient's size), and the largest difference of a
    running statistic over the larger of its leaf's largest magnitude
    and TRAIN_STATS_FLOOR of the model's largest statistic of its kind."""
    kinds = ("running_mean", "running_var")
    tops = {kind: max(float(v.abs().max()) for k, v in cpu.items() if k.endswith(kind))
            for kind in kinds}
    close = n = 0
    stat_rel = 0.0
    for k, want in cpu.items():
        d = (card[k].cpu() - want).abs()
        kind = next((x for x in kinds if k.endswith(x)), None)
        if kind:
            scale = max(float(want.abs().max()), TRAIN_STATS_FLOOR * tops[kind])
            stat_rel = max(stat_rel, float(d.max()) / scale)
            continue
        close += int((d <= 1e-5 + 1e-4 * want.abs()).sum())
        n += want.numel()
    return dict(param_close_share=close / n, stat_rel=stat_rel)


def check_train_step(weights, seed, report):
    """One float32 train step (TF32 off) of the flagship at full width, b8,
    on the card and on the CPU from the same weights and batch, and the
    same step at float64 compute on both (``grad_diffs``): stage 2, then
    stage 1, where the frozen parameters and the body's statistics must
    come out bitwise unchanged on the card."""
    import torch

    from yoloret_tpu_torch.nn.detector import YoloReT
    from yoloret_tpu_torch.train.freeze import FROZEN, backbone_freeze_mask
    from yoloret_tpu_torch.train.step import StepConfig, TrainState, cosine_lr_schedule
    from yoloret_tpu_torch.train.step import step_gradients

    batch = train_batch(SIZE, TRAIN_CPU_BATCH, NUM_CLASSES, ANCHORS, seed, "cpu")
    out = {}
    for stage in (2, 1):
        runs = {}
        for dev, dtype in (("cpu", torch.float64), ("cpu", torch.float32),
                           (DEVICE, torch.float64), (DEVICE, torch.float32)):
            model = YoloReT("mobilenetv2x75", NUM_CLASSES, dtype=dtype)
            model.load_state_dict(weights)
            model.to(dev)
            labels = (backbone_freeze_mask(n for n, _ in model.named_parameters())
                      if stage == 1 else None)
            state = TrainState(model, cosine_lr_schedule(TRAIN_LR, 2, 1), labels)
            before = {k: v.clone() for k, v in model.state_dict().items()}
            t0 = time.perf_counter()
            data = {k: v.to(dev, dtype) if k.startswith("y_true") else v.to(dev)
                    for k, v in batch.items()}
            grads, m = step_gradients(state, data,
                                      StepConfig(anchors=tuple(map(tuple, ANCHORS)),
                                                 backbone_train=stage == 2))
            state.apply_gradients(grads)
            loss = float(m["loss"])
            runs[dev, dtype] = dict(
                sd={k: v.detach().cpu() for k, v in model.state_dict().items()},
                grads=[g.detach().cpu() for g in grads], names=state.names, before=before,
                loss=loss, labels=labels, seconds=time.perf_counter() - t0)
        ref, cpu, card = (runs["cpu", torch.float64], runs["cpu", torch.float32],
                          runs[DEVICE, torch.float32])
        d = grad_diffs(card["names"], card["grads"], cpu["grads"],
                       runs[DEVICE, torch.float64]["grads"], ref["grads"])
        d.update(state_diffs(card["sd"], cpu["sd"]))
        d.update(loss_card=card["loss"], loss_cpu=cpu["loss"],
                 loss_rel=abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
                 cpu_seconds=cpu["seconds"], cpu_f64_seconds=ref["seconds"])
        if stage == 1:
            frozen = [k for k, lab in card["labels"].items() if lab == FROZEN]
            stats = [k for k in card["sd"] if k.startswith("body.") and "running" in k]
            d["frozen_unchanged"] = all(torch.equal(card["sd"][k], card["before"][k].cpu())
                                        for k in frozen + stats)
            d["frozen_leaves"], d["body_stats"] = len(frozen), len(stats)
            assert d["frozen_unchanged"], "stage 1 moved a frozen leaf or a body statistic"
        log(f"train step f32 card vs CPU, stage {stage}, {NUM_CLASSES} classes b"
            f"{TRAIN_CPU_BATCH}@{SIZE}: loss {card['loss']:.6f} vs {cpu['loss']:.6f} (rel "
            f"{d['loss_rel']:.2e}); gradients vs the CPU's float64 step, {d['grad_leaves']} "
            f"leaves ({len(d['grad_noise_leaves'])} at noise left out): the card's float64 "
            f"within {d['grad64_rel']:.2e} (limit {TRAIN_GRAD64_RTOL:g}) at "
            f"{d['grad64_worst_leaf']}; float32 card vs CPU: median leaf "
            f"{d['grad_card_median']:.2e} vs {d['grad_cpu_median']:.2e} (ratio "
            f"{d['grad_median_ratio']:.2f}, limit {TRAIN_GRAD_PREC_RATIO:g}), largest "
            f"{d['grad_card_max']:.2e} vs {d['grad_cpu_max']:.2e}; parameters after the step: "
            f"{d['param_close_share']:.5%} within 1e-5 + 1e-4 rel; statistics: largest "
            f"diff/scale {d['stat_rel']:.2e}"
            + (f"; {d['frozen_leaves']} frozen leaves and {d['body_stats']} body statistics "
               "bitwise unchanged" if stage == 1 else ""))
        assert d["loss_rel"] <= TRAIN_LOSS_RTOL, d
        assert d["grad64_rel"] <= TRAIN_GRAD64_RTOL, d
        assert d["grad_median_ratio"] <= TRAIN_GRAD_PREC_RATIO, d
        assert d["stat_rel"] <= TRAIN_STATS_RTOL, d
        assert d["param_close_share"] >= TRAIN_PARAM_CLOSE_SHARE, d
        out[f"stage{stage}"] = d
    report["train_step_check"] = out


def train_cli_phase(weights, seed, report):
    """The CLI's TRAIN on the card, flagship config (bf16, b32 @320): stage 1
    on a seeded JPEG set with a validation loss and the stage-end mAP, then
    stage 2 from stage 1's file; then ``--mode=MAP --model=<final file>``
    on the same test set, and the MBConv kernel on the trained weights.
    Launch counts set to 0 before the two TRAIN runs and read after."""
    import numpy as np

    from yoloret_tpu_torch.cli.main import main as cli_main
    from yoloret_tpu_torch.infer import Predictor
    from yoloret_tpu_torch.ops.mbconv import fused_mbconv
    from yoloret_tpu_torch.ops.nms_kernel import suppress
    from yoloret_tpu_torch.utils.checkpoint import load_params

    out = {}
    with tempfile.TemporaryDirectory(prefix="yoloret_train_") as root:
        t0 = time.perf_counter()
        images = write_eval_images(root, seed + 7, TRAIN_IMAGES)
        cpu = Predictor(weights=weights, device="cpu", class_names=[
            f"class_{i}" for i in range(NUM_CLASSES)], anchors=ANCHORS,
            input_hw=(SIZE, SIZE), score_threshold=0.0, num_candidates=512, bf16=False)
        gts = eval_ground_truth(cpu, images, root, TRAIN_E2E_BATCH)
        del cpu
        lst = os.path.join(root, "train.txt")
        with open(lst, "w") as f:
            for (path, _), gt in zip(images, gts):
                f.write(path + "".join(" {!r},{!r},{!r},{!r},{}".format(
                    *map(float, g[:4]), int(g[4])) for g in gt) + "\n")
        out["setup_seconds"] = time.perf_counter() - t0
        logs = os.path.join(root, "logs")
        config = os.path.join(HERE, TRAIN_CONFIG)
        argv = ["--mode=TRAIN", f"--config={config}", f"--train_dataset={lst}",
                f"--val_dataset={lst}", f"--test_dataset={lst}",
                f"--batch_size={TRAIN_E2E_BATCH}", "--epochs", *map(str, TRAIN_EPOCHS),
                f"--log_dir={logs}", f"--seed={seed}"]
        stage_dirs = [os.path.join(logs, f"mobilenetv2x75_stage{s}") for s in (1, 2)]
        w1 = os.path.join(stage_dirs[0], "mobilenetv2x75_trained_weights_stage_1.pt")
        final = os.path.join(stage_dirs[1], "mobilenetv2x75_trained_weights_final.pt")
        fused_mbconv.launches = suppress.launches = 0
        t0 = time.perf_counter()
        for extra in ([], [f"--train_unfreeze={w1}"]):
            rc, _ = run_printing(cli_main, argv + extra)
            assert rc == 0, f"the CLI's TRAIN mode returned {rc}"
        out["train_seconds"] = time.perf_counter() - t0
        launches = {"mbconv": fused_mbconv.launches, "nms": suppress.launches}
        stages = []
        for d in stage_dirs:
            with open(os.path.join(d, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            epochs = [r for r in recs if "loss" in r]
            stages.append(dict(loss=[r["loss"] for r in epochs],
                               val_loss=[r["val_loss"] for r in epochs],
                               img_per_s=[r["images_per_sec"] for r in epochs],
                               map=[r["mAP"] for r in recs if "mAP" in r]))
        out["stages"] = stages
        map_batches = -(-len(images) // TRAIN_E2E_BATCH)
        out["launches"] = launches
        for i, st in enumerate(stages, start=1):
            log(f"  TRAIN stage {i}: loss by epoch {[round(v, 4) for v in st['loss']]}, "
                f"val loss {[round(v, 4) for v in st['val_loss']]}, img/s "
                f"{st['img_per_s']} (decode and augmentation included), stage-end mAP "
                f"{st['map'][-1]:.6f}")
        log(f"  TRAIN launches {launches} over 2 stage-end mAP passes of {map_batches} batches "
            f"({out['train_seconds']:.1f} s for both stages)")
        assert launches == {"mbconv": 16 * 2 * map_batches, "nms": 2 * map_batches}, launches
        loss1 = stages[0]["loss"]
        assert all(np.isfinite(v) for st in stages for v in st["loss"] + st["val_loss"])
        assert loss1[-1] < loss1[0], f"stage-1 loss did not fall: {loss1}"
        rc, text = run_printing(cli_main, [
            "--mode=MAP", f"--config={config}", f"--model={final}",
            f"--test_dataset={lst}", f"--batch_size={TRAIN_E2E_BATCH}"])
        assert rc == 0, f"the CLI's MAP mode returned {rc}"
        map_cli = float(re.search(r"^mAP: ([\d.]+)$", text, re.M).group(1))
        out["map_cli"], out["map_trainer"] = map_cli, stages[1]["map"][-1]
        log(f"  MAP --model=<final file>: mAP {map_cli:.6f} vs the trainer's stage-end "
            f"{out['map_trainer']:.6f}")
        assert abs(map_cli - out["map_trainer"]) <= 1e-6, (map_cli, out["map_trainer"])
        trained = make_predictor(seed, weights=load_params(final))
        import torch

        with torch.no_grad():
            out["mbconv_err"] = check_mbconv(trained, report, key="mbconv_trained_check")
        del trained
        out["anchors"] = anchors_cli(root, lst)
        warm = os.path.join(root, "flagship.pt")
        torch.save(weights, warm)
        report["train_options"] = train_options_phase(root, lst, config, warm, seed, report,
                                                      stages[0]["img_per_s"], map_batches)
    report["train_cli"] = out


def anchors_cli(root, lst):
    """The CLI's ANCHORS on the train list; its file must equal the one
    ``kmeans_anchors`` writes from the same boxes in this process."""
    from yoloret_tpu_torch.cli.main import main as cli_main
    from yoloret_tpu_torch.tools.kmeans import boxes_wh_from_lists, kmeans_anchors, write_anchors

    got, want = os.path.join(root, "anchors_cli.txt"), os.path.join(root, "anchors_ref.txt")
    rc, text = run_printing(cli_main, ["--mode=ANCHORS", f"--train_dataset={lst}",
                                       f"--output={got}"])
    assert rc == 0, f"the CLI's ANCHORS mode returned {rc}"
    anchors, _ = kmeans_anchors(boxes_wh_from_lists(lst))
    write_anchors(want, anchors)
    with open(got) as f, open(want) as g:
        line, ref = f.read(), g.read()
    log(f"  ANCHORS on the train list: {text.strip().splitlines()[0]}; {line.strip()}")
    assert line == ref, (line, ref)
    return line.strip()


def tb_image_sizes(log_dir):
    """(tag, PNG size) of each image summary in the event files under
    ``log_dir``, in the order written."""
    from PIL import Image

    from yoloret_tpu_torch.data.tfrecord import index_tfrecord, read_record_at

    out = []
    for name in sorted(os.listdir(log_dir)):
        path = os.path.join(log_dir, name)
        for off, ln in index_tfrecord(path):
            rec = read_record_at(path, off, ln)
            if b"\x89PNG" in rec:
                tag = re.search(rb"train_input/\d+", rec).group().decode()
                with Image.open(io.BytesIO(rec[rec.index(b"\x89PNG"):])) as im:
                    out.append((tag, im.size))
    return out


def train_options_phase(root, lst, config, warm, seed, report, plain, map_batches):
    """The CLI's TRAIN with the options of ROADMAP item 4c (AutoAugment v0,
    mosaic and mixup 0.5, multi-scale OPTIONS_SIZES, TB_IMAGES detection
    rows an epoch), one stage-1 epoch per size from the weight file
    ``warm`` (the calibrated flagship weights, so that the frozen
    backbone's activations are not the seeded init's vanishing ones), on
    the same data as the plain run (whose stage-1 epoch img/s are
    ``plain``), with the validation loss and the stage-end mAP
    (``map_batches`` batches); launch counts set to 0 just before and read
    just after (16 MBConv + 1 NMS for each epoch's detection pass and each
    mAP batch). Then the MBConv kernel against its plain version on the
    trained weights at [TB_IMAGES, size] for each size, the host stream's
    cost of AutoAugment (one epoch, decode included, with and without
    it), mix_batch on the card against the CPU on one batch with the same
    draws and its device time, and at each size the MBConv kernel's times
    and the NMS kernel held exactly against its plain version on a pool
    of 256 of TB_IMAGES seeded images and timed. Returns the report's
    entry; the kernel rows (their launches: the whole options run's) go to
    ``report["options_kernels"]``."""
    import numpy as np
    import torch

    from yoloret_tpu_torch.cli.main import main as cli_main
    from yoloret_tpu_torch.data import Dataset, DatasetMode
    from yoloret_tpu_torch.data.augment import AugmentConfig, draw_mix, mix_batch
    from yoloret_tpu_torch.ops.mbconv import fused_mbconv
    from yoloret_tpu_torch.ops.nms_kernel import suppress
    from yoloret_tpu_torch.utils.checkpoint import load_params

    t_phase = time.perf_counter()
    out = {}
    logs = os.path.join(root, "logs_options")
    argv = ["--mode=TRAIN", f"--config={config}", f"--train_dataset={lst}",
            f"--val_dataset={lst}", f"--test_dataset={lst}",
            f"--batch_size={TRAIN_E2E_BATCH}", f"--model={warm}", "--epochs",
            str(len(OPTIONS_SIZES)), "1", f"--log_dir={logs}", f"--seed={seed}",
            "--autoaugment_policy=v0", "--mosaic=0.5", "--mixup=0.5", "--multi_scale",
            *map(str, OPTIONS_SIZES), f"--tb_images={TB_IMAGES}"]
    fused_mbconv.launches = suppress.launches = 0
    t0 = time.perf_counter()
    rc, text = run_printing(cli_main, argv)
    out["seconds"] = time.perf_counter() - t0
    launches = out["launches"] = {"mbconv": fused_mbconv.launches, "nms": suppress.launches}
    assert rc == 0, f"the CLI's TRAIN mode with the options returned {rc}"
    stage = os.path.join(logs, "mobilenetv2x75_stage1")
    with open(os.path.join(stage, "metrics.jsonl")) as f:
        epochs = [r for r in map(json.loads, f) if "loss" in r]
    sizes = [int(m) for m in re.findall(r"^epoch \d+: input size \((\d+), \d+\)$", text, re.M)]
    images = tb_image_sizes(os.path.join(stage, "tb"))
    out.update(loss=[r["loss"] for r in epochs], val_loss=[r["val_loss"] for r in epochs],
               img_per_s=[r["images_per_sec"] for r in epochs], plain_img_per_s=plain,
               sizes=sizes, tb_images=images)
    log(f"  TRAIN with AutoAugment v0, mosaic 0.5, mixup 0.5, multi-scale {sizes}, tb_images "
        f"{TB_IMAGES}: loss by epoch {[round(v, 4) for v in out['loss']]}, val loss "
        f"{[round(v, 4) for v in out['val_loss']]}, img/s {out['img_per_s']} (the plain run's "
        f"stage-1 epochs at {SIZE}: {plain}); {len(images)} image summaries "
        f"{sorted(set(images), key=images.index)}; launches {launches}; {out['seconds']:.1f} s")
    assert sizes == list(OPTIONS_SIZES), sizes
    assert all(np.isfinite(v) for v in out["loss"] + out["val_loss"]), out
    assert [size for _, size in images] == [(s, s) for s in OPTIONS_SIZES
                                            for _ in range(TB_IMAGES)], images
    forwards = len(OPTIONS_SIZES) + map_batches  # the detection passes and the stage-end mAP
    assert launches == {"mbconv": 16 * forwards, "nms": forwards}, launches

    trained = make_predictor(seed, weights=load_params(
        os.path.join(stage, "mobilenetv2x75_trained_weights_stage_1.pt")))
    errs = {size: check_mbconv_at(trained, size, TB_IMAGES, report,
                                  f"mbconv_trained_check_{size}_b{TB_IMAGES}")
            for size in OPTIONS_SIZES}
    out["mbconv_err"] = errs

    host = {}
    for policy in (None, "v0"):
        ds = Dataset(lst, TRAIN_E2E_BATCH, input_hw=(SIZE, SIZE), mode=DatasetMode.TRAIN,
                     device=DEVICE, anchors=ANCHORS, num_classes=NUM_CLASSES, seed=seed,
                     aa_policy=policy)
        t0 = time.perf_counter()
        n = sum(len(b["images"]) for b in ds._host_batches(epochs=1))
        host[policy or "none"] = (time.perf_counter() - t0) * 1e3 / n
    out["host_ms_per_image"] = host
    log(f"  host stream alone, one epoch of {n} images at {SIZE} (8 decode threads): "
        f"{host['none']:.3f} ms/image plain, {host['v0']:.3f} with AutoAugment v0")

    rs = np.random.RandomState(seed)
    b, size, t = TRAIN_E2E_BATCH, OPTIONS_SIZES[-1], 20
    lo = rs.uniform(0, size * 0.8, (b, t, 2))
    cpu_in = (torch.from_numpy(rs.rand(b, size, size, 3).astype(np.float32)),
              torch.from_numpy(np.concatenate([lo, lo + rs.uniform(1, size * 0.4, (b, t, 2)),
                                               rs.randint(0, NUM_CLASSES, (b, t, 1))], -1)
                               .astype(np.float32)),
              torch.from_numpy(rs.rand(b, t) < 0.6))
    cfg = AugmentConfig(input_hw=(size, size), mosaic_prob=0.5, mixup_prob=0.5)
    draws = draw_mix(b, cfg, torch.Generator().manual_seed(seed), torch.device("cpu"))
    want = mix_batch(*cpu_in, cfg, draws)
    card_in = [v.to(DEVICE) for v in cpu_in]
    card_draws = {k: v.to(DEVICE) for k, v in draws.items()}
    got = [v.cpu() for v in mix_batch(*card_in, cfg, card_draws)]
    mix = dict(image_err=max_err(got[0], want[0]), box_err=max_err(got[1], want[1]),
               valid_equal=torch.equal(got[2], want[2]),
               mosaic_rows=int(draws["do_mosaic"].sum()), mixup_rows=int(draws["do_mixup"].sum()),
               ms=cuda_time_ms(lambda: mix_batch(*card_in, cfg, card_draws), 10, 2))
    out["mix_batch"] = mix
    log(f"  mix_batch card vs CPU, b{b}@{size}, {mix['mosaic_rows']} mosaic and "
        f"{mix['mixup_rows']} mixup rows: images max abs err {mix['image_err']:.3g} (tolerance "
        f"{MIX_TOL:g}), boxes {mix['box_err']:.3g} px ({MIX_BOX_TOL:g}), valid equal "
        f"{mix['valid_equal']}; {mix['ms']:.4f} ms on the card (CUDA events)")
    assert mix["image_err"] <= MIX_TOL and mix["box_err"] <= MIX_BOX_TOL and mix["valid_equal"]
    assert 0 < mix["mosaic_rows"] < b and mix["mixup_rows"] > 0, mix

    flush = make_flush()
    where = (f"the whole options run: {len(OPTIONS_SIZES)} --tb_images passes at b{TB_IMAGES} "
             f"(one at each of {list(OPTIONS_SIZES)}; NMS M=256) and {map_batches} stage-end mAP "
             f"batches at {SIZE} (NMS M=512)")
    report["options_kernels"] = []
    for size in OPTIONS_SIZES:
        report["options_kernels"] += [
            mbconv_entry(trained, f"@{size}_b{TB_IMAGES}", launches["mbconv"], errs[size],
                         time_mbconv(trained, flush, batch=TB_IMAGES, size=size), TB_IMAGES,
                         size, where),
            nms_entry(trained, f"@{size}_b{TB_IMAGES}",
                      *model_candidates(trained, 256, seed=14, batch=TB_IMAGES, size=size),
                      launches["nms"], where, flush)]
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"  TRAIN options phase done in {out['phase_seconds']:.1f} s")
    return out


def image_phase(state, seed, report):
    """The CLI's IMAGE on the port's demo photo with the flagship weights
    (bf16, the user's default; launch counts set to 0 just before and read
    just after: 16 MBConv + 1 NMS), the float32 Predictor's detections on
    it card vs CPU, the MBConv kernel against its plain version at batch
    1, the batch-1 latency of ``detect_arrays`` (host clock, letterbox and
    readback included) and of ``infer`` (CUDA events), the MBConv
    kernel's times at b1, and the NMS kernel held exactly against its plain
    version on the demo photo's pool of 256 and timed. Returns the kernels
    line's two rows."""
    import numpy as np
    import torch
    from PIL import Image

    from yoloret_tpu_torch.cli.main import demo_image
    from yoloret_tpu_torch.cli.main import main as cli_main
    from yoloret_tpu_torch.infer import Predictor
    from yoloret_tpu_torch.ops.letterbox import letterbox_numpy_u8
    from yoloret_tpu_torch.ops.mbconv import fused_mbconv
    from yoloret_tpu_torch.ops.nms_kernel import suppress

    t_phase = time.perf_counter()
    out = {}
    names = [f"class_{i}" for i in range(NUM_CLASSES)]
    demo = demo_image()
    with tempfile.TemporaryDirectory(prefix="yoloret_image_") as root:
        weights = os.path.join(root, "flagship.pt")
        torch.save(state, weights)
        with open(os.path.join(root, "classes.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
        with open(os.path.join(root, "anchors.txt"), "w") as f:
            f.write(", ".join(f"{w},{h}" for w, h in ANCHORS) + "\n")
        png = os.path.join(root, "demo_out.png")
        fused_mbconv.launches = suppress.launches = 0
        rc, text = run_printing(cli_main, [
            "--mode=IMAGE", f"--model={weights}", f"--classes_path={root}/classes.txt",
            f"--anchors_path={root}/anchors.txt", f"--score={IMAGE_SCORE}", f"--output={png}"])
        launches = out["launches"] = {"mbconv": fused_mbconv.launches, "nms": suppress.launches}
        assert rc == 0, f"the CLI's IMAGE mode returned {rc}"
        lines = text.strip().splitlines()
        with Image.open(png) as im, Image.open(demo) as src:
            assert im.size == src.size, (im.size, src.size)
        out["cli_lines"] = lines
    log(f"IMAGE (CLI, bf16, score {IMAGE_SCORE}) on {os.path.relpath(demo, HERE)}: {lines[0]}, "
        f"{len(lines) - 2} detections, {lines[-1].split('/')[-1]} written; launches {launches}")
    assert lines[-1].startswith("wrote ") and launches == {"mbconv": 16, "nms": 1}, launches

    kw = dict(class_names=names, anchors=ANCHORS, input_hw=(SIZE, SIZE),
              score_threshold=IMAGE_SCORE, bf16=False)
    with contextlib.redirect_stdout(io.StringIO()):
        got = Predictor(weights=state, device=DEVICE, **kw).detect_image(demo, draw=False)[1]
        want = Predictor(weights=state, device="cpu", **kw).detect_image(demo, draw=False)[1]

    def same(g, w):
        return (g.class_id == w.class_id and abs(g.score - w.score) <= 1e-4 * abs(w.score)
                and max(abs(a - b) for a, b in zip(g.box, w.box)) <= IMAGE_BOX_TOL)

    assert len(got) == len(want) > 0, (len(got), len(want))
    free = list(want)
    for g in got:
        hit = next((w for w in free if same(g, w)), None)
        assert hit is not None, f"no CPU detection matches {g}"
        free.remove(hit)
    out["float32_detections"] = len(got)
    log(f"  IMAGE float32 card vs CPU: {len(got)} detections agree (class, score rtol 1e-4, box "
        f"atol {IMAGE_BOX_TOL} px)")

    pred = make_predictor(seed, weights=state, score_threshold=IMAGE_SCORE)
    err = check_mbconv_at(pred, SIZE, 1, report, "mbconv_check_320_b1")
    arr = np.asarray(Image.open(demo).convert("RGB"))
    for _ in range(IMAGE_WARMUP):
        pred.detect_arrays([arr])
    wall = []
    for _ in range(IMAGE_TIMED):
        t0 = time.perf_counter()
        pred.detect_arrays([arr])
        wall.append((time.perf_counter() - t0) * 1e3)
    wall.sort()
    x = torch.from_numpy(letterbox_numpy_u8(arr, pred.input_hw)[None]).to(DEVICE)
    hw = torch.tensor([arr.shape[:2]], dtype=torch.float32, device=DEVICE)
    with torch.inference_mode():
        infer_ms = cuda_time_ms(lambda: pred.infer(x, hw), 20, 3)
    out["latency_ms"] = dict(median=wall[len(wall) // 2], p90=wall[int(len(wall) * 0.9)],
                             mean=sum(wall) / len(wall), infer_cuda_events=infer_ms)
    lat = out["latency_ms"]
    log(f"  IMAGE batch-1 latency, bf16 @{SIZE}, score {IMAGE_SCORE}, M={pred.num_candidates}: "
        f"detect_arrays median {lat['median']:.3f} ms, p90 {lat['p90']:.3f}, mean "
        f"{lat['mean']:.3f} over {IMAGE_TIMED} calls (host clock: letterbox, upload, forward, "
        f"NMS, readback); infer {infer_ms:.3f} ms (CUDA events)")
    flush = make_flush()
    rows = [mbconv_entry(pred, f"@{SIZE}_b1", launches["mbconv"], err,
                         time_mbconv(pred, flush, batch=1), 1, SIZE, "the CLI's IMAGE run"),
            nms_entry(pred, f"@{SIZE}_b1",
                      *model_candidates(pred, pred.num_candidates, 0, images=x, image_hw=hw),
                      launches["nms"], "the CLI's IMAGE run (pool: the demo photo's)", flush)]
    out["seconds"] = time.perf_counter() - t_phase
    log(f"IMAGE phase done in {out['seconds']:.1f} s")
    report["image"] = out
    return rows


def step_kernel_ms(prof):
    """Device ms of a profiled run's CUDA kernels: in all, and by group
    and kernel name; and their number. A kernel belongs to the aten op that launched it;
    the op is the optimizer's if it or an ancestor is a ``_foreach_`` op,
    the backward's if an ancestor is an autograd engine function (the
    backward runs on the engine's thread), else the forward's."""
    from torch.autograd import DeviceType

    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    total = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    groups = {"forward": {}, "backward": {}, "optimizer": {}}
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        group, a = "forward", e
        while a is not None:
            if a.name.startswith("aten::_foreach_"):
                group = "optimizer"
                break
            if a.name.startswith("autograd::engine::evaluate_function"):
                group = "backward"
                break
            a = a.cpu_parent
        for k in e.kernels:
            groups[group][k.name] = groups[group].get(k.name, 0.0) + k.duration / 1e3
    return total, groups, len(kernels)


def train_throughput(report):
    """Train-step img/s of each shipped config at its own width, input and
    batch, bf16, stage 1 and stage 2: TRAIN_WARMUP steps, then
    TRAIN_TIMED steps each between two CUDA events (no readback in the
    loop). Then 3 steps under the profiler: their device time (every
    kernel's), over the timed steps' mean time the device busy share (the
    profiler's own host work slows the profiled steps, so their span
    would understate it), and the device ms and top kernels of the
    forward (the loss included), the backward and the optimizer
    (``step_kernel_ms``)."""
    import torch
    import yaml
    from torch.profiler import ProfilerActivity, profile

    from yoloret_tpu_torch.data import load_anchors, load_classes
    from yoloret_tpu_torch.nn.detector import YoloReT
    from yoloret_tpu_torch.nn.layers import init_weights
    from yoloret_tpu_torch.train.freeze import backbone_freeze_mask
    from yoloret_tpu_torch.train.step import (StepConfig, TrainState, cosine_lr_schedule,
                                              train_step)

    def top(d, n=5):
        return [(k[:80], round(v, 4)) for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]

    out = {}
    for cfg_path in TRAIN_CONFIGS:
        with open(os.path.join(HERE, cfg_path)) as f:
            c = yaml.safe_load(f)
        size, batch = int(c["input_size"][0]), int(c["batch_size"])
        names = load_classes(os.path.join(HERE, c["classes_path"]))
        anchors = load_anchors(os.path.join(HERE, c["anchors_path"]))
        model = YoloReT(c["backbone"], len(names), dtype=torch.bfloat16)
        init_weights(model, torch.Generator().manual_seed(0))
        model.to(DEVICE)
        data = train_batch(size, batch, len(names), anchors, 1, DEVICE)
        for stage in (1, 2):
            labels = (backbone_freeze_mask(n for n, _ in model.named_parameters())
                      if stage == 1 else None)
            state = TrainState(model, cosine_lr_schedule(1e-3, 100, 100), labels)
            scfg = StepConfig(anchors=tuple(map(tuple, anchors.tolist())),
                              backbone_train=stage == 2)
            for _ in range(TRAIN_WARMUP):
                train_step(state, data, scfg)
            torch.cuda.synchronize()
            events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                      for _ in range(TRAIN_TIMED)]
            t0 = time.perf_counter()
            for a, b in events:
                a.record()
                train_step(state, data, scfg)
                b.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ms = [a.elapsed_time(b) for a, b in events]
            img_s = batch * TRAIN_TIMED / (sum(ms) / 1e3)

            torch.cuda.synchronize()
            t_prof = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(3):
                    train_step(state, data, scfg)
                torch.cuda.synchronize()
                span = (time.perf_counter() - t0) * 1e3
            busy_total, groups, n_kernels = step_kernel_ms(prof)
            t_prof = time.perf_counter() - t_prof
            busy = busy_total / 3
            per = {g: {k: v / 3 for k, v in d.items()} for g, d in groups.items()}
            fwd, bwd, opt = per["forward"], per["backward"], per["optimizer"]
            key = f"{os.path.basename(cfg_path)[:-5]} stage{stage}"
            out[key] = dict(
                backbone=c["backbone"], size=size, batch=batch, classes=len(names),
                step_ms=ms, img_per_s=img_s, wall_s=wall, profile_s=t_prof,
                busy_ms_per_step=busy, kernels_per_step=n_kernels / 3,
                # the steps' device time over their time by CUDA events, unprofiled
                busy_share=busy / (sum(ms) / len(ms)) if busy else None,
                busy_share_profiled=busy_total / span if busy else None,
                forward_ms=sum(fwd.values()), backward_ms=sum(bwd.values()),
                optimizer_ms=sum(opt.values()),
                top={"forward": top(fwd), "backward": top(bwd), "optimizer": top(opt)})
            r = out[key]
            r["unsplit_ms"] = busy - r["forward_ms"] - r["backward_ms"] - r["optimizer_ms"]
            log(f"  train {key} (profiled in {t_prof:.1f} s): {c['backbone']} "
                f"b{batch}@{size} bf16: {img_s:.1f} img/s "
                f"(median step {sorted(ms)[len(ms) // 2]:.3f} ms), device busy "
                + (f"{r['busy_share']:.1%} ({busy:.3f} ms, {n_kernels / 3:.0f} kernels a step)"
                   if busy else "not measured")
                + f"; device ms fwd {r['forward_ms']:.3f}, bwd "
                f"{r['backward_ms']:.3f}, optimizer {r['optimizer_ms']:.3f}, not linked to an op "
                f"{r['unsplit_ms']:.3f}")
            for group in ("forward", "backward", "optimizer"):
                log(f"    top {group}: {r['top'][group][:3]}")
        del model, state, data
        torch.cuda.empty_cache()
    report["train_throughput"] = out
    return {k: round(v["img_per_s"], 1) for k, v in out.items()}


def train_phase(weights, seed, report):
    """Phase 7: the float32 step card vs CPU, the CLI's TRAIN end to end,
    the train-step throughput of each shipped config."""
    t0 = time.perf_counter()
    check_train_step(weights, seed, report)
    train_cli_phase(weights, seed, report)
    rates = train_throughput(report)
    report["train_phase_seconds"] = time.perf_counter() - t0
    log(f"training phase done in {report['train_phase_seconds']:.1f} s ({report['nvidia_smi']})")
    return rates


# -- phase 11: the serving side paths: the int8 backbone and the zoom ensemble --


def wave_batch(seed, size, n):
    """``n`` seeded wave images [n, size, size, 3] uint8: the int8
    Predictors' calibration set."""
    import numpy as np

    rs = np.random.RandomState(seed + 9)
    return np.stack([wave_image(rs, size, size) for _ in range(n)])


def qp_to(qp, device):
    """An int8 parameter tree with every tensor on ``device``."""
    import torch

    if isinstance(qp, torch.Tensor):
        return qp.to(device)
    if isinstance(qp, dict):
        return {k: qp_to(v, device) for k, v in qp.items()}
    if isinstance(qp, list):
        return [qp_to(v, device) for v in qp]
    return qp


def int8_scales(qp):
    out = {"stem": qp["stem"]["out_s"]}
    for i, blk in enumerate(qp["blocks"]):
        out.update({f"{i}.{k}": blk[k] for k in ("e_s", "d_s", "p_in_s", "out_s") if k in blk})
    return out


def int8_taps(model, qp, x):
    """{tap: int8 codes} of the backbone on ``x`` [B, H, W, 3] in [0, 1]."""
    from yoloret_tpu_torch.nn import int8_infer
    from yoloret_tpu_torch.nn.mobilenetv2 import _TAP_BLOCKS

    folded = model.kind == "mobilenetv2"
    taps = _TAP_BLOCKS if folded else qp["taps"]
    xq = int8_infer._stem_i8(qp["stem"], x, model.dtype)
    out = {}
    for i, blk in enumerate(qp["blocks"]):
        xq = int8_infer._int8_block(xq, blk, folded=folded)
        if i in taps:
            out[taps[i]] = xq
    return out


def code_diff(got, want):
    """Share of int8 codes that differ, largest difference, relative RMS
    difference."""
    d = (got.cpu().int() - want.cpu().int()).float()
    rms = want.float().pow(2).mean().sqrt().item()
    return dict(share=(d != 0).float().mean().item(), max=int(d.abs().max().item()),
                rel_rms=d.pow(2).mean().sqrt().item() / max(rms, 1e-12))


def check_int8_blocks(model, qp_cpu, x, share_tol):
    """The int8 backbone on the card one block at a time, each from the
    CPU chain's own input codes and with the CPU's int8 weights and scales
    (moved to the card), against the CPU; the stem from the same images:
    codes off by at most one, on at most ``share_tol`` of them. Returns
    the rows."""
    import torch

    from yoloret_tpu_torch.nn import int8_infer

    folded = model.kind == "mobilenetv2"
    qp_card = qp_to(qp_cpu, DEVICE)
    xq = int8_infer._stem_i8(qp_cpu["stem"], x, torch.float32)
    rows = [dict(what="stem", **code_diff(
        int8_infer._stem_i8(qp_card["stem"], x.to(DEVICE), torch.float32), xq))]
    for i, (bc, bg) in enumerate(zip(qp_cpu["blocks"], qp_card["blocks"])):
        want = int8_infer._int8_block(xq, bc, folded=folded)
        got = int8_infer._int8_block(xq.to(DEVICE), bg, folded=folded)
        rows.append(dict(what=f"block {i}", shape=list(want.shape), **code_diff(got, want)))
        xq = want
    worst = max(rows, key=lambda r: (r["max"], r["share"]))
    log(f"  int8 {model.backbone}: the stem and {len(rows) - 1} blocks on the card, each from "
        f"the CPU's input codes with the CPU's int8 weights: worst {worst['what']}, "
        f"{worst['share']:.3g} of codes differ, by at most {worst['max']} (limit: by 1 on "
        f"{share_tol:g} of them)")
    for r in rows:
        if r["max"] > 1 or r["share"] > share_tol:
            raise AssertionError(f"int8 {model.backbone} {r['what']}: card vs CPU {r}")
    return rows


def int8_card_vs_cpu(pred, state, calib, seed, report, limits):
    """The float32 int8 Predictor on the card (TF32 off) against the same
    Predictor on the CPU, each calibrated on ``calib`` on its own device,
    on 2 images: the scales, per tap the share of int8 codes that differ,
    the largest difference and the relative RMS difference, the heads'
    largest difference, the detections; then ``check_int8_blocks``.
    ``limits``: dict(scale_rtol, tap_share, tap_rel_rms, heads_rtol,
    detections (hold that every detection agrees), block_share)."""
    import numpy as np
    import torch

    from yoloret_tpu_torch.nn import int8_infer
    from yoloret_tpu_torch.ops.letterbox import letterbox_numpy_u8

    gpu, cpu = float32_pair(pred, state, use_int8=True, calibration_images=calib)
    want_s, got_s = int8_scales(cpu._qp), int8_scales(gpu._qp)
    scale_err = max(abs(got_s[k] - v) / v for k, v in want_s.items())
    ims = two_images(seed)
    x = torch.from_numpy(np.stack([letterbox_numpy_u8(im, pred.input_hw) for im in ims]))
    x = x.float() * (1.0 / 255.0)
    with torch.inference_mode():
        taps = {k: code_diff(g, w) for (k, g), w in zip(
            int8_taps(gpu.model, gpu._qp, x.to(DEVICE)).items(),
            int8_taps(cpu.model, cpu._qp, x).values())}
        hg = int8_infer.int8_detector_apply(gpu.model, gpu._qp, x.to(DEVICE))
        hc = int8_infer.int8_detector_apply(cpu.model, cpu._qp, x)
    heads_err = max((a.cpu() - b).abs().max().item() for a, b in zip(hg, hc))
    heads_scale = max(b.abs().max().item() for b in hc)
    got, want = gpu.detect_arrays(ims), cpu.detect_arrays(ims)
    n = matched_detections(got, want)
    counts = ([len(d) for d in got], [len(d) for d in want])
    name = pred.model.backbone
    log(f"  int8 float32 Predictor card vs CPU, {name} @{pred.input_hw[0]}, calibrated on "
        f"{len(calib)} wave images each: scales within {scale_err:.3g} relative (limit "
        f"{limits['scale_rtol']:g})")
    for k, t in taps.items():
        log(f"    tap {k}: {t['share']:.4%} of int8 codes differ, largest difference "
            f"{t['max']}, relative RMS {t['rel_rms']:.4g} (limits: share {limits['tap_share']:g}, "
            f"relative RMS {limits['tap_rel_rms']:g})")
    log(f"    heads: largest difference {heads_err:.4g} of max |head| {heads_scale:.4g} (limit "
        f"{limits['heads_rtol']:g} of it); detections {counts[0]} on the card, {counts[1]} on "
        f"the CPU, {n} agree (class, score rtol 1e-4, box atol 0.05 px; "
        + ("held: all" if limits["detections"] else "logged") + ")")
    bad = []
    if not scale_err <= limits["scale_rtol"]:
        bad.append(f"scales {scale_err}")
    bad += [f"tap {k} {t}" for k, t in taps.items()
            if t["share"] > limits["tap_share"] or t["rel_rms"] > limits["tap_rel_rms"]]
    if not heads_err <= limits["heads_rtol"] * heads_scale:
        bad.append(f"heads {heads_err} of {heads_scale}")
    if limits["detections"] and not (counts[0] == counts[1] and n == sum(counts[1]) > 0):
        bad.append(f"detections {counts}, {n} agree")
    if bad:
        raise AssertionError(f"int8 {name} card vs CPU beyond the limits: {bad}")
    rows = check_int8_blocks(cpu.model, cpu._qp, x, limits["block_share"])
    report.update(scale_rel_err=scale_err, taps=taps, heads_err=heads_err,
                  heads_scale=heads_scale, detections=dict(card=counts[0], cpu=counts[1],
                                                           agree=n), blocks=rows)


def int8_device_split(pred, report, batches=3):
    """Where an int8 serving batch's device time goes (b128, bf16; either
    backbone): the profiler's device ms of the backbone alone, of its ``torch._int_mm``
    calls and its depthwise convolutions replayed alone (the arguments of
    one forward, recorded), of the stem alone, of the neck alone on the
    taps and of the postprocess alone on the heads; the epilogues'
    elementwise passes (with the taps' dequantization) are the backbone's
    rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from yoloret_tpu_torch.nn import int8_infer
    from yoloret_tpu_torch.ops.postprocess import detect_batch

    m, qp = pred.model, pred._qp
    g = torch.Generator(device=DEVICE).manual_seed(3)
    x = torch.rand((BATCH, *pred.input_hw, 3), generator=g, device=DEVICE)
    hw = torch.full((BATCH, 2), float(pred.input_hw[0]), device=DEVICE)
    calls = {"int_mm": [], "depthwise": []}
    mm, dw = int8_infer.int_mm, int8_infer._dw_i8

    def rec_mm(a, w):
        calls["int_mm"].append((a, w))
        return mm(a, w)

    def rec_dw(a, w, stride):
        calls["depthwise"].append((a, w, stride))
        return dw(a, w, stride)

    def features():
        if m.kind == "mobilenetv2":
            return int8_infer.mobilenetv2_int8_features(qp, x, m.dtype, folded=True)
        return int8_infer.efficientnet_int8_features(qp, x, m.dtype)

    int8_infer.int_mm, int8_infer._dw_i8 = rec_mm, rec_dw
    try:
        with torch.inference_mode():
            feats = features()
    finally:
        int8_infer.int_mm, int8_infer._dw_i8 = mm, dw
    with torch.inference_mode():
        heads = m.neck_heads(feats)
    windows = {
        "backbone": features,
        "int_mm": lambda: [mm(*a) for a in calls["int_mm"]],
        "depthwise": lambda: [dw(*a) for a in calls["depthwise"]],
        "stem": lambda: int8_infer._stem_i8(qp["stem"], x, m.dtype),
        "neck": lambda: m.neck_heads(feats),
        "postprocess": lambda: detect_batch(heads, pred._anchors_t, len(pred.class_names), hw,
                                            score_threshold=pred.score_threshold,
                                            num_candidates=pred.num_candidates),
    }
    ms = {}
    for name, fn in windows.items():
        with torch.inference_mode():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(batches):
                    fn()
                torch.cuda.synchronize()
        ms[name] = sum(device_ms_by_group(prof, ())[0].values()) / batches
    if ms["backbone"] == 0.0:
        log("  int8 device split: the profiler recorded no device time (not measured)")
        report["device_split"] = None
        return
    ms["epilogue"] = ms["backbone"] - ms["int_mm"] - ms["depthwise"] - ms["stem"]
    split = {k: ms[k] for k in ("int_mm", "depthwise", "epilogue", "stem", "neck",
                                "postprocess")}
    report["device_split"] = dict(ms_per_batch=split, backbone_ms=ms["backbone"],
                                  int_mm_calls=len(calls["int_mm"]),
                                  depthwise_calls=len(calls["depthwise"]))
    log(f"  int8 device ms a b{BATCH} batch ({m.backbone} @{pred.input_hw[0]}, bf16 stem and "
        f"neck; each part alone under the profiler): "
        f"{ {k: round(v, 3) for k, v in split.items()} }, summed {sum(split.values()):.3f} "
        f"(the backbone alone {ms['backbone']:.3f}: {len(calls['int_mm'])} int8 matmuls, "
        f"{len(calls['depthwise'])} depthwise convs)")


def int8_cli_map(root, report):
    """The CLI's ``--mode=MAP --int8`` on the first INT8_EVAL_IMAGES
    images of phase 5's synthetic set (its text list, which the CLI also
    calibrates from), float32, on the card (launch counts set to 0 just
    before and read just after: no MBConv, 1 NMS a batch) and on the CPU;
    the card's mAP within EVAL_AP_TOL of the CPU's."""
    from yoloret_tpu_torch.ops.mbconv import fused_mbconv
    from yoloret_tpu_torch.ops.nms_kernel import suppress

    with open(os.path.join(root, "eval", "test.txt")) as f:
        lines = f.read().splitlines()[:INT8_EVAL_IMAGES]
    lst = os.path.join(root, "int8_test.txt")
    with open(lst, "w") as f:
        f.write("\n".join(lines) + "\n")
    names = [f"class_{i}" for i in range(NUM_CLASSES)]
    argv = ["--mode=MAP", "--int8", f"--model={os.path.join(root, 'weights.pt')}",
            f"--test_dataset={lst}", f"--classes_path={os.path.join(root, 'classes.txt')}",
            f"--anchors_path={os.path.join(root, 'anchors.txt')}", f"--input_size={SIZE}",
            f"--batch_size={BATCH}", "--no-bf16"]
    log(f"  the CLI's --mode=MAP --int8, float32, {len(lines)} images of phase 5's set "
        "(calibrated from its text list), on the CPU:")
    cpu = evaluate_cli(argv + ["--device=cpu"], names)
    fused_mbconv.launches = suppress.launches = 0
    log("  the same on the card:")
    card = evaluate_cli(argv + [f"--device={DEVICE}"], names)
    launches = {"mbconv": fused_mbconv.launches, "nms": suppress.launches}
    batches = -(-len(lines) // BATCH)
    diff = abs(card["map"] - cpu["map"])
    ap_diff = max(abs(a - b) for a, b in zip(card["aps"], cpu["aps"]))
    log(f"  --int8 MAP: card mAP {card['map']:.6f}, CPU {cpu['map']:.6f}, difference "
        f"{diff:.6f} (limit {EVAL_AP_TOL}); largest per-class AP difference {ap_diff:.6f}; "
        f"card launches {launches} for {batches} batch(es)")
    assert launches == {"mbconv": 0, "nms": batches}, launches
    if not cpu["map"] > 0 or diff > EVAL_AP_TOL:
        raise AssertionError(f"--int8 MAP: card {card['map']} vs CPU {cpu['map']}")
    report["cli_map"] = dict(card=card, cpu=cpu, map_diff=diff, ap_diff=ap_diff,
                             launches=launches)


def int8_phase(state, eval_root, seed, report):
    """Phase 11a: the W8A8 int8 backbone (``Predictor(use_int8=True)``) at
    the flagship's full width, calibrated on INT8_CALIB_IMAGES seeded wave
    images: the main path with its launch counts (no MBConv, 1 NMS a
    forward), the float32 Predictor card vs CPU and the blocks one at a
    time, serving and MAP-grade img/s beside the bf16 fused path's, the
    device split, the CLI's ``--mode=MAP --int8``; then EfficientNet-B3
    @416 (``configs/coco_efficientnetb3_416.yaml``): float32 card vs CPU,
    serving img/s beside its stock bf16 path's, and its device split."""
    import torch

    from yoloret_tpu_torch.configs import load_config
    from yoloret_tpu_torch.data import load_classes

    t0 = time.perf_counter()
    out = report.setdefault("int8", {})
    calib = wave_batch(seed, SIZE, INT8_CALIB_IMAGES)
    pred = make_predictor(seed, weights=state, score_threshold=0.3, num_candidates=64,
                          use_int8=True, calibration_images=calib)
    map_pred = make_predictor(seed, weights=state, score_threshold=0.0, num_candidates=512,
                              use_int8=True, calibration_images=calib)
    log(f"== int8: {pred.model.backbone} @{SIZE}, {NUM_CLASSES} classes, bf16 stem and neck, "
        f"int8 backbone calibrated on {len(calib)} wave images")
    drive_main_path(pred, map_pred, seed, out, mbconv_per_forward=0)
    int8_card_vs_cpu(pred, state, calib, seed, out.setdefault("card_vs_cpu", {}), INT8_LIMITS)
    bf16 = make_predictor(seed, weights=state, score_threshold=0.3, num_candidates=64)
    bf16_map = make_predictor(seed, weights=state, score_threshold=0.0, num_candidates=512)
    rates = {"bf16_fused": time_paths(bf16, bf16_map, {}), "int8": time_paths(pred, map_pred, {}),
             "bf16_fused_again": time_paths(bf16, bf16_map, {})}
    out["end_to_end"] = rates
    del bf16, bf16_map, map_pred
    int8_device_split(pred, out)
    int8_cli_map(eval_root, out)
    del pred
    torch.cuda.empty_cache()

    cfg = load_config(os.path.join(HERE, COCO_CONFIGS["efficientnetb3_416"]))
    names = load_classes(os.path.join(HERE, cfg.classes_path))
    size = cfg.input_size[0]
    b3 = out.setdefault("b3", {})
    kw = dict(size=size, class_names=names, backbone=cfg.backbone, rfcr=cfg.rfcr)
    base = make_predictor(seed, score_threshold=0.3, num_candidates=64, mixed=True, **kw)
    b3_state = {k: v.detach().cpu() for k, v in base.model.state_dict().items()}
    b3_calib = wave_batch(seed, size, INT8_B3_CALIB_IMAGES)
    log(f"== int8: {cfg.backbone} @{size}, {len(names)} classes, calibrated on "
        f"{len(b3_calib)} wave images")
    int8_card_vs_cpu(base, b3_state, b3_calib, seed, b3, INT8_B3_LIMITS)
    b3_pred = make_predictor(seed, weights=b3_state, score_threshold=0.3, num_candidates=64,
                             use_int8=True, calibration_images=b3_calib, **kw)
    base_map = make_predictor(seed, weights=b3_state, score_threshold=0.0, num_candidates=512,
                              **kw)
    b3_map = make_predictor(seed, weights=b3_state, score_threshold=0.0, num_candidates=512,
                            use_int8=True, calibration_images=b3_calib, **kw)
    b3["end_to_end"] = {"bf16_stock": time_paths(base, base_map, {}),
                        "int8": time_paths(b3_pred, b3_map, {})}
    del base, base_map, b3_map
    int8_device_split(b3_pred, b3)
    del b3_pred
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"== int8 phase: {out['seconds']:.1f} s")


def zoom_candidates(pred, k, seed, batch=BATCH):
    """The per-class pools of the zoom ensemble (the full input's and the
    centre crop's positions) of ``batch`` seeded images through the
    kernel path: boxes [B, C, k, 4], scores [B, C, k]."""
    import torch

    from yoloret_tpu_torch.data.augment import to_unit_float
    from yoloret_tpu_torch.ops.postprocess import per_class_candidates

    hw = pred.input_hw
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    images = torch.randint(0, 256, (batch, *hw, 3), generator=g, device=DEVICE,
                           dtype=torch.uint8)
    image_hw = torch.tensor([hw], dtype=torch.float32, device=DEVICE).repeat(batch, 1)
    (zh, zw), (y0, x0) = pred.zoom_hw, ((hw[0] - pred.zoom_hw[0]) // 2,
                                        (hw[1] - pred.zoom_hw[1]) // 2)
    with torch.inference_mode():
        x = to_unit_float(images)
        outs = pred._forward(x)
        zoom = pred._forward(x[:, y0:y0 + zh, x0:x0 + zw])
        return per_class_candidates(outs, pred._anchors_t, len(pred.class_names), image_hw,
                                    num_candidates=k, zoom_outputs=zoom)


def zoom_phase(state, seed, report):
    """Phase 11b: the zoom-in ensemble (``Predictor(zoom_ensemble=True)``,
    bf16, crop 224 of 320): the main path with its launch counts (32 MBConv
    + 1 NMS a forward, the per-class kernel), float32 card vs CPU, the
    MBConv kernel against its plain version at the crop's shapes (b2 and
    b128) and timed with its tile plan, ``nms_kernel`` held exactly
    against its plain version on the zoom's per-class pools and timed,
    zoom serving img/s and its profile; then int8 with zoom once at b8
    (0 MBConv + 1 NMS).
    Returns the kernels line's two rows."""
    import numpy as np
    import torch

    from yoloret_tpu_torch.ops.mbconv import fused_mbconv
    from yoloret_tpu_torch.ops.nms_kernel import plan_nms, suppress

    t0 = time.perf_counter()
    out = report.setdefault("zoom", {})
    pred = make_predictor(seed, weights=state, score_threshold=0.3, num_candidates=ZOOM_K,
                          zoom_ensemble=True)
    map_pred = make_predictor(seed, weights=state, score_threshold=0.0, num_candidates=512,
                              zoom_ensemble=True)
    zh = pred.zoom_hw[0]
    log(f"== zoom: {pred.model.backbone} @{SIZE} with the centre {pred.zoom_hw} crop, bf16, "
        f"per-class pools of {ZOOM_K} (MAP grade 512)")
    launches = drive_main_path(pred, map_pred, seed, out, mbconv_per_forward=32)
    nms_launches = out["main_path"]["nms_variant_launches"]["per_class"]
    check_against_cpu(pred, seed, out, zoom_ensemble=True, zoom_hw=pred.zoom_hw)
    g = torch.Generator(device=DEVICE).manual_seed(0)
    images = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), generator=g, device=DEVICE,
                           dtype=torch.uint8)
    hw = torch.full((BATCH, 2), float(SIZE), device=DEVICE)
    ms = cuda_time_ms(lambda: pred.infer(images, hw), iters=20, warmup=3)
    out["serving"] = dict(ms_per_batch=ms, img_per_s=BATCH * 1e3 / ms)
    log(f"  zoom serving (t=0.3, K={ZOOM_K}) b{BATCH}@{SIZE} + crop {zh}, bf16: {ms:.3f} "
        f"ms/batch = {BATCH * 1e3 / ms:.1f} img/s (CUDA events, after warm-up)")
    profile_serving(pred, out)
    del map_pred

    errs = [check_mbconv_at(pred, zh, b, out, f"mbconv_check_{zh}_b{b}") for b in (2, BATCH)]
    flush = make_flush()
    mbconv = time_mbconv(pred, flush, batch=BATCH, size=zh)
    rows = [mbconv_entry(pred, f"@zoom{zh}", launches["mbconv"] // 2, max(errs), mbconv, BATCH,
                         zh, "the zoom drive's crop passes, 16 of its 32 a forward")]
    cases = []
    boxes, scores = zoom_candidates(pred, ZOOM_K, seed=21)
    c, n_pos = scores.shape[1], exact_k(SIZE) + exact_k(zh)
    for b in (BATCH, 1):
        same, err, dets = nms_exact(boxes[:b].contiguous(), scores[:b].contiguous(), 0.3,
                                    float("-inf"))
        plan = plan_nms(c, ZOOM_K, 20, False)
        cases.append(dict(batch=b, exact=same, max_abs_err=err, detections=dets,
                          plan=plan._asdict()))
        log(f"  nms kernel vs plain, zoom per-class pools b{b} C={c} K={ZOOM_K} over {n_pos} "
            f"positions t=0.3 ({plan.variant} kernel, {plan.npl} candidates a lane): max abs "
            f"err {err} (tolerance 0: exact), {dets} detections")
        if not same or dets == 0:
            raise AssertionError(f"nms zoom b{b}: kernel differs from plain by {err}")
    t = time_nms_case(boxes, scores, 0.3, flush, f"per-class K={ZOOM_K} (zoom)")
    out["nms_check"], out["nms_timing"] = cases, t
    rows.append(dict(
        name="nms_per_class@zoom", route="cuda", source="yoloret_tpu_torch/csrc/nms.cu",
        replaces="yoloret_tpu/ops/nms_pallas.py:36",
        shapes=f"per-class pools b{BATCH} C={c} K={ZOOM_K} over {n_pos} positions ({SIZE} and "
               f"its {zh} crop) t=0.3 max_det 20; launches: the zoom drive's",
        launches=nms_launches, max_abs_err=0.0, ms=t["ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None))
    del boxes, scores, pred

    both = make_predictor(seed, weights=state, score_threshold=0.3, num_candidates=ZOOM_K,
                          zoom_ensemble=True, use_int8=True,
                          calibration_images=wave_batch(seed, SIZE, INT8_CALIB_IMAGES))
    rs = np.random.RandomState(seed + 5)
    req = [rs.randint(0, 256, (int(rs.randint(200, 500)), int(rs.randint(200, 500)), 3),
                      dtype=np.uint8) for _ in range(8)]
    fused_mbconv.launches = suppress.launches = 0
    dets = both.detect_arrays(req)
    both_launches = {"mbconv": fused_mbconv.launches, "nms": suppress.launches}
    n = sum(len(d) for d in dets)
    log(f"  int8 + zoom, b8: {n} detections, launches {both_launches}")
    assert len(dets) == 8 and both_launches == {"mbconv": 0, "nms": 1}, both_launches
    out["int8_and_zoom"] = dict(detections=n, launches=both_launches)
    del both
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"== zoom phase: {out['seconds']:.1f} s")
    return rows


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
    build_s = report["build_seconds"] = build_libraries(report)
    log(f"built csrc/mbconv.cu and csrc/nms.cu for sm_90a in {build_s:.1f} s (the JPEG loader "
        f"beside them: {report['native_loader']})")
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
    # phase 5's dataset stays for phase 11's --mode=MAP --int8
    with tempfile.TemporaryDirectory(prefix="yoloret_eval_") as eval_root:
        ev = eval_phase(map_pred, state, args.seed, report, root=eval_root)
        kernels = time_kernels(pred, launches, ev["launches"], errs, report)
        log(f"flagship phases done at {time.perf_counter() - t_start:.1f} s")
        del pred, map_pred
        torch.cuda.empty_cache()
        kernels += image_phase(state, args.seed, report)
        train_rates = train_phase(state, args.seed, report)
        kernels += report["options_kernels"]
        torch.cuda.empty_cache()

        for name, config in COCO_CONFIGS.items():
            kernels += coco_phase(name, config, args.seed, report)
        registry = registry_phase(args.seed, report)
        log(f"phases 1-10 done at {time.perf_counter() - t_start:.1f} s")

        int8_phase(state, eval_root, args.seed, report)
    kernels += zoom_phase(state, args.seed, report)

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
                    "eval_host_decode_s": ev["host_decode_s"],
                    "native_loader": report["native_loader"],
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
                    "train_img_per_s": train_rates,
                    "train_step_check": report["train_step_check"],
                    "train_cli": {k: report["train_cli"][k] for k in
                                  ("map_trainer", "map_cli", "launches", "mbconv_err")},
                    "train_options": {k: report["train_options"][k] for k in
                                      ("img_per_s", "plain_img_per_s", "host_ms_per_image",
                                       "launches", "mbconv_err", "mix_batch")},
                    "image": {k: report["image"][k] for k in
                              ("launches", "float32_detections", "latency_ms")},
                    "int8": dict(
                        img_per_s={k: {p: v[p]["img_per_s"] for p in ("serving", "map_grade")}
                                   for k, v in report["int8"]["end_to_end"].items()},
                        b3_img_per_s={k: {p: v[p]["img_per_s"] for p in ("serving", "map_grade")}
                                      for k, v in report["int8"]["b3"]["end_to_end"].items()},
                        launches=report["int8"]["main_path"]["launches"],
                        device_split=report["int8"]["device_split"],
                        b3_device_split=report["int8"]["b3"]["device_split"],
                        card_vs_cpu_taps=report["int8"]["card_vs_cpu"]["taps"],
                        cli_map={k: report["int8"]["cli_map"][k] for k in
                                 ("map_diff", "launches")}),
                    "zoom": dict(img_per_s=report["zoom"]["serving"]["img_per_s"],
                                 profile=report["zoom"]["profile"],
                                 launches=report["zoom"]["main_path"]["launches"],
                                 int8_and_zoom=report["zoom"]["int8_and_zoom"]),
                    "seconds": report["seconds"],
                    "card": smi}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
