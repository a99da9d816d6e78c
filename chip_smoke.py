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
# --exact_nms's per-class pool: every position of the grid at SIZE
EXACT_K = sum((SIZE // s) ** 2 * 3 for s in (32, 16, 8))
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
    x = torch.rand((batch, SIZE, SIZE, 3), generator=g, device=DEVICE).to(pred.model.dtype)
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


def calibrate_bn(model, images):
    """Set every BatchNorm's running statistics to those of its conv's
    output on ``images``, in one forward pass in layer order. The seeded
    fan-out init alone shrinks activations some 50x per backbone block
    (to ~1e-11 by block 15), which would leave the kernel checks
    comparing zeros; calibrated, every layer carries unit-scale
    activations."""
    import torch

    from yoloret_tpu_torch.nn.layers import ConvBN, DepthwiseConvBN

    def hook(mod, inp):
        conv = mod.conv if isinstance(mod, ConvBN) else mod.dwconv
        y = conv(inp[0]).float()
        mod.bn.running_mean.copy_(y.mean(dim=(0, 1, 2)))
        mod.bn.running_var.copy_(y.var(dim=(0, 1, 2), unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, (ConvBN, DepthwiseConvBN))]
    try:
        with torch.no_grad():
            model(images)
    finally:
        for h in handles:
            h.remove()


def make_predictor(seed, weights=None, **kw):
    """Serving Predictor on the card. Without ``weights``: seeded init,
    then BatchNorm calibrated on 8 seeded images. Calibration does what
    the x4 head-kernel amplification of tests/test_export.py does for
    uncalibrated weights -- input-dependent, distinct scores instead of
    ties at 0.25 -- and the x4 on top of it would saturate the logits
    (std ~6, 0.3% of scores exactly 1.0, i.e. ties again)."""
    import torch

    from yoloret_tpu_torch.infer import Predictor

    pred = Predictor(class_names=[f"class_{i}" for i in range(NUM_CLASSES)], anchors=ANCHORS,
                     input_hw=(SIZE, SIZE), seed=seed, weights=weights, device=DEVICE, **kw)
    if weights is None:
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        calibrate_bn(pred.model, torch.rand((8, SIZE, SIZE, 3), generator=g, device=DEVICE))
        pred.refresh()
    return pred


def check_mbconv(pred, report):
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
    report["mbconv_check"] = rows
    worst = {f"{d} b{n}": max(r["max_abs_err"] for r in rows
                              if r["dtype"] == d and r["batch"] == n)
             for d, n in (("torch.float32", 2), ("torch.bfloat16", 2),
                          ("torch.bfloat16", BATCH))}
    scale = min(r["max_abs_ref"] for r in rows)
    log(f"mbconv kernel vs plain, 16 blocks x (float32 b2, bfloat16 b2, bfloat16 b{BATCH}): "
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
    images = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), generator=g, device=DEVICE,
                           dtype=torch.uint8)
    hw = torch.full((BATCH, 2), float(SIZE), device=DEVICE)
    pool = per_class_candidates if per_class else shared_pool_candidates
    with torch.inference_mode():
        outs = fused_detector_apply(pred.model, images.float() / 255.0, pred._fused)
        return pool(outs, pred._anchors_t, NUM_CLASSES, hw, num_candidates=k)


def nms_cases(pred):
    """(name, boxes, scores, score threshold, empty score) of every NMS
    check: model candidates of the serving and the MAP-grade shape at
    B=128, 8 and 1; tied scores; pairs at IoU 0.5, exactly and within
    rounding; per-class pools; the exact evaluation's per-class pools of
    the whole grid (large-pool kernel, empty slots -inf as on that path)
    at B=128 and 1, and large pools of tied scores and pairs at IoU 0.5."""
    import numpy as np
    import torch

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(DEVICE)

    cases = []
    for m, thr in ((64, 0.3), (512, 0.0)):
        boxes, scores = candidates_at_b128(pred, m, seed=m)
        for b in (BATCH, 8, 1):
            cases.append((f"shared b{b} M={m} t={thr} (model candidates)",
                          boxes[:b].contiguous(), scores[:b].contiguous(), thr, 0.0))
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
    boxes, scores = candidates_at_b128(pred, EXACT_K, seed=7, per_class=True)
    for b in (BATCH, 1):
        cases.append((f"per-class b{b} K={EXACT_K} t=0 (model candidates, the --exact_nms pools)",
                      boxes[:b].contiguous(), scores[:b].contiguous(), 0.0, float("-inf")))
    del boxes, scores
    b, c = 8, NUM_CLASSES
    yx = rs.randint(0, SIZE // 8, (b, c, EXACT_K, 2))
    big = np.concatenate([yx, yx + rs.randint(1, 9, (b, c, EXACT_K, 2))], -1).astype(np.float32)
    big[:, :, :len(pairs)] = pairs
    cases.append((f"per-class b{b} K={EXACT_K} t=0.25 (tied scores in eighths, integer boxes, "
                  "32 pairs at IoU 0.5)", dev(big), dev(rs.randint(0, 9, (b, c, EXACT_K)) / 8),
                  0.25, float("-inf")))
    return cases


def check_nms(pred, report):
    import torch

    from yoloret_tpu_torch.ops.nms_kernel import plan_nms, suppress, suppress_plain

    rows, worst = [], {"small": 0.0, "large": 0.0}
    for name, boxes, scores, thr, empty in nms_cases(pred):
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


def drive_main_path(pred, map_pred, seed, report):
    """The serving slice through its entry points, with the launch counts
    set to 0 just before and read just after."""
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
    for im in images(4):
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

    server = DetectionServer(pred, host="127.0.0.1", port=0, max_batch=8)
    server.start(block=False)
    replies = [None] * len(jpegs)

    def post(i):
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/detect", data=jpegs[i],
                                     headers={"Content-Type": "image/jpeg"}, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            replies[i] = (r.status, json.loads(r.read()))

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
            assert 0 <= d["class_id"] < NUM_CLASSES and d["class_name"].startswith("class_")
    map_dets = map_pred.detect_arrays(map_request)
    seconds = time.perf_counter() - t0
    forwards = pred.forwards + map_pred.forwards
    launches = {"mbconv": fused_mbconv.launches, "nms": suppress.launches}
    log(f"main path: detect_arrays 1/8/130 images -> {counts} detections, "
        f"4 HTTP POSTs -> 200 with {[len(b['detections']) for _, b in replies]} detections, "
        f"MAP-grade request of 8 -> {sum(len(d) for d in map_dets)} detections; "
        f"{forwards} forwards, launches {launches}, {seconds:.2f} s")
    assert pred.forwards >= 5 and map_pred.forwards == 1, (pred.forwards, map_pred.forwards)
    assert launches["mbconv"] == 16 * forwards, (launches, forwards)
    assert launches["nms"] == forwards, (launches, forwards)
    # the shared pool (class stride 0) of both Predictors runs the shared-pool kernel
    variants = {p.num_candidates: plan_nms(NUM_CLASSES, p.num_candidates, 20, True).variant
                for p in (pred, map_pred)}
    log(f"main path: NMS kernel variant by pool size {variants}")
    assert set(variants.values()) == {"shared"}, variants
    report["main_path"] = dict(detections=counts, http=[len(b["detections"]) for _, b in replies],
                               forwards=forwards, launches=launches, seconds=seconds,
                               nms_variants=variants)
    return launches


def check_against_cpu(pred, seed, report):
    """float32 Predictor on the card (TF32 off) vs the same weights on the
    CPU (every kernel's plain version) on 2 images at 320."""
    import numpy as np

    from yoloret_tpu_torch.infer import Predictor

    kw = dict(class_names=pred.class_names, anchors=pred.anchors, input_hw=pred.input_hw,
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
    log(f"float32 Predictor on the card vs on the CPU: {n} detections agree "
        "(class, score rtol 1e-4, box atol 0.05 px)")
    report["cpu_agreement"] = n


def time_paths(pred, map_pred, report):
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(0)
    images = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), generator=g, device=DEVICE,
                           dtype=torch.uint8)
    hw = torch.full((BATCH, 2), float(SIZE), device=DEVICE)
    out = {}
    for name, p in (("serving", pred), ("map_grade", map_pred)):
        ms = cuda_time_ms(lambda: p.infer(images, hw), iters=20, warmup=3)
        out[name] = dict(ms_per_batch=ms, img_per_s=BATCH * 1e3 / ms,
                         score_threshold=p.score_threshold, num_candidates=p.num_candidates)
        log(f"{name} (t={p.score_threshold}, M={p.num_candidates}) at b{BATCH}@{SIZE} bf16: "
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
    images = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), generator=g, device=DEVICE,
                           dtype=torch.uint8)
    hw = torch.full((BATCH, 2), float(SIZE), device=DEVICE)
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
    log(f"profile, serving b{BATCH}: device ms/batch {rounded} of {wall_ms / batches:.3f} ms "
        f"wall, device busy {busy * batches / wall_ms:.1%}")
    for name, ms in top:
        log(f"  other: {ms:.4f} ms  {name[:90]}")


# -- phase 5: the mAP evaluation -------------------------------------------


def write_eval_images(root, seed):
    """EVAL_IMAGES seeded JPEGs, 120-640 px a side (aspect ratios up to
    5.3 either way): smooth colour waves and noise. Returns [(path, (h,
    w))]."""
    import numpy as np
    from PIL import Image

    rs = np.random.RandomState(seed)
    out = []
    for i in range(EVAL_IMAGES):
        h, w = (int(v) for v in rs.randint(120, 641, 2))
        yy, xx = np.mgrid[0:h, 0:w]
        waves = np.sin(xx[..., None] * rs.uniform(0.005, 0.06, 3)
                       + yy[..., None] * rs.uniform(0.005, 0.06, 3) + rs.uniform(0, 6.3, 3))
        img = np.clip(127 + 100 * waves + rs.randn(h, w, 3) * 12, 0, 255).astype(np.uint8)
        path = os.path.join(root, f"img_{i:04d}.jpg")
        Image.fromarray(img).save(path, quality=90)
        out.append((path, (h, w)))
    return out


def eval_ground_truth(cpu_pred, images, root):
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
    for batch in Dataset(lst, BATCH, input_hw=(SIZE, SIZE), device="cpu").build(epochs=1):
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
    aps = dict(re.findall(r"^(\S+) ap: ([\d.]+)$", text, re.M))
    return dict(eval_rate(text), aps=[float(aps[name]) for name in class_names],
                map=float(re.search(r"^mAP: ([\d.]+)$", text, re.M).group(1)))


def eval_phase(map_pred, state, seed, report):
    """The mAP evaluation path through its entry points (phase 5); returns
    the launch counts of its run on the card."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from yoloret_tpu_torch.data import Dataset
    from yoloret_tpu_torch.eval import MAPEvaluator
    from yoloret_tpu_torch.infer import Predictor
    from yoloret_tpu_torch.ops.mbconv import fused_mbconv
    from yoloret_tpu_torch.ops.nms_kernel import suppress

    names = map_pred.class_names
    kw = dict(class_names=names, anchors=map_pred.anchors, input_hw=map_pred.input_hw,
              score_threshold=0.0, num_candidates=512, bf16=False)
    out = {}
    with tempfile.TemporaryDirectory(prefix="yoloret_eval_") as root:
        t0 = time.perf_counter()
        images = write_eval_images(root, seed)
        cpu = Predictor(weights=state, device="cpu", **kw)
        gts = eval_ground_truth(cpu, images, root)
        pattern = write_eval_dataset(images, gts, root)
        n_samples, n_gt = 2 * len(images), 2 * sum(len(g) for g in gts)
        n_batches = -(-n_samples // BATCH)
        out["setup_s"] = time.perf_counter() - t0
        log(f"eval dataset: {len(images)} JPEGs in a text list and a TFRecord shard = "
            f"{n_samples} samples, {n_gt} ground-truth boxes (the CPU's {EVAL_GT_PER_IMAGE} best "
            f"detections of each image), written in {out['setup_s']:.1f} s")

        def dataset(device):
            return Dataset(pattern, BATCH, input_hw=(SIZE, SIZE), device=device)

        log("eval on the CPU, float32, shared pool M=512 (the reference):")
        runs = {"cpu_f32_shared": evaluate(cpu, dataset("cpu"), names)}
        if not runs["cpu_f32_shared"]["map"] > 0:
            raise AssertionError(f"the CPU run's mAP is {runs['cpu_f32_shared']['map']}: "
                                 "the ground truth matches nothing")
        log("eval on the CPU, bf16, shared pool M=512 (the bf16 run's reference):")
        cpu16 = Predictor(weights=state, device="cpu", **dict(kw, bf16=True))
        runs["cpu_bf16_shared"] = evaluate(cpu16, dataset("cpu"), names)
        del cpu16

        f32 = Predictor(weights=state, device=DEVICE, **kw)
        weights = os.path.join(root, "weights.pt")
        torch.save(state, weights)
        with open(os.path.join(root, "classes.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
        with open(os.path.join(root, "anchors.txt"), "w") as f:
            f.write(", ".join(f"{v:g}" for v in map_pred.anchors.ravel()) + "\n")
        cli = ["--mode=MAP", f"--model={weights}", f"--test_dataset={pattern}",
               f"--classes_path={os.path.join(root, 'classes.txt')}",
               f"--anchors_path={os.path.join(root, 'anchors.txt')}", f"--input_size={SIZE}",
               f"--batch_size={BATCH}", "--no-bf16", "--exact_nms", f"--device={DEVICE}"]

        fused_mbconv.launches = suppress.launches = 0
        suppress.variant_launches.clear()
        log("eval on the card, float32, shared pool M=512 (evaluate_map):")
        runs["card_f32_shared"] = evaluate(f32, dataset(DEVICE), names)
        log(f"eval on the card, float32, per-class pools K={EXACT_K} (the CLI: "
            f"{' '.join(a for a in cli if not a.startswith(('--model', '--test', '--cl', '--an')))}):")
        runs["card_f32_exact_cli"] = evaluate_cli(cli, names)
        log("eval on the card, bf16, shared pool M=512 (evaluate_map):")
        runs["card_bf16_shared"] = evaluate(map_pred, dataset(DEVICE), names)
        launches = {"mbconv": fused_mbconv.launches, "nms": suppress.launches,
                    **{f"nms_{k}": v for k, v in suppress.variant_launches.items()}}
        log(f"eval path: 3 runs of {n_batches} batches, launches {launches}")
        assert launches["mbconv"] == 16 * 3 * n_batches, launches
        assert launches["nms"] == 3 * n_batches, launches
        assert launches.get("nms_per_class_large") == n_batches, launches
        assert launches.get("nms_shared") == 2 * n_batches, launches
        for name in runs:
            assert runs[name]["images"] == n_samples, (name, runs[name]["images"])

        diffs, bad = {}, {}
        for name, ref in (("card_f32_shared", "cpu_f32_shared"),
                          ("card_f32_exact_cli", "cpu_f32_shared"),
                          ("card_bf16_shared", "cpu_bf16_shared")):
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
        dets = (rs.rand(n_det, 4) * SIZE, rs.rand(n_det), rs.randint(0, len(names), n_det))
        ev = MAPEvaluator(len(names))
        t0 = time.perf_counter()
        for g in gts + gts:
            ev.add_image(*dets, g)
        filing_s = time.perf_counter() - t0
        log(f"  host alone: decode {decoded} samples ({ds.num_workers} threads, PIL) "
            f"{decode_s * 1e3:.1f} ms = {decoded / decode_s:.1f} images/s; filing {n_det} "
            f"detections an image for {2 * len(gts)} images {filing_s * 1e3:.1f} ms")
        out.update(runs=runs, ap_diff=diffs, launches=launches, batches_per_run=n_batches,
                   samples=n_samples, gt_boxes=n_gt, host_decode_s=decode_s,
                   host_filing_s=filing_s, profile=dict(
                       loop_ms=loop_ms, img_per_s=loop["img_per_s"], device_ms=groups,
                       idle_share=idle))
    report["eval"] = out
    return out


def time_kernels(pred, launches, eval_launches, errs, report):
    import torch

    from yoloret_tpu_torch.ops.mbconv import fused_mbconv, plan_tile, reference_mbconv
    from yoloret_tpu_torch.ops.nms_kernel import plan_nms, suppress, suppress_plain

    scratch = torch.empty(128 * 2**20, dtype=torch.uint8, device=DEVICE)  # > 50 MB L2

    def flush():
        scratch.zero_()

    # what the timer reads for a kernel that does nothing (a one-element
    # fill): launch latency, the floor under every kernel time below
    tiny = torch.zeros(1, device=DEVICE)
    report["timer_floor_ms"] = cuda_time_ms(lambda: tiny.zero_(), 10, 2, flush)
    log(f"  timer floor: an empty kernel reads {report['timer_floor_ms']:.4f} ms")
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
            log(f"  mbconv block {meta.block_id:2d} {tuple(x.shape)} s{meta.stride} tile "
                f"{plan.th}x{plan.tw} ({plan.nc} warpgroups), stages {plan.xst} input / "
                f"{plan.wst} weights, grid {plan.grid} for {plan.items} items, smem "
                f"{plan.smem}: kernel {ms:.4f} ms, plain {plain:.4f}, cuDNN {lib:.4f}, "
                f"bound {bound:.4f} ({by})")
    report["mbconv_timing"] = rows
    for stride in (1, 2):
        sel = [r for r in rows if r["stride"] == stride]
        sums = {k: sum(r[k] for r in sel) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        log(f"  mbconv stride-{stride} blocks ({len(sel)} launches per forward), summed: kernel "
            f"{sums['ms']:.4f} ms, plain {sums['plain_ms']:.4f}, cuDNN {sums['library_ms']:.4f}, "
            f"bound {sums['bound_ms']:.4f}")
    kernels = [dict(
        name="mbconv", route="cuda", source="yoloret_tpu_torch/csrc/mbconv.cu",
        replaces="yoloret_tpu/ops/mbconv_pallas.py:76",
        also_replaces=["yoloret_tpu/ops/mbconv_pallas.py:109",
                       "yoloret_tpu/ops/mbconv_pallas2.py:86"],
        shapes=f"the 16 blocks of one forward at b{BATCH}@{SIZE} bf16 (times summed)",
        launches=launches["mbconv"], eval_launches=eval_launches["mbconv"],
        max_abs_err=errs["mbconv"], ms=tot["ms"],
        plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
        bound_by=max(("bytes", "operations"),
                     key=lambda by: sum(r["bound_ms"] for r in rows if r["bound_by"] == by)),
        library_ms=tot["library_ms"])]

    nms_rows = []
    for m, thr in ((64, 0.3), (512, 0.0)):
        boxes, scores = candidates_at_b128(pred, m, seed=100 + m)
        kw = dict(max_det=20, iou_threshold=0.5, score_threshold=thr)
        plan = plan_nms(scores.shape[1], m, 20, shared=True)
        ms = cuda_time_ms(lambda: suppress(boxes, scores, **kw), 10, 2, flush)
        plain = cuda_time_ms(lambda: suppress_plain(boxes, scores, **kw), 3, 1, flush)
        out_b, out_s = suppress(boxes, scores, **kw)
        bound, by, work = nms_bound_ms(boxes, scores, out_b, out_s, 20)
        nms_rows.append(dict(m=m, score_threshold=thr, plan=plan._asdict(), ms=ms,
                             plain_ms=plain, bound_ms=bound, bound_by=by,
                             detections=int((out_s > 0).sum()), **work))
        log(f"  nms shared b{BATCH} C={NUM_CLASSES} M={m} t={thr} ({plan.variant} kernel, "
            f"{plan.warps} warps, {plan.smem} B shared memory): kernel {ms:.4f} ms, plain "
            f"{plain:.4f}, bound {bound:.5f} ({by}; {work['distinct_picks']} distinct picks, "
            f"{work['rounds']} rounds; per-class count {work['bound_ms_per_class_count']:.5f})")
    # the large-pool variant at the --exact_nms eval's shape
    boxes, scores = candidates_at_b128(pred, EXACT_K, seed=100 + EXACT_K, per_class=True)
    kw = dict(max_det=20, iou_threshold=0.5, score_threshold=0.0)
    plan = plan_nms(NUM_CLASSES, EXACT_K, 20, shared=False)
    ms = cuda_time_ms(lambda: suppress(boxes, scores, **kw), 10, 2, flush)
    plain = cuda_time_ms(lambda: suppress_plain(boxes, scores, **kw), 3, 1, flush)
    out_b, out_s = suppress(boxes, scores, **kw)
    bound, by, work = nms_bound_ms(boxes, scores, out_b, out_s, 20)
    large = dict(k=EXACT_K, score_threshold=0.0, plan=plan._asdict(), ms=ms, plain_ms=plain,
                 bound_ms=bound, bound_by=by, detections=int((out_s > 0).sum()), **work)
    log(f"  nms per-class b{BATCH} C={NUM_CLASSES} K={EXACT_K} t=0 ({plan.variant} kernel, "
        f"{plan.warps} warps, {plan.smem} B shared memory): kernel {ms:.4f} ms, plain "
        f"{plain:.4f}, bound {bound:.5f} ({by}; {work['rounds']} rounds, {work['bytes']} bytes)")
    del boxes, scores
    report["nms_timing"] = nms_rows + [large]
    serving, mapg = nms_rows
    kernels.append(dict(
        name="nms", route="cuda", source="yoloret_tpu_torch/csrc/nms.cu",
        replaces="yoloret_tpu/ops/nms_pallas.py:36",
        also_replaces=["yoloret_tpu/ops/postprocess.py:361"],
        shapes=f"shared pool b{BATCH} C={NUM_CLASSES} M=64 t=0.3 (serving); map_grade_*: "
               f"M=512 t=0",
        launches=launches["nms"], eval_launches=eval_launches.get("nms_shared", 0),
        max_abs_err=errs["nms"], ms=serving["ms"],
        plain_ms=serving["plain_ms"], bound_ms=serving["bound_ms"],
        bound_by=serving["bound_by"], library_ms=None, map_grade_ms=mapg["ms"],
        map_grade_plain_ms=mapg["plain_ms"], map_grade_bound_ms=mapg["bound_ms"],
        map_grade_bound_by=mapg["bound_by"]))
    kernels.append(dict(
        name="nms_per_class_large", route="cuda", source="yoloret_tpu_torch/csrc/nms.cu",
        replaces="yoloret_tpu/ops/nms_pallas.py:36",
        shapes=f"per-class pools b{BATCH} C={NUM_CLASSES} K={EXACT_K} t=0 max_det 20 (the "
               f"--exact_nms eval's); launches: the eval path's run",
        launches=eval_launches.get("nms_per_class_large", 0), max_abs_err=errs["nms_large"],
        ms=large["ms"], plain_ms=large["plain_ms"], bound_ms=large["bound_ms"],
        bound_by=large["bound_by"], library_ms=None))
    return kernels


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

    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    out = os.path.join(HERE, "chiprun_out", "chip_smoke.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    log(json.dumps({"end_to_end_img_per_s": {k: v["img_per_s"] for k, v in e2e.items()
                                             if isinstance(v, dict)},
                    "eval_img_per_s": {k: v["img_per_s"] for k, v in ev["runs"].items()},
                    "eval_device_idle_share": ev["profile"]["idle_share"],
                    "eval_map": {k: v["map"] for k, v in ev["runs"].items()},
                    "card": smi}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
