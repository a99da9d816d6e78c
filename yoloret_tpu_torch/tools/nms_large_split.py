#!/usr/bin/env python3
"""Where the large-pool NMS kernels' time goes, on the card.

    python3 yoloret_tpu_torch/tools/nms_large_split.py [--old-source FILE] [--seed 0]

On the exact evaluation's pools (per-class pools of the whole grid, model
candidates of seeded, calibrated weights through ``chip_smoke.py``'s
helpers, batch 128, max_det 20, score threshold 0) at its three shapes:
MobileNetV2 x0.75 @320 (C=20, K=6,300), x1.4 @224 (C=80, K=3,087) and
EfficientNet-B3 @416 (C=80, K=10,647). For each, the pools as the path
sorts them and the same pools shuffled, times (L2 flushed, the device
kept behind the host, ``chip_smoke.cuda_time_ms``):
- ``suppress`` at max_det 20 and at max_det 1 (on a sorted pool the
  walk's read of the scores and its first chunk; on a shuffled one the
  order test and one round);
- a PyTorch read of the same scores (``amax`` over each pool), the floor
  a kernel that must read every score meets;
- the same two after a flush that reads 128 MB instead of writing it:
  ``chip_smoke.py``'s flush leaves the L2 full of dirty lines, whose
  write-back shares the memory with the timed kernel's reads;
- with ``--old-source`` (an earlier ``csrc/nms.cu``, e.g. ``git show
  74805f6:yoloret_tpu_torch/csrc/nms.cu``), that version's large-pool
  kernel on the same pools, built beside it, and whether its outputs are
  bit for bit the current ones;
and the bound of ``chip_smoke.nms_bound_ms``. Prints the card's name and
power limit, the timer's floor, then one line per shape and order.
Needs a CUDA GPU and nvcc; nothing is written to the repository.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

SHAPES = (("mobilenetv2x75", 320, 20), ("mobilenetv2x14", 224, 80),
          ("efficientnetb3", 416, 80))


def old_large(so_path):
    """A call of an earlier build's large-pool kernel (the ABI before the
    scratch argument: one CTA of 8-32 warps per pool, the keys in shared
    memory)."""
    import torch

    lib = ctypes.CDLL(so_path)
    vp, ci, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.yrt_nms.argtypes = ([vp] * 4 + [ci] * 4 + [ctypes.c_longlong] * 2 + [f] * 3 + [ci] * 4
                            + [vp])
    lib.yrt_nms.restype = ci

    def run(boxes, scores, max_det, iou_threshold, score_threshold, empty_score=0.0):
        b, c, k = scores.shape
        warps = min(32, max(8, -(-k // 256)))
        smem = 16 * -(-k // 4) + 8 * 32 + 16
        out_b = torch.empty((b, c, max_det, 4), dtype=torch.float32, device=scores.device)
        out_s = torch.empty((b, c, max_det), dtype=torch.float32, device=scores.device)
        rc = lib.yrt_nms(scores.data_ptr(), boxes.data_ptr(), out_b.data_ptr(),
                         out_s.data_ptr(), b, c, k, max_det, c * k * 4, k * 4, iou_threshold,
                         score_threshold, empty_score, 2, warps, c, smem,
                         torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the earlier kernel's launch failed ({rc})")
        return out_b, out_s

    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-source", help="an earlier csrc/nms.cu to time beside this one")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("nms_large_split: needs a CUDA GPU", file=sys.stderr)
        return 2
    import chip_smoke
    from yoloret_tpu_torch.ops import _build
    from yoloret_tpu_torch.ops.nms_kernel import plan_nms, suppress

    print(chip_smoke.nvidia_smi_line(), flush=True)
    old = None
    if args.old_source:
        so = os.path.join(tempfile.mkdtemp(), "libnms_old.so")
        p = subprocess.run([_build.nvcc_path(), *_build._flags("nms"), "-o", so,
                            args.old_source], capture_output=True, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {args.old_source}:\n{p.stdout}{p.stderr}")
        old = old_large(so)
    flush = chip_smoke.make_flush()
    clean = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")  # 128 MB

    def timed(fn, flush=flush):
        return chip_smoke.cuda_time_ms(fn, 10, 2, flush)

    def clean_flush():
        clean.sum()  # evicts the L2 with clean lines: no write-back in the window

    tiny = torch.zeros(1, device="cuda")
    print(f"timer floor (empty kernel): {timed(lambda: tiny.zero_()):.4f} ms", flush=True)
    kw = dict(iou_threshold=0.5, score_threshold=0.0)
    for backbone, size, c in SHAPES:
        k = chip_smoke.exact_k(size)
        pred = chip_smoke.make_predictor(args.seed, size=size, backbone=backbone,
                                         class_names=[f"class_{i}" for i in range(c)],
                                         score_threshold=0.0, num_candidates=512,
                                         mixed=c != 20)
        with torch.no_grad():
            boxes, scores = chip_smoke.candidates_at_b128(pred, k, seed=100 + k, per_class=True)
        del pred
        plan = plan_nms(c, k, 20, shared=False)
        for order in ("sorted", "shuffled"):
            if order == "shuffled":
                boxes, scores = chip_smoke.shuffle_pools(boxes, scores, seed=1)
            full = timed(lambda: suppress(boxes, scores, max_det=20, **kw))
            one = timed(lambda: suppress(boxes, scores, max_det=1, **kw))
            read = timed(lambda: torch.amax(scores, -1))
            full_clean = timed(lambda: suppress(boxes, scores, max_det=20, **kw), clean_flush)
            read_clean = timed(lambda: torch.amax(scores, -1), clean_flush)
            out_b, out_s = suppress(boxes, scores, max_det=20, empty_score=float("-inf"), **kw)
            bound, by, work = chip_smoke.nms_bound_ms(boxes, scores, out_b, out_s, 20, 0.0)
            line = (f"{backbone} @{size} b{chip_smoke.BATCH} C={c} K={k} {order} ({plan.warps} "
                    f"warps in the rounds, {plan.smem} B): max_det 20 {full:.4f} ms, max_det 1 "
                    f"{one:.4f} ms, read of the scores (amax) {read:.4f} ms; after a clean "
                    f"flush: max_det 20 {full_clean:.4f} ms, amax {read_clean:.4f} ms; bound "
                    f"{bound:.5f} "
                    f"({by}; {work['boxes_needed']} boxes needed, {work['sorted_pools']} of "
                    f"{work['pools']} pools sorted; counting every box "
                    f"{work['bound_ms_all_boxes']:.5f})")
            if old is not None:
                old_ms = timed(lambda: old(boxes, scores, 20, **kw))
                same = all(torch.equal(a, b) for a, b in zip(
                    old(boxes, scores, 20, **kw), suppress(boxes, scores, max_det=20, **kw)))
                line += f"; earlier kernel {old_ms:.4f} ms, outputs equal: {same}"
            print(line, flush=True)
        del boxes, scores
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
