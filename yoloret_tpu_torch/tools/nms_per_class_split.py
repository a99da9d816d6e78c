#!/usr/bin/env python3
"""Where the per-class NMS kernel's time goes, on the card.

    python3 yoloret_tpu_torch/tools/nms_per_class_split.py [--old-source FILE] [--seed 0]

On per-class pools of up to 512 candidates (``nms_kernel<NPL>``), model
candidates of seeded, calibrated weights through ``chip_smoke.py``'s
helpers, IoU 0.5:
- the zoom ensemble's pools (``zoom_candidates``: the full 320 input's and
  its 224 centre crop's positions), b128 C=20 at K=256 t=0.3 (serving)
  and K=512 t=0 (MAP grade), and b1 K=256 t=0.3;
- the top-k table's shapes (``model_candidates(per_class=True)``), b8 C=4
  K=64 / 256 / 512 t=0 at 160 px (seeded weights, not the gate's trained
  ones).
For each, the pools as the path sorts them and the same pools shuffled,
times (L2 flushed, the device kept behind the host,
``chip_smoke.cuda_time_ms``):
- ``suppress`` at max_det 20 and at max_det 1 (the loads against the
  rounds);
- the large-pool kernels (``nms_large_walk``, a CTA per pool, then
  ``nms_large_rounds`` for the unsorted ones) driven through the C entry
  at the same K, as a yardstick, and whether their outputs are the
  per-class kernel's bit for bit;
- with ``--old-source`` (an earlier ``csrc/nms.cu``, e.g. ``git show
  bd975ed:yoloret_tpu_torch/csrc/nms.cu``), that version's per-class
  kernel (its plan: 4 warps a CTA, no dynamic shared memory) built
  beside it, and whether its outputs are bit for bit the current ones;
and the bound of ``chip_smoke.nms_bound_ms``. Prints the card's name and
power limit, each ``nms_kernel`` instance's ``-Xptxas -v`` line (of both
builds), the timer's floor, then one line per shape and order. Needs a
CUDA GPU and nvcc; nothing is written to the repository.
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

KW = dict(iou_threshold=0.5)


def c_entry(lib):
    """``yrt_nms`` of a loaded build, with the wrapper's argument types."""
    from yoloret_tpu_torch.ops.nms_kernel import _PROTOTYPES

    lib.yrt_nms.argtypes, lib.yrt_nms.restype = _PROTOTYPES["yrt_nms"]
    return lib.yrt_nms


def run_entry(fn, variant, warps, smem, boxes, scores, max_det, score_threshold, scratch=None):
    """One launch of ``variant`` through a build's C entry on per-class
    pools, with the given plan; returns (boxes, scores) with -inf empty
    slots."""
    import torch

    b, c, k = scores.shape
    out_b = torch.empty((b, c, max_det, 4), dtype=torch.float32, device=scores.device)
    out_s = torch.empty((b, c, max_det), dtype=torch.float32, device=scores.device)
    rc = fn(scores.data_ptr(), boxes.data_ptr(), out_b.data_ptr(), out_s.data_ptr(), b, c, k,
            max_det, c * k * 4, k * 4, KW["iou_threshold"], score_threshold, float("-inf"),
            variant, warps, c, smem, None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"variant {variant} launch failed ({rc})")
    return out_b, out_s


def ptxas_kernel_lines(text):
    import chip_smoke

    return [ln for ln in chip_smoke.ptxas_lines(text) if ln.startswith("nms_kernel")]


def pools(seed):
    """(name, boxes, scores, score threshold) of every shape, sorted as the
    path gives them."""
    import torch

    import chip_smoke

    out = []
    with torch.no_grad():
        zoom = chip_smoke.make_predictor(seed, score_threshold=0.3, num_candidates=256,
                                         zoom_ensemble=True)
        for k, thr in ((256, 0.3), (512, 0.0)):
            boxes, scores = chip_smoke.zoom_candidates(zoom, k, seed=21)
            out.append((f"zoom b{chip_smoke.BATCH} C=20 K={k} t={thr}", boxes, scores, thr))
        boxes, scores = out[0][1][:1].contiguous(), out[0][2][:1].contiguous()
        out.append(("zoom b1 C=20 K=256 t=0.3", boxes, scores, 0.3))
        del zoom
        topk = chip_smoke.make_predictor(seed, size=160, class_names=[f"c{i}" for i in range(4)],
                                         score_threshold=0.0, num_candidates=512)
        for k in (64, 256, 512):
            boxes, scores = chip_smoke.model_candidates(topk, k, seed=0, per_class=True, batch=8)
            out.append((f"top-k b8 C=4 K={k} t=0 @160", boxes, scores, 0.0))
        del topk
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-source", help="an earlier csrc/nms.cu to time beside this one")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("nms_per_class_split: needs a CUDA GPU", file=sys.stderr)
        return 2
    import chip_smoke
    from yoloret_tpu_torch.ops import _build
    from yoloret_tpu_torch.ops.nms_kernel import (ROUNDS_WARPS, _lib, large_smem_bytes,
                                                  plan_nms, suppress)

    print(chip_smoke.nvidia_smi_line(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    current = c_entry(_lib())
    for ln in ptxas_kernel_lines(_build.ptxas_log("nms")):
        print(f"ptxas (this build) {ln}", flush=True)
    old = None
    if args.old_source:
        so = os.path.join(tempfile.mkdtemp(), "libnms_old.so")
        p = subprocess.run([_build.nvcc_path(), *_build._flags("nms"), "-o", so,
                            args.old_source], capture_output=True, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {args.old_source}:\n{p.stdout}{p.stderr}")
        for ln in ptxas_kernel_lines(p.stdout + p.stderr):
            print(f"ptxas (earlier build) {ln}", flush=True)
        old = c_entry(ctypes.CDLL(so))
    flush = chip_smoke.make_flush()

    def timed(fn):
        return chip_smoke.cuda_time_ms(fn, 10, 2, flush)

    tiny = torch.zeros(1, device="cuda")
    print(f"timer floor (empty kernel): {timed(lambda: tiny.zero_()):.4f} ms", flush=True)
    for name, boxes, scores, thr in pools(args.seed):
        b, c, k = scores.shape
        plan = plan_nms(c, k, 20, shared=False)
        assert plan.variant == "per_class", plan
        flags = torch.empty(b * c, dtype=torch.int32, device="cuda")
        large = dict(variant=2, warps=ROUNDS_WARPS, smem=large_smem_bytes(k), scratch=flags)
        for order in ("sorted", "shuffled"):
            if order == "shuffled":
                boxes, scores = chip_smoke.shuffle_pools(boxes, scores, seed=1)
            kw = dict(KW, score_threshold=thr)
            full = timed(lambda: suppress(boxes, scores, max_det=20, **kw))
            one = timed(lambda: suppress(boxes, scores, max_det=1, **kw))
            mine = suppress(boxes, scores, max_det=20, empty_score=float("-inf"), **kw)
            walk = timed(lambda: run_entry(current, boxes=boxes, scores=scores, max_det=20,
                                           score_threshold=thr, **large))
            walk_same = all(torch.equal(g, w) for g, w in zip(
                run_entry(current, boxes=boxes, scores=scores, max_det=20, score_threshold=thr,
                          **large), mine))
            bound, by, work = chip_smoke.nms_bound_ms(boxes, scores, *mine, 20, thr)
            line = (f"{name} {order} (npl {plan.npl}, {plan.warps} warps a CTA, {plan.smem} B): "
                    f"max_det 20 {full:.4f} ms, max_det 1 {one:.4f} ms; large-pool kernels "
                    f"{walk:.4f} ms, outputs equal: {walk_same}; bound {bound:.5f} ({by}; "
                    f"{work['boxes_needed']} boxes needed, {work['sorted_pools']} of "
                    f"{work['pools']} pools sorted, {int(torch.isfinite(mine[1]).sum())} picks)")
            if old is not None:
                prev = dict(variant=0, warps=4, smem=0)
                old20 = timed(lambda: run_entry(old, boxes=boxes, scores=scores, max_det=20,
                                                score_threshold=thr, **prev))
                old1 = timed(lambda: run_entry(old, boxes=boxes, scores=scores, max_det=1,
                                               score_threshold=thr, **prev))
                same = all(torch.equal(g, w) for g, w in zip(
                    run_entry(old, boxes=boxes, scores=scores, max_det=20, score_threshold=thr,
                              **prev), mine))
                line += (f"; earlier kernel max_det 20 {old20:.4f} ms, max_det 1 {old1:.4f} "
                         f"ms, outputs equal: {same}")
            print(line, flush=True)
        del boxes, scores
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
