#!/usr/bin/env python3
"""Where the shared-pool NMS kernel's time goes, on the card.

    python3 yoloret_tpu_torch/tools/nms_split.py [--seed 0]

Times ``suppress`` on a shared pool of C=20 classes at the serving shape
(M=64, score threshold 0.3) and the MAP-grade shape (M=512, threshold 0),
for batch 128 and batch 1, with max_det 1 and 20, L2 flushed and the
device kept behind the host (``chip_smoke.cuda_time_ms``). Boxes are
seeded random boxes of up to 60 px in a 320 px image, scores seeded
random numbers to the fourth power. max_det 1 runs the load, the mask and
one round; the difference to max_det 20 is 19 rounds. Also times an
empty kernel under the same timer (its floor) and the per-class kernel
on the same pools. Prints the card's name and power limit, then one line
per shape. Needs a CUDA GPU and nvcc; nothing is written to the
repository.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("nms_split: needs a CUDA GPU", file=sys.stderr)
        return 2
    import chip_smoke
    from yoloret_tpu_torch.ops.nms_kernel import plan_nms, suppress

    print(chip_smoke.nvidia_smi_line(), flush=True)
    scratch = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()

    def timed(fn):
        return chip_smoke.cuda_time_ms(fn, 20, 2, flush)

    tiny = torch.zeros(1, device="cuda")
    print(f"timer floor (empty kernel): {timed(lambda: tiny.zero_()):.4f} ms", flush=True)
    rs = np.random.RandomState(args.seed)
    c = 20
    for b, m, thr in ((128, 64, 0.3), (128, 512, 0.0), (1, 64, 0.3), (1, 512, 0.0)):
        boxes = rs.rand(b, m, 4).astype(np.float32) * 320
        boxes[..., 2:] = boxes[..., :2] + rs.rand(b, m, 2).astype(np.float32) * 60
        scores = (rs.rand(b, c, m) ** 4).astype(np.float32)
        bt, st = torch.from_numpy(boxes).cuda(), torch.from_numpy(scores).cuda()
        kw = dict(iou_threshold=0.5, score_threshold=thr)
        one = timed(lambda: suppress(bt, st, max_det=1, **kw))
        full = timed(lambda: suppress(bt, st, max_det=20, **kw))
        cls = bt[:, None].expand(b, c, m, 4).contiguous()
        per_class = timed(lambda: suppress(cls, st, max_det=20, **kw))
        plan = plan_nms(c, m, 20, shared=True)
        print(f"b{b} C={c} M={m} t={thr} ({plan.warps} warps, {plan.smem} B shared memory): "
              f"max_det 1 {one:.4f} ms, max_det 20 {full:.4f} ms (19 rounds "
              f"{full - one:.4f} ms); per-class kernel, max_det 20: {per_class:.4f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
