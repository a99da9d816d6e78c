#!/usr/bin/env python3
"""Serving throughput with ReLU6 as shipped and in its autograd form, on
the card.

    python3 yoloret_tpu_torch/tools/activation_ab.py [--pairs 10]

``nn/layers.py::relu6`` runs one kernel on a tensor that needs no
gradient and, under autograd, a form with JAX's gradient at the kinks
that runs two. This times serving (``Predictor.infer``,
MobileNetV2 x0.75 with 20 classes, b128@320 bf16, score threshold 0.3,
M=64, seeded weights with BatchNorm calibrated as
``chip_smoke.make_predictor`` does; ``chip_smoke.cuda_time_ms`` over 20
batches after 3, the host's enqueue included) with each form, in
``--pairs`` pairs whose order alternates. Prints the card's name and
power limit, one JSON line per pair, then the medians, the quartiles'
distance of each form and the pairs the shipped form won. Needs a CUDA
GPU and nvcc; nothing is written to the repository.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("activation_ab: needs a CUDA GPU", file=sys.stderr)
        return 2
    import chip_smoke
    from yoloret_tpu_torch.nn import fused_infer, layers

    forms = {
        "shipped": layers.relu6,
        "autograd": lambda x: torch.minimum(torch.maximum(x, x.new_zeros(())),
                                            x.new_full((), 6.0)),
    }

    print(chip_smoke.nvidia_smi_line(), flush=True)
    chip_smoke.build_libraries({})
    pred = chip_smoke.make_predictor(0, score_threshold=0.3, num_candidates=64)
    acts = [m for m in pred.model.modules() if getattr(m, "act", None) is layers.relu6]
    g = torch.Generator(device=chip_smoke.DEVICE).manual_seed(0)
    images = torch.randint(0, 256, (chip_smoke.BATCH, *pred.input_hw, 3), generator=g,
                           device=chip_smoke.DEVICE, dtype=torch.uint8)
    hw = torch.full((chip_smoke.BATCH, 2), float(pred.input_hw[0]), device=chip_smoke.DEVICE)
    rates = {name: [] for name in forms}
    wins = 0
    for i in range(args.pairs):
        pair = {}
        for name in (("shipped", "autograd") if i % 2 == 0 else ("autograd", "shipped")):
            for m in acts:
                m.act = forms[name]
            fused_infer.relu6 = forms[name]
            ms = chip_smoke.cuda_time_ms(lambda: pred.infer(images, hw), iters=20, warmup=3)
            pair[name] = chip_smoke.BATCH * 1e3 / ms
            rates[name].append(pair[name])
        wins += pair["shipped"] > pair["autograd"]
        print(json.dumps({"pair": i, "serving_img_per_s": pair}), flush=True)
    q = {name: np.percentile(v, [25, 50, 75]).tolist() for name, v in rates.items()}
    print(json.dumps({"activations_modules": len(acts),
                      "median_img_per_s": {n: v[1] for n, v in q.items()},
                      "quartile_distance": {n: v[2] - v[0] for n, v in q.items()},
                      "shipped_won": f"{wins} of {args.pairs}"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
