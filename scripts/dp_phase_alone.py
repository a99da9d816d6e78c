"""Phase 16 of ``chip_smoke.py`` (data parallelism on one card) alone,
on an eval set of ``DP_EVAL_IMAGES`` seeded JPEGs (default 64; 256 is the
whole script's). Writes ``chiprun_out/dp_phase_alone.json``. Run from the
repository's root on a machine with a CUDA card:

    DP_EVAL_IMAGES=256 python3 scripts/dp_phase_alone.py
"""
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def main():
    import torch

    from yoloret_tpu_torch.infer import Predictor

    t0 = time.perf_counter()
    report = {}
    cs.log(cs.nvidia_smi_line())
    cs.build_libraries(report)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pred = cs.make_predictor(0, score_threshold=0.3, num_candidates=64)
    state = {k: v.detach().cpu() for k, v in pred.model.state_dict().items()}
    names = pred.class_names
    del pred
    with tempfile.TemporaryDirectory() as root:
        images = cs.write_eval_images(root, 0, int(os.environ.get("DP_EVAL_IMAGES", "64")))
        cpu = Predictor(weights=state, device="cpu", class_names=names, anchors=cs.ANCHORS,
                        input_hw=(cs.SIZE, cs.SIZE), score_threshold=0.0, num_candidates=512,
                        bf16=False)
        gts = cs.eval_ground_truth(cpu, images, root, 16)
        cs.write_eval_dataset(images, gts, root)
        with open(os.path.join(root, "classes.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
        with open(os.path.join(root, "anchors.txt"), "w") as f:
            f.write(", ".join(f"{w},{h}" for w, h in cs.ANCHORS) + "\n")
        cs.log(f"set-up {time.perf_counter() - t0:.1f} s")
        rows = cs.dp_phase(state, root, 0, report)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/dp_phase_alone.json", "w") as f:
        json.dump(dict(report=report["dp"], rows=rows), f, indent=1, default=str)
    cs.log(json.dumps({"kernels": rows}))
    cs.log(f"total {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
