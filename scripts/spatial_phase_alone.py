"""Phase 17 of ``chip_smoke.py`` (spatial sharding on one card) alone:
builds the kernels, makes the flagship's seeded, calibrated weights and
runs ``spatial_phase``. Writes ``chiprun_out/spatial_phase_alone.json``.
Run from the repository's root on a machine with a CUDA card:

    python3 scripts/spatial_phase_alone.py
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def main():
    import torch

    t0 = time.perf_counter()
    report = {}
    cs.log(cs.nvidia_smi_line())
    cs.build_libraries(report)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pred = cs.make_predictor(0, score_threshold=0.3, num_candidates=64)
    state = {k: v.detach().cpu() for k, v in pred.model.state_dict().items()}
    del pred
    cs.log(f"set-up {time.perf_counter() - t0:.1f} s")
    rows = cs.spatial_phase(state, 0, report)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/spatial_phase_alone.json", "w") as f:
        json.dump(dict(report=report["spatial"], rows=rows), f, indent=1, default=str)
    cs.log(json.dumps({"kernels": rows}))
    cs.log(f"total {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
