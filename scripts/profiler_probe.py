"""How many of a 2-replica ``Predictor``'s kernels ``torch.profiler``
records in a fresh process: ``chip_smoke.py`` phase 16(c)'s serving batch
(b128 @320 bf16 over ``make_mesh(["cuda:0"] * 2)``) under eight profiler
sessions in a row (CUDA only; after CPU+CUDA sessions; with
``acc_events``), each printed as a ``PROBE`` line with the MBConv and NMS
kernel counts of ``prof.events()``, of the raw Kineto events and of
``key_averages()``. Run from the repository's root on a machine with a
CUDA card:

    python3 scripts/profiler_probe.py
"""
import json
import os
import sys
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from yoloret_tpu_torch.parallel.mesh import make_mesh

    cs.log(cs.nvidia_smi_line())
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    cs.build_libraries({})
    one = cs.make_predictor(0, score_threshold=0.3, num_candidates=64)
    state = {k: v.detach().cpu() for k, v in one.model.state_dict().items()}
    dp = cs.make_predictor(0, weights=state, score_threshold=0.3, num_candidates=64,
                           mesh=make_mesh(["cuda:0"] * 2))
    g = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randint(0, 256, (128, 320, 320, 3), generator=g, device="cuda",
                           dtype=torch.uint8)
    hw = torch.full((128, 2), 320.0, device="cuda")
    dp.infer(images, hw)
    one.infer(images, hw)
    torch.cuda.synchronize()
    CPU, CUDA = ProfilerActivity.CPU, ProfilerActivity.CUDA

    def probe(tag, fn, acts, **kw):
        torch.cuda.synchronize()
        with profile(activities=acts, **kw) as prof:
            with torch.inference_mode():
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        raw = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        out = dict(tag=tag,
                   events=dict(mbconv=sum("mbconv" in e.name for e in ev),
                               nms=sum("nms" in e.name for e in ev), all=len(ev)),
                   raw=dict(mbconv=sum("mbconv" in e.name() for e in raw),
                            nms=sum("nms" in e.name() for e in raw), all=len(raw)),
                   key_avg={k.key[:50]: k.count for k in prof.key_averages()
                            if "mbconv" in k.key or "nms" in k.key},
                   mb=sorted(Counter((e.name()[:40], e.device_resource_id())
                                     for e in raw if "mbconv" in e.name()).items()))
        mb = sorted((e.start_ns(), e.correlation_id(), e.name()[:30]) for e in raw
                    if "mbconv" in e.name())
        out["corr"] = [c for _, c, _ in mb]
        out["gaps_us"] = [round((b[0] - a[0]) / 1e3, 1) for a, b in zip(mb, mb[1:])]
        cs.log("PROBE " + json.dumps(out, default=str))

    dpi = lambda: dp.infer(images, hw)  # noqa: E731
    onei = lambda: one.infer(images, hw)  # noqa: E731
    probe("cuda_only_first", dpi, [CUDA])
    probe("cuda_only_again", dpi, [CUDA])
    probe("cpu_cuda_one", onei, [CPU, CUDA])
    probe("cuda_only_after_cpu_cuda", dpi, [CUDA])
    probe("cpu_cuda_dp", dpi, [CPU, CUDA])
    probe("cuda_only_after_2", dpi, [CUDA])
    try:
        probe("cuda_only_acc_events", dpi, [CUDA], acc_events=True)
    except TypeError as e:
        cs.log(f"PROBE acc_events: {e}")
    probe("cuda_only_one", onei, [CUDA])


if __name__ == "__main__":
    main()
