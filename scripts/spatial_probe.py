"""Where the row-sharded forward (``yoloret_tpu_torch/parallel/spatial.py``)
differs from one device's, and what it costs the host, on one card.

    python3 scripts/spatial_probe.py

The flagship (MobileNetV2 x0.75 @320, seeded and calibrated as
``chip_smoke.py`` makes it), b128 images of uniform noise:

1. bf16 heads: one device's and the 2x2 mesh's, each against the float32
   one-device heads and against each other (max abs, mean abs, share of
   elements beyond atol = rtol 2e-2); the backbone taps c2-c5 of the row
   shards against one device's (share of elements that differ); the same
   heads with cuDNN off (PyTorch's own convolutions).
2. Host time: one device's forward at b128 and b64 (enqueue, then to the
   synchronize), and ``spatial_apply`` over meshes of 2x1, 1x2, 2x2 and
   1x4 entries of ``cuda:0`` (the mean of 5 calls after 2, host clock to
   the synchronize), with a call's count of exchanges
   (``run_groups.exchanges``: each row shard's calls of the halo and
   sum exchange).
3. The first use of a cuBLAS product and a cuDNN convolution in a new
   host thread against the main thread's second use (each shard thread is
   a new thread).

Writes ``chiprun_out/spatial_probe.json``.
"""
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def head_stats(a, b, tol=2e-2):
    out = []
    for x, y in zip(a, b):
        d = (x.float() - y.float()).abs()
        out.append(dict(max=d.max().item(), mean=d.mean().item(),
                        beyond=(d > tol + tol * y.float().abs()).float().mean().item()))
    return out


def divergence(state, images, out):
    import torch

    from yoloret_tpu_torch.nn.fused_infer import fused_detector_apply, mobilenetv2_fused_features
    from yoloret_tpu_torch.parallel import make_mesh, spatial_apply, spatial_params
    from yoloret_tpu_torch.parallel.spatial import run_groups

    mesh = make_mesh(["cuda:0"] * 4, data=2, model=2)
    f32 = cs.make_predictor(0, weights=state, bf16=False)
    bf = cs.make_predictor(0, weights=state, bf16=True)
    params = spatial_params(bf.model, mesh)
    fused = params[mesh.devices[0]][1]
    with torch.inference_mode():
        ref = fused_detector_apply(f32.model, images, f32._fused)
        one = fused_detector_apply(bf.model, images, bf._fused)
        got = spatial_apply(bf.model, mesh, images, params)
        out["bf16"] = dict(one_vs_f32=head_stats(one, ref), mesh_vs_f32=head_stats(got, ref),
                           mesh_vs_one=head_stats(got, one))
        half = images[:BATCH // 2]
        taps_one = mobilenetv2_fused_features(half.to(torch.bfloat16), bf._fused)
        shards = run_groups(lambda x: mobilenetv2_fused_features(x.to(torch.bfloat16).contiguous(),
                                                                 fused),
                            mesh, [half, images[BATCH // 2:]])[0]
        out["taps_differing"] = {
            k: (torch.cat([s[k] for s in shards], dim=1) != taps_one[k]).float().mean().item()
            for k in ("c2", "c3", "c4", "c5")}
        torch.backends.cudnn.enabled = False
        try:
            out["bf16_cudnn_off_mesh_vs_one"] = head_stats(
                spatial_apply(bf.model, mesh, images, params),
                fused_detector_apply(bf.model, images, bf._fused))
        finally:
            torch.backends.cudnn.enabled = True
    cs.log(f"1. bf16 heads (max, mean abs, share beyond 2e-2): one device vs float32 "
           f"{out['bf16']['one_vs_f32']}; 2x2 mesh vs float32 {out['bf16']['mesh_vs_f32']}; "
           f"mesh vs one {out['bf16']['mesh_vs_one']}; taps differing {out['taps_differing']}; "
           f"cuDNN off, mesh vs one {out['bf16_cudnn_off_mesh_vs_one']}")


def host_time(pred, images, out):
    import torch

    from yoloret_tpu_torch.nn.fused_infer import fused_detector_apply
    from yoloret_tpu_torch.parallel import make_mesh, spatial_apply, spatial_params
    from yoloret_tpu_torch.parallel.spatial import run_groups

    def per_call(fn, n=5):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e3

    m = pred.model
    res = out["host_ms"] = {}
    with torch.inference_mode():
        for b in (BATCH, BATCH // 2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fused_detector_apply(m, images[:b], pred._fused)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            res[f"one_b{b}"] = dict(enqueue=(t1 - t) * 1e3, to_sync=(time.perf_counter() - t) * 1e3,
                                    per_call=per_call(lambda: fused_detector_apply(
                                        m, images[:b], pred._fused)))
        for data, model in ((2, 1), (1, 2), (2, 2), (1, 4)):
            mesh = make_mesh(["cuda:0"] * (data * model), data=data, model=model)
            p = spatial_params(m, mesh)
            run_groups.exchanges = 0
            spatial_apply(m, mesh, images, p)
            n = run_groups.exchanges
            res[f"mesh_{data}x{model}"] = dict(per_call=per_call(
                lambda: spatial_apply(m, mesh, images, p)), exchanges=n)
    cs.log(f"2. host ms a b{BATCH} forward: {json.dumps(res)}")


def thread_first_use(out):
    import torch
    import torch.nn.functional as F

    x = torch.rand(64, 40, 40, 96, device="cuda", dtype=torch.bfloat16)
    w = torch.rand(96, 96, device="cuda", dtype=torch.bfloat16)
    wc = torch.rand(96, 1, 3, 3, device="cuda", dtype=torch.bfloat16)

    def ops(rec):
        with torch.inference_mode():
            for name, f in (("linear", lambda: F.linear(x, w)),
                            ("conv", lambda: F.conv2d(x.permute(0, 3, 1, 2), wc, groups=96,
                                                      padding=1))):
                t = time.perf_counter()
                f()
                rec[name] = (time.perf_counter() - t) * 1e3

    res = out["first_use_ms"] = {}
    for label in ("main", "main_again"):
        res[label] = {}
        ops(res[label])
    for i in range(3):
        res[f"new_thread_{i}"] = {}
        th = threading.Thread(target=ops, args=(res[f"new_thread_{i}"],))
        th.start()
        th.join()
    cs.log(f"3. first use ms: {json.dumps(res)}")


BATCH = 128


def main():
    import torch

    t0 = time.perf_counter()
    report = {}
    out = dict(card=cs.nvidia_smi_line())
    cs.log(out["card"])
    cs.build_libraries(report)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pred = cs.make_predictor(0, score_threshold=0.3, num_candidates=64)
    state = {k: v.detach().cpu() for k, v in pred.model.state_dict().items()}
    g = torch.Generator(device="cuda").manual_seed(17)
    images = torch.rand((BATCH, cs.SIZE, cs.SIZE, 3), generator=g, device="cuda")
    divergence(state, images, out)
    host_time(pred, images, out)
    thread_first_use(out)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/spatial_probe.json", "w") as f:
        json.dump(out, f, indent=1)
    cs.log(f"total {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
