#!/usr/bin/env python3
"""Block-by-block timing of the float32 MBConv kernel (``mbconv_f32``) on the card.

    python3 yoloret_tpu_torch/tools/mbconv_f32_bench.py [--old-source FILE] [--shapes ...]

Times the tree's ``mbconv_f32`` (through ``ops/mbconv.py::fused_mbconv``,
on the weights packed as the main path packs them) at the 16 blocks of
MobileNetV2 x0.75 at [8, 96] and [8, 160] (the learn phase's evaluations)
and [128, 320] (phases 5 and 6), and of x1.4 at [128, 224] (the COCO
config), each beside its plain PyTorch version, the cuDNN yardstick
(three ``F.conv2d``, float32 with TF32 off) and its bound, with the
block's launch plan where the tree has ``plan_tile_f32``. Inputs and
weights are seeded; timer, yardstick and bound are ``chip_smoke.py``'s
(``cuda_time_ms`` with the L2 flushed, ``library_mbconv``,
``mbconv_bound``).

Each block is also checked: the kernel against its plain version within
atol = rtol = 1e-4, and two launches on one input bitwise equal; with
``--old-source`` it also reports whether the two kernels' outputs are
equal bit for bit.

With ``--old-source`` (an earlier ``csrc/mbconv.cu``, e.g. ``git show
<commit>:yoloret_tpu_torch/csrc/mbconv.cu > build/mbconv_parent.cu``,
whose float32 entry point takes the unpacked weights) that kernel is
built beside the tree's and both are timed in turns on the same inputs
(old, new, new, old), and checked alike.

Prints the card's name and power limit, then one line per block and one
sum per shape; writes the rows to chiprun_out/mbconv_f32_bench.json.
Needs a CUDA GPU and nvcc; nothing else is written to the repository.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

SHAPES = {  # name -> (width multiplier, batch, input size)
    "x0.75_b8_96": (0.75, 8, 96),
    "x0.75_b8_160": (0.75, 8, 160),
    "x0.75_b128_320": (0.75, 128, 320),
    "x1.4_b128_224": (1.4, 128, 224),
}
TOL = 1e-4  # chip_smoke.py's MBCONV_TOL["float32"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-source", help="an earlier csrc/mbconv.cu to time beside the tree's")
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES), choices=list(SHAPES))
    ap.add_argument("--iters", type=int, default=5, help="timed launches per measurement")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as C
    from yoloret_tpu_torch.nn.mobilenetv2 import block_specs
    from yoloret_tpu_torch.ops import _build
    from yoloret_tpu_torch.ops import mbconv as M

    if not torch.cuda.is_available():
        print("mbconv_f32_bench: needs a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card.splitlines()[0] if card else "nvidia-smi: no card line", flush=True)

    old = None
    if args.old_source:
        tmp = tempfile.mkdtemp()
        so = os.path.join(tmp, "libmbconv_old.so")
        p = subprocess.run([_build.nvcc_path(), *_build._flags("mbconv"), "-o", so,
                            args.old_source], capture_output=True, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {args.old_source}:\n{p.stdout[-3000:]}"
                               f"{p.stderr[-3000:]}")
        old = ctypes.CDLL(so)
        old.yrt_mbconv_f32.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        old.yrt_mbconv_f32.restype = ctypes.c_int
    _build.build_all(["mbconv"])
    fn = ""
    for line in _build.ptxas_log("mbconv").splitlines():  # registers and spills
        if "Compiling entry function" in line:
            fn = "mbconv_f32<1>" if "mbconv_f32ILi1E" in line else (
                "mbconv_f32<2>" if "mbconv_f32ILi2E" in line else "")
        elif fn and ("registers" in line or "spill" in line):
            print(f"ptxas {fn}: {line.split(':', 1)[-1].strip()}", flush=True)

    dev = torch.device("cuda")
    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    flush = C.make_flush()

    def time_ms(fn, iters):
        return C.cuda_time_ms(fn, iters, 1, flush)

    pack = getattr(M, "pack_mbconv_f32", None)
    plan_f32 = getattr(M, "plan_tile_f32", None)
    report = dict(card=card, rows=[])
    for shape in args.shapes:
        alpha, batch, size = SHAPES[shape]
        g = torch.Generator(device=dev).manual_seed(0)
        hw = size // 2
        sums = {}
        for block, (_, stride, t, cin, cout) in enumerate(block_specs(alpha)):
            ce, expand = cin * t, t != 1
            residual = stride == 1 and cin == cout

            def r(*s):
                return torch.randn(s, generator=g, device=dev) * (0.5 / s[0] ** 0.5 if len(s) > 1
                                                                  else 0.2)

            x = torch.rand((batch, hw, hw, cin), generator=g, device=dev) - 0.25
            ws = (r(cin, ce) if expand else None, r(ce) if expand else None, r(3, 3, ce) * 2,
                  r(ce), r(ce, cout), r(cout))
            packed = pack(*ws[:5]) if pack is not None else None
            kw = dict(stride=stride, residual=residual)
            new = lambda: M.fused_mbconv(x, *ws, packed=packed, **kw)  # noqa: E731
            plain = lambda: M.reference_mbconv(x, *ws, **kw)  # noqa: E731
            want = plain()
            runs = {"new": new}
            if old is not None:
                out = torch.empty_like(want)
                ptrs = [ctypes.c_void_p(0 if v is None else v.data_ptr()) for v in (x, *ws, out)]
                ints = [ctypes.c_int(v) for v in (batch, hw, hw, cin, ce, cout, stride,
                                                  int(expand), int(residual))]
                st = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

                def run_old(out=out, ptrs=ptrs, ints=ints, st=st):
                    rc = old.yrt_mbconv_f32(*ptrs, *ints, st)
                    if rc != 0:
                        raise RuntimeError(f"old kernel: CUDA error {rc}")
                    return out

                runs["old"] = run_old
            row = dict(shape=shape, block=block, input=[batch, hw, hw, cin], stride=stride, ce=ce,
                       cout=cout)
            first = {}
            for name, fn in runs.items():
                a, b = fn().clone(), fn().clone()
                torch.cuda.synchronize()
                first[name] = a
                row[f"{name}_max_abs_err"] = (a - want).abs().max().item()
                row[f"{name}_ok"] = torch.allclose(a, want, atol=TOL, rtol=TOL)
                row[f"{name}_bitwise_repeat"] = torch.equal(a, b)
            if old is not None:  # for information: the same sums in the same order?
                row["new_equals_old_bitwise"] = torch.equal(first["new"], first["old"])
            order = ["old", "new", "new", "old"] if old is not None else ["new", "new"]
            times = {}
            for name in order:
                times.setdefault(name, []).append(time_ms(runs[name], args.iters))
            for name, v in times.items():
                row[f"{name}_ms"] = sum(v) / len(v)
            row["plain_ms"] = time_ms(plain, 3)
            row["cudnn_ms"] = time_ms(lambda: C.library_mbconv(x, *ws, **kw), args.iters)
            meta = types.SimpleNamespace(args=ws, stride=stride)
            row["bound_ms"], row["bound_by"] = C.mbconv_bound(x, meta, 4)[:2]
            plan = ""
            if plan_f32 is not None:
                p = plan_f32(hw // stride, hw // stride, stride, cin, ce, cout, expand, batch,
                             nsm)
                row["plan"] = p._asdict()
                plan = (f" tile {p.th}x{p.tw} rq {p.rq} px {p.px} cluster {p.cluster} grid "
                        f"{p.ctas} smem {p.smem}")
            report["rows"].append(row)
            for k in ("new_ms", "old_ms", "plain_ms", "cudnn_ms", "bound_ms"):
                if k in row:
                    sums[k] = sums.get(k, 0.0) + row[k]
            oldtxt = (f" old {row['old_ms']:.4f} (err {row['old_max_abs_err']:.2e}, bitwise "
                      f"equal to the kernel's {row['new_equals_old_bitwise']})"
                      if old is not None else "")
            print(f"{shape} block {block:2d} {tuple(row['input'])} s{stride} Ce {ce} Cout {cout}"
                  f"{plan}: kernel {row['new_ms']:.4f} ms (err {row['new_max_abs_err']:.2e}, "
                  f"repeat bitwise {row['new_bitwise_repeat']}){oldtxt}, plain "
                  f"{row['plain_ms']:.4f}, cuDNN {row['cudnn_ms']:.4f}, bound "
                  f"{row['bound_ms']:.5f} ({row['bound_by']})", flush=True)
            hw //= stride
            del x, want
        report.setdefault("sums", {})[shape] = sums
        print(f"{shape} 16 blocks summed: " + ", ".join(f"{k} {v:.4f}" for k, v in sums.items()),
              flush=True)
    bad = [r for r in report["rows"]
           if not all(r[k] for k in r if k.endswith("_ok") or k.endswith("_bitwise_repeat"))]
    out = os.path.join(ROOT, "chiprun_out", "mbconv_f32_bench.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    if bad:
        print(f"mbconv_f32_bench: {len(bad)} blocks disagree with the plain version or do not "
              f"repeat bitwise: {[(r['shape'], r['block']) for r in bad]}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
