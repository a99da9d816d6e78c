#!/usr/bin/env python3
"""Block-by-block timing and ablations of the bf16 MBConv kernel (``mbconv_wgmma``) on the card.

    python3 yoloret_tpu_torch/tools/mbconv_ablation.py [--shapes ...]
        [--old-source FILE --old-plan FILE] [--plans] [--steps] [--variants]
        [--first-source FILE]

Times the tree's bf16 kernel (``ops/mbconv.py::fused_mbconv`` on weights
packed as the main path packs them) at the 16 blocks of MobileNetV2 at
each of ``--shapes`` (x0.75 @320, x1.4 @224, x1.0 @320, batch 128; seeded
inputs and weights), each beside its plain PyTorch version, the cuDNN
yardstick (three ``F.conv2d``) and its bound, with its tile plan. Timer,
yardstick and bound are ``chip_smoke.py``'s (``cuda_time_ms`` with the L2
flushed and the device kept behind the host, ``library_mbconv``,
``mbconv_bound``). Each block is checked: within atol = rtol = 2e-2 of
the plain version, and two launches on one input bitwise equal.

``--old-source`` / ``--old-plan``: an earlier ``csrc/mbconv.cu`` and its
``ops/mbconv.py`` (``git show <commit>:yoloret_tpu_torch/csrc/mbconv.cu >
build/mbconv_parent.cu``, the same for ``ops/mbconv.py``; ``build/`` is
copied to the card's machine). That kernel is built beside the tree's,
launched under its own plans, checked alike and timed in turns with the
tree's on the same inputs (old, new, new, old), and each block says
whether the two kernels' outputs are equal bit for bit.

``--plans``: each block of more than 120 output channels (the wide
instances) timed under every plan ``ops/mbconv.py::wide_plans`` offers,
each beside its modelled cost: the data ``plan_tile``'s wide model is
fitted to.

``--steps``: variants of the tree's source, each with one step of the
kernel removed by a text substitution (their results are wrong; only the
time is read); a step costs the variant's saving over the full kernel.
``--variants``: the tree's source with one choice of the wide redesign
undone at a time (the producer's registers, the shuffled warpgroup index,
the expand's fence and commit a step, three warpgroups for six
accumulator blocks), each with its ptxas spills and wgmma notes and its
16 blocks summed at every shape; and the build's time without
``-split-compile``.
``--first-source`` (the first version of the kernel, commit 46a8f8c) does
the same for three costs the first redesign set out to remove.

Prints the card's name and power limit, one line per block and a sum per
shape; writes the rows to chiprun_out/mbconv_ablation.json. Needs a CUDA
GPU and nvcc; nothing else is written to the repository.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

SHAPES = {  # name -> (width multiplier, batch, input size)
    "x0.75_b128_320": (0.75, 128, 320),
    "x1.4_b128_224": (1.4, 128, 224),
    "x1.0_b128_320": (1.0, 128, 320),
}
TOL = 2e-2  # chip_smoke.py's MBCONV_TOL["bfloat16"]

# bf16 kernel of this tree: (pattern, replacement) regex substitutions
STEPS = {
    "full": [],
    "no depthwise FMAs": [(r"dx < 3 \+ S; \+\+dx\)", "dx < 0; ++dx)")],
    "no expand wgmma": [(r"k < ksteps; \+\+k\)", "k < 0; ++k)")],
    "no consumer barrier": [(r"named_bar_sync\(1, nthreads\);", ";")],
    "no input TMA": [(r"j < p\.Cin / 8; \+\+j\)", "j < 0; ++j)"),
                     (r"x_tx = uint32_t\(p\.Cin / 8\)[^;]*;", "x_tx = 0;")],
    "no weight copy": [(r"mbar_expect_tx\(w_full\(ws\), p\.chunk_bytes\);(\s*)bulk_load\(",
                        r"mbar_expect_tx(w_full(ws), 0);\1if (0) bulk_load(")],
    "no expanded-chunk stores": [(r"(\*reinterpret_cast<uint32_t\*>\(e_s \+ r \* es\(S\) \+ j\))",
                                  r"if (d[0] == 1234.5f) \1")],
}
# the tree's bf16 kernel with one design choice of the wide redesign undone
VARIANTS = {
    "as built": [],
    "producer at 24 registers": [(r"setmaxnreg\.dec\.sync\.aligned\.u32 32;",
                                  "setmaxnreg.dec.sync.aligned.u32 24;"),
                                 (r"setmaxnreg\.inc\.sync\.aligned\.u32 232;",
                                  "setmaxnreg.inc.sync.aligned.u32 240;")],
    "warpgroup index without the shuffle": [
        (r"wg = __shfl_sync\(0xffffffffu, tid / 128, 0\)", "wg = tid / 128")],
    "expand fenced and committed once a block": [
        (r"        for \(int k = 0; k < ksteps; \+\+k\) \{\n          wg_fence\(\);\n",
         "        wg_fence();\n        for (int k = 0; k < ksteps; ++k) {\n"),
        (r"k > 0\);\n          wg_commit\(\);\n        \}\n", "k > 0);\n        }\n        wg_commit();\n")],
    "six accumulator blocks in four warpgroups": [
        (r"return nb <= 2 \? 4 : nb <= 6 \? 3 : 2;", "return nb <= 2 || nb == 6 ? 4 : nb <= 6 ? 3 : 2;")],
}
# the first version (commit 46a8f8c): costs the first redesign removed
FIRST = {
    "first full": [],
    "first, weights staged once per tile": [
        (r"    // stage this chunk's weights\n", "    if (c0 == 0) {\n"),
        (r"(wd_s\[i\] = j < nc \? to_f\(wd\[tap \* Ce \+ c0 \+ j\]\) : 0\.f;\n    \})",
         r"\1\n    }")],
    "first, no in-chunk barriers": [
        (r"    __syncthreads\(\);\n\n    // (expand|depthwise|project)", r"\n    // \1")],
    "first, no depthwise": [(r"di < 3; \+\+di\)\n#pragma unroll\n          for \(int dj",
                             "di < 0; ++di)\n#pragma unroll\n          for (int dj")],
}


def variant(src: str, subs) -> str:
    for pattern, repl in subs:
        src, n = re.subn(pattern, repl, src)
        if n == 0:
            raise ValueError(f"pattern not in the source: {pattern}")
    return src


def build(sources: dict, flags, logs=None) -> dict:
    """{name: source text} -> {name: loaded library}, one nvcc each, all at once;
    each compiler's output into ``logs`` [name]."""
    from yoloret_tpu_torch.ops import _build

    tmp, procs, libs = tempfile.mkdtemp(), {}, {}
    for i, (name, src) in enumerate(sources.items()):
        cu, so = os.path.join(tmp, f"v{i}.cu"), os.path.join(tmp, f"v{i}.so")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = (so, subprocess.Popen([_build.nvcc_path(), *flags, "-o", so, cu],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    for name, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out[-3000:]}")
        if logs is not None:
            logs[name] = out
        libs[name] = ctypes.CDLL(so)
    return libs


def ptxas_summary(log: str) -> str:
    """The bf16 instances' largest spill and ptxas's notes on wgmma (C7510-C7520)
    by code, from a ``-Xptxas -v`` log."""
    import chip_smoke as C

    spills = [int(m.group(1)) for ln in C.ptxas_lines(log) if ln.startswith("mbconv_wgmma")
              for m in [re.search(r"(\d+) bytes spill stores", ln)] if m]
    notes = {}
    for ln in log.splitlines():
        m = re.search(r"\((C75(?:1\d|20))\)", ln)
        if m:
            notes[m.group(1)] = notes.get(m.group(1), 0) + 1
    return f"largest spill {max(spills, default=0)} bytes, notes {notes or 'none'}"


def blocks_of(shape, dev, g):
    """The 16 blocks of one shape: (block, hw, stride, cin, ce, cout, expand, residual, x,
    weights), seeded; weights scaled by their fan-in so activations stay O(1)."""
    import torch

    from yoloret_tpu_torch.nn.mobilenetv2 import block_specs

    alpha, batch, size = SHAPES[shape]
    hw = size // 2
    for block, (_, stride, t, cin, cout) in enumerate(block_specs(alpha)):
        ce, expand = cin * t, t != 1

        def r(*s):
            return torch.randn(s, generator=g, device=dev) * (0.5 / s[0] ** 0.5 if len(s) > 1
                                                              else 0.2)

        x = (torch.rand((batch, hw, hw, cin), generator=g, device=dev) - 0.25).to(torch.bfloat16)
        bf = torch.bfloat16
        ws = (r(cin, ce).to(bf) if expand else None, r(ce) if expand else None,
              (r(3, 3, ce) * 2).to(bf), r(ce), r(ce, cout).to(bf), r(cout))
        yield block, hw, stride, cin, ce, cout, expand, stride == 1 and cin == cout, x, ws
        hw //= stride


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES), choices=list(SHAPES))
    ap.add_argument("--old-source", help="an earlier csrc/mbconv.cu to time beside the tree's")
    ap.add_argument("--old-plan", help="the ops/mbconv.py of --old-source (its plan_tile)")
    ap.add_argument("--plans", action="store_true", help="time the wide blocks under every plan")
    ap.add_argument("--steps", action="store_true", help="the step-cost ablation")
    ap.add_argument("--variants", action="store_true",
                    help="the wide redesign's choices undone one at a time")
    ap.add_argument("--first-source", help="the first version of csrc/mbconv.cu (46a8f8c)")
    ap.add_argument("--iters", type=int, default=5, help="timed launches per measurement")
    args = ap.parse_args(argv)
    if bool(args.old_source) != bool(args.old_plan):
        ap.error("--old-source and --old-plan go together")

    import torch

    import chip_smoke as C
    from yoloret_tpu_torch.ops import _build
    from yoloret_tpu_torch.ops import mbconv as M

    if not torch.cuda.is_available():
        print("mbconv_ablation: needs a CUDA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card.splitlines()[0] if card else "nvidia-smi: no card line", flush=True)
    t0 = time.perf_counter()
    _build.build_all(["mbconv"])
    print(f"built csrc/mbconv.cu in {time.perf_counter() - t0:.1f} s", flush=True)
    src_path = os.path.join(os.path.dirname(HERE), "csrc", "mbconv.cu")
    if args.variants:  # the build's time without -split-compile, one kernel after another
        t0 = time.perf_counter()
        serial = [f for f in _build._flags("mbconv") if not f.startswith("-split-compile")]
        subprocess.run([_build.nvcc_path(), *serial, "-o", os.path.join(tempfile.mkdtemp(),
                        "serial.so"), src_path], check=True, capture_output=True)
        print(f"built it without -split-compile in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in C.ptxas_lines(_build.ptxas_log("mbconv")):
        if line.startswith("mbconv_wgmma"):
            print(f"ptxas {line}", flush=True)
    src = open(src_path).read()
    flags = _build._flags("mbconv")
    todo = {}
    if args.old_source:
        todo["old"] = open(args.old_source).read()
    if args.steps:
        todo.update({k: variant(src, v) for k, v in STEPS.items()})
    if args.variants:
        todo.update({k: variant(src, v) for k, v in VARIANTS.items()})
    if args.first_source:
        first = open(args.first_source).read()
        todo.update({k: variant(first, v) for k, v in FIRST.items()})
    logs = {}
    libs = build(todo, flags, logs) if todo else {}
    for name in VARIANTS if args.variants else ():
        print(f"ptxas {name}: {ptxas_summary(logs[name])}", flush=True)
    old_plan = None
    if args.old_plan:
        spec = importlib.util.spec_from_file_location("mbconv_old_plan", args.old_plan)
        old_plan = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(old_plan)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        if hasattr(lib, "yrt_mbconv_bf16"):
            lib.yrt_mbconv_bf16.restype = ci

    dev = torch.device("cuda")
    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    flush = C.make_flush()

    def time_ms(fn, iters=args.iters):
        return C.cuda_time_ms(fn, iters, 1, flush)

    def launcher(lib, x, packed, bp, out, hw, stride, cin, ce, cout, expand, residual, plan):
        """A launch of ``lib``'s bf16 entry under ``plan`` (with ``ks``, the
        tree's signature; without, the parent's)."""
        batch = x.shape[0]
        ptrs = [vp(t.data_ptr()) for t in (x, packed.w, bp, out)]
        ints = [batch, hw, hw, cin, ce, cout, packed.nchunks, stride, int(expand), int(residual),
                plan.th, plan.tw, plan.nc] + ([plan.ks] if hasattr(plan, "ks") else []) + [
                plan.xst, plan.wst, plan.grid, plan.smem]
        fn = lib.yrt_mbconv_bf16
        fn.argtypes = [vp] * 4 + [ci] * len(ints) + [vp]

        def run():
            rc = fn(*ptrs, *[ci(v) for v in ints], vp(torch.cuda.current_stream().cuda_stream))
            if rc != 0:
                raise RuntimeError(f"launch failed under {plan}: CUDA error {rc}")
            return out

        return run

    report = dict(card=card, rows=[], plans=[], steps={})
    g = torch.Generator(device=dev).manual_seed(0)
    for shape in args.shapes:
        sums = {}
        for block, hw, stride, cin, ce, cout, expand, residual, x, ws in blocks_of(shape, dev, g):
            kw = dict(stride=stride, residual=residual)
            packed = M.pack_mbconv(*ws[:5])
            ho = hw // stride
            shp = (ho, ho, stride, cin, ce, cout, expand, x.shape[0], nsm)
            plan = M.plan_tile(*shp)
            want = M.reference_mbconv(x, *ws, **kw)
            runs = {"new": lambda: M.fused_mbconv(x, *ws, packed=packed, **kw)}
            if "old" in libs:
                runs["old"] = launcher(libs["old"], x, packed, ws[5], torch.empty_like(want), hw,
                                       stride, cin, ce, cout, expand, residual,
                                       old_plan.plan_tile(*shp))
            row = dict(shape=shape, block=block, input=list(x.shape), stride=stride, ce=ce,
                       cout=cout, plan=plan._asdict())
            first = {}
            for name, fn in runs.items():
                a, b = fn().clone(), fn().clone()
                torch.cuda.synchronize()
                first[name] = a
                row[f"{name}_max_abs_err"] = (a.float() - want.float()).abs().max().item()
                row[f"{name}_ok"] = torch.allclose(a.float(), want.float(), atol=TOL, rtol=TOL)
                row[f"{name}_bitwise_repeat"] = torch.equal(a, b)
            if "old" in runs:
                row["new_equals_old_bitwise"] = torch.equal(first["new"], first["old"])
            times = {}
            for name in (["old", "new", "new", "old"] if "old" in runs else ["new", "new"]):
                times.setdefault(name, []).append(time_ms(runs[name]))
            for name, v in times.items():
                row[f"{name}_ms"] = sum(v) / len(v)
            row["plain_ms"] = time_ms(lambda: M.reference_mbconv(x, *ws, **kw), 3)
            row["cudnn_ms"] = time_ms(lambda: C.library_mbconv(x, *ws, **kw))
            meta = types.SimpleNamespace(args=ws, stride=stride)
            row["bound_ms"], row["bound_by"] = C.mbconv_bound(x, meta, 2)[:2]
            report["rows"].append(row)
            for k in ("new_ms", "old_ms", "plain_ms", "cudnn_ms", "bound_ms"):
                if k in row:
                    sums[k] = sums.get(k, 0.0) + row[k]
            oldtxt = (f" old {row['old_ms']:.4f} (bitwise equal to the kernel's "
                      f"{row['new_equals_old_bitwise']})" if "old" in runs else "")
            print(f"{shape} block {block:2d} {tuple(row['input'])} s{stride} Ce {ce} Cout {cout} "
                  f"tile {plan.th}x{plan.tw} nc {plan.nc} ks {plan.ks} stages {plan.xst}/"
                  f"{plan.wst} grid {plan.grid}: kernel {row['new_ms']:.4f} ms (err "
                  f"{row['new_max_abs_err']:.2e}, repeat bitwise {row['new_bitwise_repeat']})"
                  f"{oldtxt}, plain {row['plain_ms']:.4f}, cuDNN {row['cudnn_ms']:.4f}, bound "
                  f"{row['bound_ms']:.5f} ({row['bound_by']})", flush=True)
            if args.plans and M._round_up(cout, M.NBW) // M.NBW >= M.WIDE_NB:
                out = torch.empty_like(want)
                lib = M._lib()
                for cost, p in sorted(M.wide_plans(*shp), key=lambda cp: cp[0]):
                    if p.items > 8 * x.shape[0]:  # tiles of a few pixels: not worth a launch
                        continue
                    fn = launcher(lib, x, packed, ws[5], out, hw, stride, cin, ce, cout, expand,
                                  residual, p)
                    ok = torch.allclose(fn().float(), want.float(), atol=TOL, rtol=TOL)
                    ms = time_ms(fn, 3)
                    report["plans"].append(dict(shape=shape, block=block, plan=p._asdict(),
                                                cost=cost, ms=ms, ok=ok))
                    print(f"  plan {p.th}x{p.tw} nc {p.nc} ks {p.ks} stages {p.xst}/{p.wst} "
                          f"items {p.items}: model {cost:.1f}, {ms:.4f} ms, ok {ok}", flush=True)
            del x, want
        report.setdefault("sums", {})[shape] = sums
        wide = [r for r in report["rows"] if r["shape"] == shape and r["cout"] > 120]
        widesum = {k: sum(r[k] for r in wide) for k in ("new_ms", "old_ms", "cudnn_ms", "bound_ms")
                   if wide and k in wide[0]}
        report.setdefault("wide_sums", {})[shape] = widesum
        print(f"{shape} 16 blocks summed: " + ", ".join(f"{k} {v:.4f}" for k, v in sums.items())
              + (f"; the {len(wide)} blocks past Cout 120: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in widesum.items()) if wide else ""), flush=True)
    # step costs at the first shape, as timed before; variants at every shape
    for shape in args.shapes:
        for name, lib in libs.items():
            if name == "old" or (shape != args.shapes[0] and name not in VARIANTS):
                continue
            total = wide = 0.0
            for block, hw, stride, cin, ce, cout, expand, residual, x, ws in blocks_of(
                    shape, dev, torch.Generator(device=dev).manual_seed(0)):
                out = torch.empty((x.shape[0], hw // stride, hw // stride, cout),
                                  dtype=torch.bfloat16, device=dev)
                if name.startswith("first"):
                    ptrs = [vp(0 if t is None else t.data_ptr()) for t in (x, *ws, out)]
                    ints = [ci(v) for v in (x.shape[0], hw, hw, cin, ce, cout, stride,
                                            int(expand), int(residual), 1)]
                    st = vp(torch.cuda.current_stream().cuda_stream)
                    fn = lambda: lib.yrt_mbconv(*ptrs, *ints, st)  # noqa: E731
                else:
                    fn = launcher(lib, x, M.pack_mbconv(*ws[:5]), ws[5], out, hw, stride, cin, ce,
                                  cout, expand, residual,
                                  M.plan_tile(hw // stride, hw // stride, stride, cin, ce, cout,
                                              expand, x.shape[0], nsm))
                ms = time_ms(fn)
                total += ms
                wide += ms if cout > 120 else 0.0
            report["steps"][f"{name} @{shape}"] = total
            print(f"{name:46s} {shape}, 16 blocks: {total:.4f} ms"
                  + (f", the blocks past Cout 120: {wide:.4f}" if wide else ""), flush=True)
    bad = [(r["shape"], r["block"]) for r in report["rows"]
           if not all(r[k] for k in r if k.endswith("_ok") or k.endswith("_bitwise_repeat"))]
    bad += [(p["shape"], p["block"], p["plan"]) for p in report["plans"] if not p["ok"]]
    out = os.path.join(ROOT, "chiprun_out", "mbconv_ablation.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    if bad:
        print(f"mbconv_ablation: disagree with the plain version or do not repeat bitwise: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
