#!/usr/bin/env python3
"""Ablation timing of the fused MBConv kernel on the card.

    python3 yoloret_tpu_torch/tools/mbconv_ablation.py [--old-source FILE]

Builds variants of ``csrc/mbconv.cu`` in a temporary directory, each with
one step of the bf16 kernel removed by a text substitution (the results
are wrong; only the time is read), and times each at the 16 blocks of
MobileNetV2 x0.75 @ 320, batch 128, random bf16 inputs, L2 flushed and
the device kept behind the host (as ``chip_smoke.py`` times kernels).
The time a step costs is the variant's saving over the full kernel.
With ``--old-source`` (the first version of the kernel, e.g. ``git show
46a8f8c:yoloret_tpu_torch/csrc/mbconv.cu``) the same is done for three
costs the redesign set out to remove from that version. Prints the
card's name and power limit, then one line per variant: the 16 blocks
summed, then each block.
Needs a CUDA GPU and nvcc; nothing is written to the repository.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

# bf16 kernel of this tree: (pattern, replacement) regex substitutions
NEW = {
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
# the first version (commit 46a8f8c): costs the redesign removed
OLD = {
    "old full": [],
    "old, weights staged once per tile": [
        (r"    // stage this chunk's weights\n", "    if (c0 == 0) {\n"),
        (r"(wd_s\[i\] = j < nc \? to_f\(wd\[tap \* Ce \+ c0 \+ j\]\) : 0\.f;\n    \})",
         r"\1\n    }")],
    "old, no in-chunk barriers": [
        (r"    __syncthreads\(\);\n\n    // (expand|depthwise|project)", r"\n    // \1")],
    "old, no depthwise": [(r"di < 3; \+\+di\)\n#pragma unroll\n          for \(int dj",
                                    "di < 0; ++di)\n#pragma unroll\n          for (int dj")],
}


def variant(src: str, subs) -> str:
    for pattern, repl in subs:
        src, n = re.subn(pattern, repl, src)
        if n == 0:
            raise ValueError(f"pattern not in the source: {pattern}")
    return src


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-source", help="an earlier csrc/mbconv.cu (commit 46a8f8c)")
    args = ap.parse_args(argv)

    import torch

    from yoloret_tpu_torch.nn.mobilenetv2 import block_specs
    from yoloret_tpu_torch.ops import _build
    from yoloret_tpu_torch.ops import mbconv as M

    if not torch.cuda.is_available():
        print("mbconv_ablation: needs a CUDA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card.splitlines()[0] if card else "nvidia-smi: no card line", flush=True)
    new = open(os.path.join(os.path.dirname(HERE), "csrc", "mbconv.cu")).read()
    todo = {k: variant(new, v) for k, v in NEW.items()}
    if args.old_source:
        old = open(args.old_source).read()
        todo.update({k: variant(old, v) for k, v in OLD.items()})
    tmp = tempfile.mkdtemp()
    procs = {}
    for i, (name, src) in enumerate(todo.items()):
        cu, so = os.path.join(tmp, f"v{i}.cu"), os.path.join(tmp, f"v{i}.so")
        open(cu, "w").write(src)
        procs[name] = (so, subprocess.Popen([_build.nvcc_path(), *_build._flags("mbconv"), "-o",
                                             so, cu], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    for name, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out[-3000:]}")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    shapes, hw = [], 160
    for _, stride, t, cin, cout in block_specs(0.75):
        shapes.append((hw, stride, cin, cin * t, cout, t != 1, stride == 1 and cin == cout))
        hw //= stride
    blocks = []
    for hw, stride, cin, ce, cout, expand, residual in shapes:
        def r(*s):
            return (torch.randn(s, generator=g, device=dev) * 0.2)
        x = (torch.rand((128, hw, hw, cin), generator=g, device=dev) - 0.5).to(torch.bfloat16)
        we = r(cin, ce).to(torch.bfloat16) if expand else None
        be = r(ce) if expand else None
        ws = (we, be, r(3, 3, ce).to(torch.bfloat16), r(ce), r(ce, cout).to(torch.bfloat16),
              r(cout))
        out = torch.empty((128, hw // stride, hw // stride, cout), dtype=torch.bfloat16,
                          device=dev)
        blocks.append((hw, stride, cin, ce, cout, expand, residual, x, ws,
                       M.pack_mbconv(*ws[:5]), out))
    scratch = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)

    def time_ms(fn, iters=8):
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            scratch.zero_()
            torch.cuda._sleep(1_000_000)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / iters

    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, (so, _) in procs.items():
        lib = ctypes.CDLL(so)
        times = []
        for hw, stride, cin, ce, cout, expand, residual, x, ws, pk, out in blocks:
            st = vp(torch.cuda.current_stream().cuda_stream)
            if name.startswith("old"):
                ptrs = [vp(0 if t is None else t.data_ptr()) for t in (x, *ws, out)]
                ints = [ci(v) for v in (128, hw, hw, cin, ce, cout, stride, int(expand),
                                        int(residual), 1)]
                fn = lambda: lib.yrt_mbconv(*ptrs, *ints, st)  # noqa: E731
            else:
                pl = M.plan_tile(hw // stride, hw // stride, stride, cin, ce, cout, expand, 128)
                ptrs = [vp(t.data_ptr()) for t in (x, pk.w, ws[5], out)]
                ints = [ci(v) for v in (128, hw, hw, cin, ce, cout, pk.nchunks, stride,
                                        int(expand), int(residual), pl.th, pl.tw, pl.nc, pl.xst,
                                        pl.wst, pl.grid, pl.smem)]
                fn = lambda: lib.yrt_mbconv_bf16(*ptrs, *ints, st)  # noqa: E731
            rc = fn()
            torch.cuda.synchronize()
            if rc != 0:
                raise RuntimeError(f"{name}: launch failed with CUDA error {rc}")
            times.append(time_ms(fn))
        print(f"{name:46s} 16 blocks {sum(times):.4f} ms | "
              + " ".join(f"{t:.4f}" for t in times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
