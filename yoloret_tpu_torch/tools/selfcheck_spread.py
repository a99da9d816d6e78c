"""The self-check's float32 mAP over training seeds.

    python -m yoloret_tpu_torch.tools.selfcheck_spread [--seeds 0-7] [--procs 4] \
        [--epochs 150] [--device cuda]

``tools/selfcheck.py`` trains at seed 0, as the JAX package's does: one
draw. This runs its recipe (the same data, the same numerics:
``device.reproducible``) once per seed, where the seed draws the
weights' init and the training stream, ``--procs`` processes at a time.
On one card the processes share it; deterministic kernels make each
run's result independent of the others. Prints the card's name and
power limit (on ``cuda``), one ``SPREAD {"seed": s, "map": m,
"seconds": t}`` line per seed, then ``SPREAD_SUMMARY`` with the min,
median and max and how many seeds reach the threshold. Nothing is
written to the repository.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

THRESHOLD = 0.8  # the self-check's

def parse_seeds(text: str) -> list:
    """``"0-7"`` or ``"0,3,5"`` -> the seeds."""
    if "-" in text:
        lo, hi = map(int, text.split("-"))
        return list(range(lo, hi + 1))
    return [int(s) for s in text.split(",")]


def one_seed(seed: int, epochs: int, size: int, device) -> dict:
    """The self-check at ``seed``: its float32 mAP and its seconds."""
    from yoloret_tpu_torch.tools import selfcheck

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="yoloret_spread_") as workdir:
        mAP, _ = selfcheck.run(epochs, size, workdir=workdir, device=device, seed=seed)
    return dict(seed=seed, map=mAP, seconds=time.perf_counter() - t0)


def spread(seeds, procs: int, epochs: int, size: int, device) -> list:
    """``one_seed`` of each seed, each in a process of its own, ``procs``
    at a time: their results in seed order. Raises when a run fails."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // procs)),
               PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    pending, running, results = list(seeds), [], {}
    while pending or running:
        while pending and len(running) < procs:
            s = pending.pop(0)
            argv = [sys.executable, "-m", "yoloret_tpu_torch.tools.selfcheck_spread",
                    "--seeds", str(s), "--epochs", str(epochs), "--size", str(size),
                    "--device", str(device)]
            log = tempfile.TemporaryFile("w+")
            running.append((s, subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT,
                                                 env=env, text=True), log))
        time.sleep(1.0)
        for item in [r for r in running if r[1].poll() is not None]:
            s, proc, log = item
            running.remove(item)
            log.seek(0)
            out = log.read()
            log.close()
            lines = [ln for ln in out.splitlines() if ln.startswith("SPREAD ")]
            if proc.returncode != 0 or len(lines) != 1:
                for _, p, lg in running:
                    p.kill()
                    p.wait()
                    lg.close()
                raise RuntimeError(f"seed {s}: exit {proc.returncode}\n{out[-4000:]}")
            results[s] = json.loads(lines[0][len("SPREAD "):])
            print(lines[0], flush=True)
    return [results[s] for s in seeds]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", default="0-7")
    p.add_argument("--procs", type=int, default=4)
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--size", type=int, default=96)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    seeds = parse_seeds(a.seeds)
    if len(seeds) == 1:
        r = one_seed(seeds[0], a.epochs, a.size, a.device)
        print("SPREAD " + json.dumps(r), flush=True)
        return
    if a.device != "cpu":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip(), flush=True)
    maps = np.array([r["map"] for r in spread(seeds, a.procs, a.epochs, a.size, a.device)])
    print("SPREAD_SUMMARY " + json.dumps(dict(
        seeds=seeds, min=float(maps.min()), median=float(np.median(maps)),
        max=float(maps.max()), mean=float(maps.mean()), std=float(maps.std(ddof=1)),
        reach_threshold=int((maps >= THRESHOLD).sum()), threshold=THRESHOLD)), flush=True)


if __name__ == "__main__":
    main()
