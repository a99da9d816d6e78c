"""Ablation study for the paper's two scientific contributions. Port of
``yoloret_tpu/tools/ablation.py``.

YOLO-ReT's claims (reference: paper + code/yolo3/model.py):
  1. RFCR -- the learned WeightedSum collect/redistribute fusion
     (model.py:117-168) beats both a plain concat fusion (the legacy
     scarf proto-RFCR, model_computations.py:229-319) and no fusion at
     all (backbone taps straight to the neck).
  2. Truncated transfer learning (model.py:219-224) -- stage-1 training
     with a frozen imported backbone, then unfreezing, beats training
     the same architecture from random init.

The reference ships no ablation harness; its evidence is the paper's
VOC/COCO tables, which need ImageNet weights and real datasets. This
module measures the same two effects on the calibrated crowded-synthetic
recipe (``tools/topk_study.py::crowded_train_cfg``, the accuracy gate's
partial-convergence recipe), evaluating both the train-set fit and a
held-out set drawn from the same generator. Every job trains and
evaluates in float32 on deterministic kernels (``device.reproducible``),
so a job's numbers depend on its seed and the code, not on the run.

For the transfer ablation the "imported" backbone is a surrogate: a
detector pretrained on a LARGER disjoint synthetic set (seed 7), whose
backbone (``body.*``) is grafted into a fresh init -- the mechanism of
``utils/keras_import.py`` with an in-environment source of pretrained
values. The target task is low-data (16 images) so transfer has
something to do. Both arms get the same target-task step budget (stage
1 30 + stage 2 60 epochs vs 90 unfrozen).

Usage (the battery: every job in a subprocess of its own, resumable
through ``results.jsonl``; ``--root`` defaults to ``yoloret_ablation`` in
the temporary directory, ``$TMPDIR``):

    python -m yoloret_tpu_torch.tools.ablation --root abl_r4 --seeds 0 1 [--device cuda]
    python -m yoloret_tpu_torch.tools.ablation --root abl_r5 --battery r5 --seeds 0 1 2 3 4

Single job (what the battery spawns):

    python -m yoloret_tpu_torch.tools.ablation --job rfcr --fusion concat \\
        --seed 0 --workdir abl_r4/rfcr-concat-s0 [--device cuda]

A job prints its record as an ``ABLATION_RESULT {json}`` line, then the
kernel launches of its evaluations as ``ABLATION_LAUNCHES {json}``.
Results land in ``<root>/results.jsonl``; the battery prints a markdown
table at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

FUSIONS = ("weighted_sum", "concat", "none")
BACKBONE = "mobilenetv2x75"
SIZE = 160
BATCH = 8
# The recipe: epochs of the gate recipe's jobs (rfcr, rfcr_sd, pretrain);
# the transfer arms' batch and schedules (16 images at batch 4 = 4 steps
# an epoch, so both arms take the gate recipe's 360 steps); the sets' sizes.
EPOCHS = 60
TRANSFER_BATCH = 4
TRANSFER_EPOCHS = (30, 60)  # stage 1 frozen, stage 2 unfrozen
RANDOM_EPOCHS = 90
N_TRAIN, N_HELDOUT, N_SMALL, N_PRETRAIN = 48, 32, 16, 96


# ---------------------------------------------------------------- data


# Scale-diverse bands (px at 160x160 input), chosen so best-shape-IoU
# anchor matching (ops/targets.py, reference model.py:237-247) assigns
# each band to a DIFFERENT detection scale under the COCO anchor ladder:
#   small  12-26  -> anchors {10,13 / 16,30 / 33,23}   -> /8  head
#   medium 40-72  -> anchors {30,61 / 62,45 / 59,119}  -> /16 head
#   large  96-144 -> anchors {116,90 / 156,198}        -> /32 head
# The crowded recipe (uniform 18-48 px) puts nearly everything on the /8
# and /16 heads, where RFCR's cross-scale redistribution has little to
# do. This generator gives every scale real ownership.
SD_BANDS = (("large", 96, 145, 1), ("medium", 40, 73, 2),
            ("small", 12, 27, 3))


def build_scalediverse(root: str, n: int = 48, hw=(160, 160), seed: int = 0):
    """Scale-diverse scenes: per image 1 large + 2 medium + 3 small
    rectangles of the 4 color classes, drawn large->small so the small
    ones stay visible. Class is resampled when a box would be invisible
    against the same-color region it covers."""
    import numpy as np
    from PIL import Image

    from yoloret_tpu_torch.tools.topk_study import CLASS_COLORS, CLASS_NAMES

    rng = np.random.RandomState(seed)
    h, w = hw
    lines = []
    for i in range(n):
        arr = np.full((h, w, 3), 24, np.uint8)
        boxes = []
        for _band, lo, hi, count in SD_BANDS:
            for _ in range(count):
                bw = int(rng.randint(lo, hi))
                bh = int(rng.randint(lo, hi))
                x = int(rng.randint(0, w - bw))
                y = int(rng.randint(0, h - bh))
                c = int(rng.randint(0, len(CLASS_COLORS)))
                under = arr[y + bh // 2, x + bw // 2]
                if tuple(under) == CLASS_COLORS[c]:
                    c = (c + 1) % len(CLASS_COLORS)
                arr[y : y + bh, x : x + bw] = CLASS_COLORS[c]
                boxes.append((x, y, x + bw, y + bh, c))
        p = os.path.join(root, f"sd{i}.jpg")
        Image.fromarray(arr).save(p, quality=95)
        lines.append(
            p + " " + " ".join(",".join(map(str, b)) for b in boxes)
        )
    ann = os.path.join(root, f"sd_train_{n}.txt")
    with open(ann, "w") as f:
        f.write("\n".join(lines) + "\n")
    classes = os.path.join(root, "classes.txt")
    with open(classes, "w") as f:
        f.write("\n".join(CLASS_NAMES) + "\n")
    anchors = os.path.join(root, "anchors.txt")
    with open(anchors, "w") as f:
        f.write("10,13, 16,30, 33,23, 30,61, 62,45, 59,119, "
                "116,90, 156,198, 373,326\n")
    return ann, classes, anchors


def _two_sets(workdir: str, build, train_name: str, held_name: str, n_train: int):
    """A train set (``n_train`` images, seed 0) and the held-out set
    (N_HELDOUT images, seed 3) of one generator: same distribution,
    disjoint draws."""
    train_dir = os.path.join(workdir, train_name)
    held_dir = os.path.join(workdir, held_name)
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(held_dir, exist_ok=True)
    ann, classes, anchors = build(train_dir, n=n_train, seed=0)
    held_ann, _, _ = build(held_dir, n=N_HELDOUT, seed=3)
    return ann, held_ann, classes, anchors


def _sd_datasets(workdir: str):
    """Scale-diverse train (48 img, seed 0) + held-out (32 img, seed 3)."""
    return _two_sets(workdir, build_scalediverse, "sddata", "sdheldout", N_TRAIN)


def _datasets(workdir: str):
    """Shared train (48 img, seed 0) + held-out (32 img, seed 3) sets --
    same generator and distribution, disjoint draws."""
    from yoloret_tpu_torch.tools.topk_study import build_crowded

    return _two_sets(workdir, build_crowded, "data", "heldout", N_TRAIN)


def _small_datasets(workdir: str):
    """Low-data target task for the transfer ablation: 16 train images
    (transfer only matters when the target task is data-poor)."""
    from yoloret_tpu_torch.tools.topk_study import build_crowded

    return _two_sets(workdir, build_crowded, "data16", "heldout", N_SMALL)


def _eval_map(weights: str, ann: str, anchors_path: str, fusion: str = "weighted_sum",
              device="cuda", use_ema: bool = False) -> float:
    """MAP-grade (threshold 0) float32 mAP of ``weights`` over ``ann``."""
    from yoloret_tpu_torch.data import Dataset, DatasetMode, load_anchors
    from yoloret_tpu_torch.eval import evaluate_map
    from yoloret_tpu_torch.infer import Predictor
    from yoloret_tpu_torch.tools.topk_study import CLASS_NAMES

    pred = Predictor(
        backbone=BACKBONE, weights=weights, class_names=CLASS_NAMES,
        anchors=load_anchors(anchors_path), input_hw=(SIZE, SIZE), score_threshold=0.0,
        bf16=False, rfcr=fusion, use_ema=use_ema, device=device,
    )
    ds = Dataset(ann, batch_size=BATCH, input_hw=(SIZE, SIZE), mode=DatasetMode.TEST,
                 max_boxes=12, device=pred.device)
    mAP, _ = evaluate_map(pred, ds, CLASS_NAMES, verbose=False)
    return round(float(mAP), 6)


def _recipe(workdir: str, ann: str, classes: str, anchors: str, batch: int = BATCH):
    from yoloret_tpu_torch.tools.topk_study import crowded_train_cfg

    return crowded_train_cfg(workdir, ann, classes, anchors, epochs=EPOCHS, size=SIZE,
                             batch=batch)


# ---------------------------------------------------------------- jobs


def _fusion_job(workdir: str, fusion: str, seed: int, datasets, device) -> dict:
    from yoloret_tpu_torch.device import reproducible
    from yoloret_tpu_torch.train.trainer import train

    ann, held_ann, classes, anchors = datasets(workdir)
    cfg = _recipe(workdir, ann, classes, anchors).replace(rfcr=fusion, seed=seed)
    with reproducible(device):
        weights = train(cfg, device=device)
        return {
            "train_mAP": _eval_map(weights, ann, anchors, fusion, device),
            "heldout_mAP": _eval_map(weights, held_ann, anchors, fusion, device),
            "weights": weights,
        }


def job_rfcr(workdir: str, fusion: str, seed: int, device="cuda") -> dict:
    """One RFCR-fusion arm on the standard gate recipe (48 img, 60 ep)."""
    return _fusion_job(workdir, fusion, seed, _datasets, device)


def job_rfcr_sd(workdir: str, fusion: str, seed: int, device="cuda") -> dict:
    """One RFCR-fusion arm on the SCALE-DIVERSE recipe (48 img, 60 ep):
    objects own all three detection scales, so cross-scale
    redistribution (reference model.py:117-168) has measurable work to
    do."""
    return _fusion_job(workdir, fusion, seed, _sd_datasets, device)


def job_ema(workdir: str, seed: int, decay: float = 0.9999, epochs: int = 60,
            device="cuda") -> dict:
    """Gate recipe with --use_ema: measures what evaluating the EMA copy
    buys over the raw params (the reference maintains the average but
    never consumes it, code/yolo3/train.py:42-45). ``decay`` sizes the
    averaging horizon: the reference's 0.9999 (~10k-step horizon) can
    never warm up on the 360-step gate recipe; a schedule-matched decay
    (horizon ~ last third of training) is the fair test of whether the
    average HELPS.

    CAVEAT: the num_updates warm-up ramp min(decay, (1+t)/(10+t))
    dominates any decay >= (1+T)/(10+T) for a T-step run -- on the
    360-step recipe that is every decay >= 0.976, so d=0.99 gives the
    d=0.9999 run exactly. Decays must sit below the ramp's end value (or
    ``epochs`` must stretch the schedule) to measure anything new."""
    from yoloret_tpu_torch.device import reproducible
    from yoloret_tpu_torch.tools.topk_study import crowded_train_cfg
    from yoloret_tpu_torch.train.trainer import train

    ann, held_ann, classes, anchors = _datasets(workdir)
    cfg = crowded_train_cfg(workdir, ann, classes, anchors, epochs=epochs, size=SIZE,
                            batch=BATCH)
    cfg = cfg.replace(use_ema=True, ema_decay=decay, seed=seed)
    out = {}
    with reproducible(device):
        out["weights"] = train(cfg, device=device)
        for name, use_ema in (("raw", False), ("ema", True)):
            for tag, a in (("train", ann), ("heldout", held_ann)):
                out[f"{name}_{tag}_mAP"] = _eval_map(out["weights"], a, anchors, device=device,
                                                     use_ema=use_ema)
    return out


def job_pretrain(workdir: str, seed: int = 7, device="cuda") -> dict:
    """Surrogate 'ImageNet' source: a detector trained on a larger
    disjoint synthetic set; only its backbone is transferred."""
    from yoloret_tpu_torch.device import reproducible
    from yoloret_tpu_torch.tools.topk_study import build_crowded
    from yoloret_tpu_torch.train.trainer import train

    pre_dir = os.path.join(workdir, "pretrain_data")
    os.makedirs(pre_dir, exist_ok=True)
    ann, classes, anchors = build_crowded(pre_dir, n=N_PRETRAIN, seed=seed)
    cfg = _recipe(workdir, ann, classes, anchors).replace(seed=seed)
    with reproducible(device):
        weights = train(cfg, device=device)
        return {"weights": weights, "train_mAP": _eval_map(weights, ann, anchors, device=device)}


def _graft_backbone(pretrained: str, seed: int, out_path: str) -> str:
    """Fresh init with ONLY the backbone (``body.*``: parameters and
    BatchNorm statistics) replaced by the pretrained values -- the
    truncated-transfer import mechanism (reference model.py:219-224 loads
    backbone weights by name); heads, RFCR and neck stay random. The
    fresh init is the one the trainer starts from at ``seed``, so the
    transfer and random arms differ in ``body.*`` alone. ``pretrained``
    is a port weight file or a JAX weight directory
    (``utils.checkpoint.load_params``)."""
    import torch

    from yoloret_tpu_torch.nn.detector import YoloReT
    from yoloret_tpu_torch.nn.layers import init_weights
    from yoloret_tpu_torch.tools.topk_study import CLASS_NAMES
    from yoloret_tpu_torch.utils.checkpoint import load_params, save_params

    model = YoloReT(BACKBONE, num_classes=len(CLASS_NAMES))
    init_weights(model, torch.Generator().manual_seed(seed))
    src = load_params(pretrained)
    state = {k: src[k] if k.startswith("body.") else v for k, v in model.state_dict().items()}
    save_params(out_path, state)
    return out_path


def job_transfer(workdir: str, arm: str, seed: int, pretrained: str, device="cuda") -> dict:
    """One transfer arm on the low-data target task, equal STEP budget:
      transfer: graft pretrained backbone -> stage1 frozen 30 ep ->
                stage2 unfrozen 60 ep (the reference's two-stage recipe,
                code/train.py:153-216)
      random:   random init, unfrozen, 90 ep
    Batch is 4 (not the gate's 8): 16 images at batch 8 is 2 steps/epoch
    -- 1/3 of the gate recipe's 360-step budget at equal epochs, which
    measured as pure underfitting in the JAX package (both arms mAP 0.0).
    Batch 4 gives 4 steps/epoch, so the 90-epoch budget is 360 steps --
    step-equal to the gate recipe AND between arms."""
    from yoloret_tpu_torch.device import reproducible
    from yoloret_tpu_torch.train.trainer import train

    ann, held_ann, classes, anchors = _small_datasets(workdir)
    base = _recipe(workdir, ann, classes, anchors, batch=TRANSFER_BATCH)
    with reproducible(device):
        if arm == "transfer":
            graft = _graft_backbone(pretrained, seed, os.path.join(workdir, "grafted_init.pt"))
            cfg1 = base.replace(freeze=True, model=graft, epochs=TRANSFER_EPOCHS, seed=seed)
            stage1 = train(cfg1, device=device)
            cfg2 = base.replace(freeze=False, train_unfreeze=stage1, epochs=TRANSFER_EPOCHS,
                                seed=seed)
            weights = train(cfg2, device=device)
        elif arm == "random":
            cfg = base.replace(freeze=False, epochs=(RANDOM_EPOCHS, RANDOM_EPOCHS), seed=seed)
            weights = train(cfg, device=device)
        else:
            raise ValueError(f"unknown arm {arm!r}")
        return {
            "train_mAP": _eval_map(weights, ann, anchors, device=device),
            "heldout_mAP": _eval_map(weights, held_ann, anchors, device=device),
            "weights": weights,
        }


# ----------------------------------------------------------- job runner


def _job_env() -> dict:
    """The job's environment: this one, with the port's checkout on the
    import path, so that a job starts from any working directory. The
    numerics are pinned inside the job (``device.reproducible``)."""
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    return env


def _job_output(root: str, job_id: str, extra_args: list) -> str:
    """Runs one job in a subprocess of its own, in ``<root>/<job_id>``;
    its standard output. Raises when the job fails."""
    workdir = os.path.join(root, job_id)
    os.makedirs(workdir, exist_ok=True)
    cmd = [sys.executable, "-m", "yoloret_tpu_torch.tools.ablation",
           "--workdir", workdir] + extra_args
    print(f"[ablation] {job_id}: {' '.join(cmd)}", flush=True)
    proc = subprocess.run(cmd, env=_job_env(), capture_output=True,
                          text=True, timeout=3 * 3600)
    if proc.returncode != 0:
        raise RuntimeError(f"job {job_id} failed:\n"
                           f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    return proc.stdout


def tagged(stdout: str, tag: str):
    """The JSON of the last ``<tag> {json}`` line of a job's output, else
    None (tags: ``ABLATION_RESULT``, ``ABLATION_LAUNCHES``)."""
    lines = [l for l in stdout.splitlines() if l.startswith(tag + " ")]
    return json.loads(lines[-1][len(tag) + 1:]) if lines else None


def _run_job(root: str, job_id: str, extra_args: list) -> dict:
    stdout = _job_output(root, job_id, extra_args)
    res = tagged(stdout, "ABLATION_RESULT")
    if res is None:
        raise RuntimeError(f"job {job_id} printed no result:\n{stdout[-2000:]}")
    return res


def load_results(root: str) -> dict:
    path = os.path.join(root, "results.jsonl")
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                if line.strip():
                    rec = json.loads(line)
                    out[rec["id"]] = rec
    return out


def _record(root: str, rec: dict) -> None:
    with open(os.path.join(root, "results.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")


def _needer(root: str, device: str):
    """(the records done so far, need(job_id, args)): a job's record,
    from ``results.jsonl`` when it ran before, else from a run of the job
    on ``device``, recorded."""
    os.makedirs(root, exist_ok=True)
    done = load_results(root)

    def need(job_id: str, args: list) -> dict:
        if job_id in done:
            print(f"[ablation] {job_id}: cached", flush=True)
            return done[job_id]
        res = _run_job(root, job_id, args + ["--device", device])
        rec = {"id": job_id, **res}
        _record(root, rec)
        done[job_id] = rec
        print(f"[ablation] {job_id}: {res}", flush=True)
        return rec

    return done, need


def drive(root: str, seeds: list, device: str = "cuda") -> dict:
    done, need = _needer(root, device)
    # (a) RFCR fusion ablation
    for seed in seeds:
        for fusion in FUSIONS:
            need(f"rfcr-{fusion}-s{seed}",
                 ["--job", "rfcr", "--fusion", fusion, "--seed", str(seed)])
    # EMA consumption: one seed is enough for the headline number
    need("ema-s0", ["--job", "ema", "--seed", "0"])
    # (b) truncated transfer vs random init
    pre = need("pretrain-s7", ["--job", "pretrain", "--seed", "7"])
    for seed in seeds:
        for arm in ("transfer", "random"):
            need(f"transfer-{arm}-s{seed}",
                 ["--job", "transfer", "--arm", arm, "--seed", str(seed),
                  "--pretrained", pre["weights"]])

    print(render_table(done, seeds))
    return done


def drive_r5(root: str, seeds: list, device: str = "cuda") -> dict:
    """The second battery, ordered so PAIRS complete early (a lone arm is
    useless): scale-diverse fusion-vs-none pairs for the first two
    seeds, then the truncated-transfer replication on a NEW pretrain
    source (generator seed 11; the first battery's is seed 7), then the
    schedule-matched EMA, then the remaining fusion seeds."""
    done, need = _needer(root, device)

    def sd_pair(seed: int):
        for fusion in ("weighted_sum", "none"):
            need(f"rfcrsd-{fusion}-s{seed}",
                 ["--job", "rfcr_sd", "--fusion", fusion,
                  "--seed", str(seed)])

    for seed in seeds[:2]:
        sd_pair(seed)
    # truncated-transfer replication: new surrogate source, seeds {0,1}
    pre = need("pretrain-s11", ["--job", "pretrain", "--seed", "11"])
    for seed in (0, 1):
        for arm in ("transfer", "random"):
            need(f"transfer11-{arm}-s{seed}",
                 ["--job", "transfer", "--arm", arm, "--seed", str(seed),
                  "--pretrained", pre["weights"]])
    # schedule-matched EMA (horizon ~100 steps on the 360-step recipe)
    need("ema-d99-s0", ["--job", "ema", "--seed", "0", "--decay", "0.99"])
    for seed in seeds[2:]:
        sd_pair(seed)

    print(render_table_r5(done, seeds))
    return done


def _arm_rows(done: dict, arms, id_of, seeds) -> list:
    """Markdown rows: each arm's mean train and held-out mAP over the
    seeds it has a record for, and the values per seed."""
    import numpy as np

    lines = []
    for arm in arms:
        recs = [done[id_of(arm, s)] for s in seeds if id_of(arm, s) in done]
        tr = [r["train_mAP"] for r in recs]
        he = [r["heldout_mAP"] for r in recs]
        if tr:
            lines.append(
                f"| {arm} | {np.mean(tr):.4f} ({', '.join(f'{v:.4f}' for v in tr)}) "
                f"| {np.mean(he):.4f} ({', '.join(f'{v:.4f}' for v in he)}) |")
    return lines


def _ema_rows(e: dict) -> list:
    return ["| weights | train mAP | held-out mAP |", "|---|---|---|",
            f"| raw | {e['raw_train_mAP']:.4f} | {e['raw_heldout_mAP']:.4f} |",
            f"| EMA | {e['ema_train_mAP']:.4f} | {e['ema_heldout_mAP']:.4f} |"]


def _header(first: str) -> list:
    return [f"| {first} | train mAP (per seed) | held-out mAP (per seed) |", "|---|---|---|"]


def render_table_r5(done: dict, seeds: list) -> str:
    import numpy as np

    lines = ["", "## RFCR fusion vs none (SCALE-DIVERSE synthetic, "
             "48 img, 60 ep)", ""] + _header("fusion")
    lines += _arm_rows(done, ("weighted_sum", "none"), lambda f, s: f"rfcrsd-{f}-s{s}", seeds)
    pairs = [(done[f"rfcrsd-weighted_sum-s{s}"]["heldout_mAP"],
              done[f"rfcrsd-none-s{s}"]["heldout_mAP"])
             for s in seeds
             if f"rfcrsd-weighted_sum-s{s}" in done
             and f"rfcrsd-none-s{s}" in done]
    if pairs:
        deltas = [w - n for w, n in pairs]
        lines.append(
            f"\npaired held-out deltas (weighted_sum - none): "
            f"{', '.join(f'{d:+.4f}' for d in deltas)} "
            f"(mean {np.mean(deltas):+.4f}, "
            f"{sum(d > 0 for d in deltas)}/{len(deltas)} positive)")
    lines += ["", "## Truncated transfer, NEW pretrain source (seed-11 "
              "surrogate; 16-img target, equal 360-step budget)", ""] + _header("arm")
    lines += _arm_rows(done, ("transfer", "random"), lambda a, s: f"transfer11-{a}-s{s}", (0, 1))
    if "ema-d99-s0" in done:
        lines += ["", "## EMA, schedule-matched decay 0.99 (gate recipe, "
                  "seed 0)", ""] + _ema_rows(done["ema-d99-s0"])
    return "\n".join(lines)


def render_table(done: dict, seeds: list) -> str:
    lines = ["", "## RFCR fusion ablation (48-img crowded synthetic, 60 ep)", ""]
    lines += _header("fusion")
    lines += _arm_rows(done, FUSIONS, lambda f, s: f"rfcr-{f}-s{s}", seeds)
    if "ema-s0" in done:
        lines += ["", "## EMA consumption (gate recipe, --use_ema, seed 0)", ""]
        lines += _ema_rows(done["ema-s0"])
    lines += ["", "## Truncated transfer vs random init (16-img target, "
              "equal 90-ep budget)", ""] + _header("arm")
    lines += _arm_rows(done, ("transfer", "random"), lambda a, s: f"transfer-{a}-s{s}", seeds)
    return "\n".join(lines)


def _launches() -> dict:
    """This process's kernel launches so far, as the wrappers count them:
    MBConv by kernel, NMS by variant (none on the CPU)."""
    from yoloret_tpu_torch.ops.mbconv import fused_mbconv
    from yoloret_tpu_torch.ops.nms_kernel import suppress

    return {"mbconv": dict(fused_mbconv.kernel_launches),
            "nms": dict(suppress.variant_launches)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--job", choices=["rfcr", "rfcr_sd", "ema", "pretrain",
                                     "transfer"],
                   default=None, help="run one job in-process (the battery "
                   "when omitted)")
    p.add_argument("--workdir", default=None)
    p.add_argument("--fusion", choices=list(FUSIONS), default="weighted_sum")
    p.add_argument("--arm", choices=["transfer", "random"], default="transfer")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--decay", type=float, default=0.9999)
    p.add_argument("--epochs", type=int, default=60,
                   help="ema job only: schedule length (the decay must "
                   "sit below the warm-up ramp's end value to differ "
                   "from the default run -- see job_ema)")
    p.add_argument("--pretrained", default=None)
    p.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                  "yoloret_ablation"),
                   help="the battery's job directories and results.jsonl, "
                   "its resume cache (default: yoloret_ablation in $TMPDIR)")
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    p.add_argument("--battery", choices=["r4", "r5"], default="r4",
                   help="which battery's job graph to run (no --job)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)

    if a.job is None:
        (drive_r5 if a.battery == "r5" else drive)(a.root, a.seeds, a.device)
        return
    assert a.workdir, "--workdir required for a single job"
    if a.job == "rfcr":
        res = job_rfcr(a.workdir, a.fusion, a.seed, a.device)
    elif a.job == "rfcr_sd":
        res = job_rfcr_sd(a.workdir, a.fusion, a.seed, a.device)
    elif a.job == "ema":
        res = job_ema(a.workdir, a.seed, a.decay, a.epochs, a.device)
    elif a.job == "pretrain":
        res = job_pretrain(a.workdir, a.seed, a.device)
    else:
        assert a.pretrained, "--pretrained required for transfer jobs"
        res = job_transfer(a.workdir, a.arm, a.seed, a.pretrained, a.device)
    print("ABLATION_RESULT " + json.dumps(res), flush=True)
    print("ABLATION_LAUNCHES " + json.dumps(_launches()), flush=True)


if __name__ == "__main__":
    main()
