"""Command line of the port, with the JAX package's flags
(``yoloret_tpu/cli/main.py``) for the one mode ported so far, MAP:

    python -m yoloret_tpu_torch.cli.main --mode=MAP --model=weights.pt \
        --test_dataset='voc_test_*.txt' --classes_path=voc_classes.txt \
        --anchors_path=yolo_anchors.txt [--exact_nms] [--no-bf16] [--device=cuda]

``--model`` is a port state dict (``torch.save(model.state_dict())``;
without it the weights are a seeded init). ``--config`` overlays a YAML
file onto the flags. ``--exact_nms`` takes per-class pools of the whole
grid, the reference's exact NMS. ``--device`` (default ``cuda``) is the
port's own; ``--device=cpu`` runs every kernel's plain version.
``--backbone`` takes every name of the detector registry and ``--rfcr``
every fusion; the shipped configs run as they are, e.g.

    python -m yoloret_tpu_torch.cli.main --config=configs/coco_efficientnetb3_416.yaml \
        --mode=MAP --test_dataset='coco_val_*.txt' --exact_nms

The other modes, ``--int8``, ``--use_ema`` and ``--mesh_data`` above 1
stop with a message that names their place in ROADMAP.md.
"""

from __future__ import annotations

import argparse
import sys

from yoloret_tpu_torch.configs import RunConfig, load_config
from yoloret_tpu_torch.nn.detector import BACKBONES

# What each mode that is not ported waits for (ROADMAP.md, queue 1).
NOT_PORTED = {
    "TRAIN": "training, item 4",
    "TRAIN_BACKBONE": "training, item 4",
    "IMAGE": "the other CLI modes, item 7",
    "VIDEO": "the other CLI modes, item 7",
    "ANCHORS": "the other CLI modes, item 7",
    "EXPORT": "side paths, item 5",
    "TFLITE": "side paths, item 5",
    "SERVING": "side paths, item 5",
    "TFJS": "side paths, item 5",
    "PRUNE": "the other CLI modes, item 7",
}


def _parse_size(v: str):
    if "," in v:
        h, w = v.split(",")
        return (int(h), int(w))
    return (int(v), int(v))


def build_parser() -> argparse.ArgumentParser:
    # argument_default=SUPPRESS: an attribute exists only when the flag was
    # passed, so explicit flags override YAML config values
    p = argparse.ArgumentParser(prog="python -m yoloret_tpu_torch.cli.main", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter,
                                argument_default=argparse.SUPPRESS)
    d = RunConfig()
    p.add_argument("--mode", type=str, default="IMAGE",
                   help="MAP (the others are not ported yet)")
    p.add_argument("--config", type=str, default=None, help="YAML config overlay")
    p.add_argument("--backbone", type=str,
                   help=f"default {d.backbone}; any of {', '.join(sorted(BACKBONES))}")
    p.add_argument("--input_size", type=_parse_size,
                   help="single int or 'h,w', multiples of 32")
    p.add_argument("--model", type=str, help="port state dict (torch.save)")
    p.add_argument("--test_dataset", type=str, help="glob of text lists and .tfrecord shards")
    p.add_argument("--classes_path", type=str)
    p.add_argument("--anchors_path", type=str)
    p.add_argument("--batch_size", type=int)
    p.add_argument("--nms_iou", type=float)
    p.add_argument("--exact_nms", action="store_true",
                   help="MAP: reference-exact full-grid per-class NMS (slower)")
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--rfcr", type=str, choices=["weighted_sum", "concat", "none"])
    p.add_argument("--mesh_data", type=int)
    p.add_argument("--int8", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (every kernel's plain version)")
    return p


def args_to_config(args) -> RunConfig:
    cfg = RunConfig()
    if getattr(args, "config", None):
        cfg = load_config(args.config, cfg)
    overrides = {f: getattr(args, f) for f in (
        "backbone input_size model test_dataset classes_path anchors_path batch_size nms_iou "
        "exact_nms bf16 use_ema rfcr mesh_data int8").split() if hasattr(args, f)}
    return cfg.replace(**overrides)


def _refuse(what: str) -> int:
    print(f"{what} (see ROADMAP.md, queue 1)", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    mode = args.mode.upper()
    cfg = args_to_config(args)
    if mode != "MAP":
        if mode in NOT_PORTED:
            return _refuse(f"--mode={mode} is not ported to yoloret_tpu_torch yet: it waits for "
                           f"{NOT_PORTED[mode]}")
        return _refuse(f"unknown mode {args.mode!r}")
    if cfg.int8:
        return _refuse("--int8: the W8A8 backbone is not ported yet: it waits for side paths, "
                       "item 5")
    if cfg.mesh_data and cfg.mesh_data > 1:
        return _refuse("--mesh_data above 1: data-parallel evaluation is not ported yet: it "
                       "waits for parallelism, item 6")
    if cfg.use_ema:
        return _refuse("--use_ema: a port state dict holds one set of weights; convert the EMA "
                       "weights with weights.from_flax instead")
    if not (cfg.test_dataset and cfg.classes_path and cfg.anchors_path):
        print("MAP needs --test_dataset, --classes_path and --anchors_path", file=sys.stderr)
        return 2

    from yoloret_tpu_torch.data import Dataset, DatasetMode, load_anchors, load_classes
    from yoloret_tpu_torch.eval import evaluate_map
    from yoloret_tpu_torch.infer import Predictor

    class_names = load_classes(cfg.classes_path)
    anchors = load_anchors(cfg.anchors_path)
    pred = Predictor(
        backbone=cfg.backbone, weights=cfg.model, class_names=class_names, anchors=anchors,
        input_hw=cfg.input_size, bf16=cfg.bf16, rfcr=cfg.rfcr,
        score_threshold=0.0,  # the reference sets score=0 for MAP, main.py:172
        device=args.device,
    )
    ds = Dataset(cfg.test_dataset, batch_size=max(cfg.batch_size, 1), input_hw=cfg.input_size,
                 mode=DatasetMode.TEST, device=args.device)
    kw = {}
    if cfg.exact_nms:
        h, w = cfg.input_size
        kw = dict(pool="per_class",
                  num_candidates=sum((h // s) * (w // s) * 3 for s in (32, 16, 8)))
    evaluate_map(pred, ds, class_names, nms_iou=cfg.nms_iou, **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
