"""Command line of the port, with the JAX package's flags
(``yoloret_tpu/cli/main.py``) and modes: IMAGE (the default), VIDEO,
TRAIN, MAP, ANCHORS, EXPORT, TFLITE, SERVING, TFJS and PRUNE.

Detection on one image, written with its boxes drawn (the default image
is the port's ``assets/demo.jpg``, the default output ``demo_out.png``):

    python -m yoloret_tpu_torch.cli.main --mode=IMAGE --image=photo.jpg \
        --classes_path=voc_classes.txt --anchors_path=yolo_anchors.txt \
        [--model=weights.pt] [--score=0.3] [--output=out.png]

Training runs two stages, the second from the first's weight file:

    python -m yoloret_tpu_torch.cli.main --mode=TRAIN \
        --config=configs/voc_mobilenetv2x75_320.yaml --train_dataset='voc_train_*.txt' \
        --val_dataset='voc_val_*.txt' --test_dataset='voc_test_*.txt' \
        --classes_path=voc_classes.txt --anchors_path=yolo_anchors.txt --epochs 100 150
    python -m yoloret_tpu_torch.cli.main --mode=TRAIN ... \
        --train_unfreeze=logs/mobilenetv2x75_stage1/mobilenetv2x75_trained_weights_stage_1.pt

and writes ``logs/<backbone>_stage{1,2}/`` (``metrics.jsonl``,
TensorBoard scalars, checkpoints, the stage-end weight file). The
training options ``--autoaugment_policy v0``, ``--mosaic 0.5``,
``--mixup 0.5``, ``--multi_scale 288 320 352`` and ``--tb_images 4``
(TensorBoard images of the augmented inputs with detections) take the
JAX package's meaning. mAP:

    python -m yoloret_tpu_torch.cli.main --mode=MAP --model=weights.pt \
        --test_dataset='voc_test_*.txt' --classes_path=voc_classes.txt \
        --anchors_path=yolo_anchors.txt [--exact_nms] [--no-bf16] [--device=cuda]

``--model`` is a port weight file (the trainer's, or
``torch.save(model.state_dict())``) or a weight directory of the JAX
package (read with ``tensorstore``); ``--use_ema`` reads its EMA
weights; without ``--model`` the weights are a seeded init. ``--int8`` (IMAGE
and MAP) serves through the W8A8 backbone (MobileNetV2, EfficientNet),
calibrated on up to ``quantize_samples`` letterboxed images of the test
list, else the train list (text lists or TFRecord shards), else on
noise. ``--config``
overlays a YAML file onto the flags. ``--exact_nms`` takes per-class
pools of the whole grid, the reference's exact NMS. ``--device``
(default ``cuda``) is the port's own; ``--device=cpu`` runs every
kernel's plain version. ``--backbone`` takes every name of the detector
registry and ``--rfcr`` every fusion; the shipped configs run as they
are, e.g.

    python -m yoloret_tpu_torch.cli.main --config=configs/coco_efficientnetb3_416.yaml \
        --mode=MAP --test_dataset='coco_val_*.txt' --exact_nms

Anchors by k-means over a training list's boxes, written to ``--output``
(default ``yolo_anchors.txt``):

    python -m yoloret_tpu_torch.cli.main --mode=ANCHORS --train_dataset='voc_train_*.txt'

The inference program as a ``torch.export`` bundle (``model.pt2``,
``weights.pt``, ``model.json`` in ``--export``, else ``--output``, else
``export_<backbone>``; batch 1; ``--quantize`` stores int8 weights),
traced on ``--device``, where it is to run (``export/export.py``):

    python -m yoloret_tpu_torch.cli.main --mode=EXPORT --model=weights.pt \
        --classes_path=voc_classes.txt --anchors_path=yolo_anchors.txt \
        [--bf16 | --no-bf16] [--quantize] [--export=bundle_dir]

TensorFlow's formats, built from the same weights by TensorFlow ops
(``export/tfjs.py``, ``export/tf_postprocess.py``; float32 whatever
``--bf16`` says): TFLITE writes ``saved_model/`` (the whole program:
``images``, ``image_hw`` -> boxes, scores, classes, valid) and
``model.tflite`` (dynamic-range), with ``--quantize`` also
``model_int8.tflite`` (the conv stack in int8, calibrated on
``quantize_samples`` images of the test or train list); SERVING writes
``saved_model/`` with TF-Serving's warm-up records; TFJS writes
``saved_model/`` and ``tfjs_model/`` (a tfjs graph model of the conv
stack). Where TensorFlow cannot be imported they write the PyTorch
bundle with a message, as the JAX package writes its StableHLO bundle:

    python -m yoloret_tpu_torch.cli.main --mode=TFLITE --model=weights.pt \
        --classes_path=voc_classes.txt --anchors_path=yolo_anchors.txt --export=tf_dir

Detection on a video file or the camera (``--video=0``), every frame
or every ``--track_interval`` frames with OpenCV trackers between,
written with boxes and FPS to ``--output`` when given; prints
``processed N frames``:

    python -m yoloret_tpu_torch.cli.main --mode=VIDEO --video=clip.mp4 \
        --classes_path=voc_classes.txt --anchors_path=yolo_anchors.txt \
        [--track_interval=3] [--output=out.mp4]

``--mesh_data N`` trains and evaluates data-parallel over N devices
(``parallel/``): TRAIN spawns a rank a device on this host (global batch
``--batch_size`` x N), MAP splits each batch over N replicas in one
process (``--batch_size`` a multiple of N); ``multihost: true`` in a
config joins the group that ``torchrun`` starts, a rank a process:

    torchrun --nproc_per_node=4 -m yoloret_tpu_torch.cli.main --mode=TRAIN \
        --config=multihost.yaml ...

Asking for more devices than there are stops with exit code 2 and
``mesh NxM needs K devices, have J``. PRUNE answers as the JAX package
does (exit code 2).

``--opt=DEBUG`` (the flag or ``opt: DEBUG`` in a config) sets the seed to
0, as the JAX package does (the reference's ``main.py:140-144``), and in
TRAIN turns on ``torch.autograd.set_detect_anomaly``. That is not JAX's
``jax_debug_nans``: it checks the backward pass, raising where a
gradient op makes a NaN and naming the forward op that made its input,
and checks no forward op on its own. ``--opt`` XLA and MKL, ``--prune``,
``--num_scales``, ``--video`` and ``--track_interval`` take the JAX
package's meaning in the config.
"""

from __future__ import annotations

import argparse
import os
import sys

from yoloret_tpu_torch.configs import RunConfig, load_config
from yoloret_tpu_torch.nn.detector import BACKBONES

EXPORT_MODES = ("EXPORT", "TFLITE", "SERVING", "TFJS")
PRUNE_MESSAGE = ("PRUNE: model pruning is not implemented (the reference declares the mode "
                 "without a handler); --quantize is likewise threaded but inert for parity")


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
                   help="IMAGE (default), VIDEO, TRAIN, MAP, ANCHORS, EXPORT, TFLITE, SERVING, "
                        "TFJS or PRUNE")
    p.add_argument("--config", type=str, default=None, help="YAML config overlay")
    p.add_argument("--backbone", type=str,
                   help=f"default {d.backbone}; any of {', '.join(sorted(BACKBONES))}")
    p.add_argument("--input_size", type=_parse_size,
                   help="single int or 'h,w', multiples of 32")
    p.add_argument("--num_scales", type=int)
    p.add_argument("--model", type=str,
                   help="port weight file (or torch.save state dict) or JAX weight directory")
    p.add_argument("--train_dataset", type=str, help="glob of text lists and .tfrecord shards")
    p.add_argument("--val_dataset", type=str)
    p.add_argument("--test_dataset", type=str, help="glob of text lists and .tfrecord shards")
    p.add_argument("--classes_path", type=str)
    p.add_argument("--anchors_path", type=str)
    p.add_argument("--batch_size", type=int)
    p.add_argument("--epochs", type=int, nargs=2, metavar=("STAGE1", "STAGE2"))
    p.add_argument("--learning_rate", type=float, nargs=2, metavar=("LR1", "LR2"))
    p.add_argument("--freeze", action="store_true")
    p.add_argument("--no-freeze", dest="freeze", action="store_false")
    p.add_argument("--train_unfreeze", type=str,
                   help="stage-1 weight file; implies stage 2 (unfrozen)")
    p.add_argument("--truncate_block", type=float,
                   help="freeze only backbone blocks up to this depth index")
    p.add_argument("--box_loss", type=str, choices=["giou", "mse"])
    p.add_argument("--class_loss", type=str, choices=["bce", "focal"])
    p.add_argument("--use_adv", action="store_true")
    p.add_argument("--ema_decay", type=float)
    p.add_argument("--remat", action="store_true",
                   help="recompute the backbone's forward in the backward pass")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest periodic checkpoint and continue")
    p.add_argument("--early_stopping", action="store_true")
    p.add_argument("--early_stopping_patience", type=int)
    p.add_argument("--map_every", type=int,
                   help="VOC mAP on --test_dataset every N epochs (0: stage end only)")
    p.add_argument("--log_dir", type=str)
    p.add_argument("--opt", type=str, choices=["XLA", "DEBUG", "MKL"],
                   help="DEBUG: seed 0, and autograd's anomaly check in TRAIN")
    p.add_argument("--seed", type=int)
    p.add_argument("--autoaugment_policy", type=str, choices=["v0", "v1", "v2", "v3"],
                   help="online AutoAugment-for-detection during training")
    p.add_argument("--multi_scale", type=int, nargs="+", metavar="SIZE",
                   help="train each epoch at a size cycled from this list (multiples of 32)")
    p.add_argument("--tb_images", type=int,
                   help="write N augmented inputs with detections per epoch to TensorBoard")
    p.add_argument("--mosaic", type=float, help="online 4-image mosaic probability per sample")
    p.add_argument("--mixup", type=float, help="online mixup probability per sample")
    p.add_argument("--score", dest="score_threshold", type=float)
    p.add_argument("--nms_iou", type=float)
    p.add_argument("--exact_nms", action="store_true",
                   help="MAP: reference-exact full-grid per-class NMS (slower)")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--rfcr", type=str, choices=["weighted_sum", "concat", "none"])
    p.add_argument("--mesh_data", type=int)
    p.add_argument("--int8", action="store_true",
                   help="IMAGE/MAP through the W8A8 backbone (nn/int8_infer.py)")
    p.add_argument("--image", type=str, help="image path (IMAGE mode)")
    p.add_argument("--video", type=str, help="video path or 0 for the camera (VIDEO mode)")
    p.add_argument("--track_interval", type=int,
                   help="VIDEO: re-detect every N frames, track between")
    p.add_argument("--output", type=str, help="output path (IMAGE, VIDEO, ANCHORS, EXPORT)")
    p.add_argument("--export", type=str, help="export output dir")
    p.add_argument("--quantize", action="store_true",
                   help="EXPORT: int8 per-channel weights (export/quantize.py)")
    p.add_argument("--prune", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (every kernel's plain version)")
    return p


def args_to_config(args) -> RunConfig:
    cfg = RunConfig()
    if getattr(args, "config", None):
        cfg = load_config(args.config, cfg)
    overrides = {f: getattr(args, f) for f in (
        "backbone input_size num_scales model train_dataset val_dataset test_dataset "
        "classes_path anchors_path batch_size nms_iou exact_nms bf16 use_ema rfcr mesh_data "
        "int8 freeze train_unfreeze truncate_block box_loss class_loss use_adv ema_decay remat "
        "resume early_stopping early_stopping_patience map_every log_dir opt seed "
        "autoaugment_policy tb_images score_threshold image video track_interval output "
        "export quantize prune").split() if hasattr(args, f)}
    for f in ("epochs", "learning_rate", "multi_scale"):
        if hasattr(args, f):
            overrides[f] = (list if f == "multi_scale" else tuple)(getattr(args, f))
    if getattr(args, "train_unfreeze", None) and "freeze" not in overrides:
        overrides["freeze"] = False
    aug = dict(cfg.augment or {})
    for flag, key in (("mosaic", "mosaic_prob"), ("mixup", "mixup_prob")):
        if getattr(args, flag, None) is not None:
            aug[key] = float(getattr(args, flag))
    if aug:
        overrides["augment"] = aug
    return cfg.replace(**overrides)


def _refuse(what: str) -> int:
    print(f"{what} (see ROADMAP.md, queue 1)", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    mode = args.mode.upper()
    cfg = args_to_config(args)
    debug = bool(cfg.opt) and cfg.opt.upper() == "DEBUG"
    if debug:
        cfg = cfg.replace(seed=0)  # as the JAX package does (reference main.py:140-144)
    if mode == "TRAIN_BACKBONE":
        # as the JAX package answers it
        print("TRAIN_BACKBONE: pretraining the backbone alone is handled by the "
              "truncated-transfer weight import; see docs/parity.md")
        return 2
    if mode == "PRUNE":
        print(PRUNE_MESSAGE)  # as the JAX package answers it
        return 2
    if mode not in ("IMAGE", "VIDEO", "MAP", "TRAIN", "ANCHORS") + EXPORT_MODES:
        return _refuse(f"unknown mode {args.mode!r}")
    mesh = None
    if cfg.mesh_data and cfg.mesh_data > 1 and not cfg.multihost:
        from yoloret_tpu_torch.parallel.mesh import make_mesh

        try:
            mesh = make_mesh(data=cfg.mesh_data, device=args.device)
        except ValueError as e:
            print(e, file=sys.stderr)
            return 2

    if mode == "ANCHORS":
        from yoloret_tpu_torch.tools.kmeans import kmeans_anchors_cli

        if not cfg.train_dataset:
            print("ANCHORS needs --train_dataset", file=sys.stderr)
            return 2
        kmeans_anchors_cli(cfg.train_dataset, cfg.output or "yolo_anchors.txt")
        return 0

    if mode == "IMAGE":
        return _image(cfg, args.device)

    if mode == "VIDEO":
        return _video(cfg, args.device)

    if mode in EXPORT_MODES:
        from yoloret_tpu_torch.export.export import export_model

        try:
            export_model(cfg, flavor=mode.lower(), device=args.device)
        except ValueError as e:
            print(e, file=sys.stderr)
            return 2
        return 0

    if mode == "TRAIN":
        import torch

        from yoloret_tpu_torch.train.trainer import train

        try:
            with torch.autograd.set_detect_anomaly(debug):
                train(cfg, device=args.device)
        except (NotImplementedError, ValueError) as e:
            print(e, file=sys.stderr)
            return 2
        return 0

    if not (cfg.test_dataset and cfg.classes_path and cfg.anchors_path):
        print("MAP needs --test_dataset, --classes_path and --anchors_path", file=sys.stderr)
        return 2

    from yoloret_tpu_torch.data import Dataset, DatasetMode, load_anchors, load_classes
    from yoloret_tpu_torch.eval import evaluate_map
    from yoloret_tpu_torch.infer.predictor import Predictor, int8_options

    class_names = load_classes(cfg.classes_path)
    anchors = load_anchors(cfg.anchors_path)
    pred = Predictor(
        backbone=cfg.backbone, weights=cfg.model, class_names=class_names, anchors=anchors,
        input_hw=cfg.input_size, bf16=cfg.bf16, rfcr=cfg.rfcr, use_ema=cfg.use_ema,
        score_threshold=0.0,  # the reference sets score=0 for MAP, main.py:172
        device=args.device, mesh=mesh, **int8_options(cfg),
    )
    ds = Dataset(cfg.test_dataset, batch_size=max(cfg.batch_size, 1), input_hw=cfg.input_size,
                 mode=DatasetMode.TEST, device=pred.device)
    kw = {}
    if cfg.exact_nms:
        h, w = cfg.input_size
        kw = dict(pool="per_class",
                  num_candidates=sum((h // s) * (w // s) * 3 for s in (32, 16, 8)))
    try:
        evaluate_map(pred, ds, class_names, nms_iou=cfg.nms_iou, mesh=mesh, **kw)
    except ValueError as e:  # a batch the mesh does not divide
        print(e, file=sys.stderr)
        return 2
    return 0


def _image(cfg: RunConfig, device: str) -> int:
    """IMAGE: detections on ``--image`` (default: the port's demo photo),
    drawn and saved to ``--output`` (default ``demo_out.png``); one line
    per detection, then ``wrote <path>``."""
    from yoloret_tpu_torch.infer.predictor import Predictor, int8_options

    if not (cfg.classes_path and cfg.anchors_path):
        print("IMAGE needs --classes_path and --anchors_path", file=sys.stderr)
        return 2
    pred = Predictor(
        backbone=cfg.backbone, weights=cfg.model, classes_path=cfg.classes_path,
        anchors_path=cfg.anchors_path, input_hw=cfg.input_size,
        score_threshold=cfg.score_threshold, iou_threshold=cfg.nms_iou, bf16=cfg.bf16,
        use_ema=cfg.use_ema, rfcr=cfg.rfcr, device=device, **int8_options(cfg))
    img, dets = pred.detect_image(cfg.image or demo_image())
    out = cfg.output or "demo_out.png"
    img.save(out)
    for d in dets:
        print(f"{d.class_name} {d.score:.3f} {tuple(round(v, 1) for v in d.box)}")
    print(f"wrote {out}")
    return 0


def _video(cfg: RunConfig, device: str) -> int:
    """VIDEO: ``Predictor.detect_video`` on ``--video`` (a file, or 0 for
    the camera), re-detecting every ``--track_interval`` frames, written
    to ``--output`` when given; prints ``processed N frames``."""
    from yoloret_tpu_torch.infer.predictor import Predictor, int8_options

    if not cfg.video:
        print("--video required", file=sys.stderr)
        return 2
    pred = Predictor(
        backbone=cfg.backbone, weights=cfg.model, classes_path=cfg.classes_path,
        anchors_path=cfg.anchors_path, input_hw=cfg.input_size,
        score_threshold=cfg.score_threshold, iou_threshold=cfg.nms_iou, bf16=cfg.bf16,
        rfcr=cfg.rfcr, device=device, **int8_options(cfg))
    n = pred.detect_video(cfg.video, cfg.output, track_interval=cfg.track_interval)
    print(f"processed {n} frames")
    return 0


def demo_image() -> str:
    """The port's copy of the demo photo (a VOC frame)."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "assets", "demo.jpg")


if __name__ == "__main__":
    sys.exit(main())
