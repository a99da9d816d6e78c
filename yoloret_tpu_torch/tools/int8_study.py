"""Full-int8 TFLite accuracy study: the mAP cost of calibrated integer
quantization against the float32 pipeline. Port of
``yoloret_tpu/tools/int8_study.py``.

The reference ships a weight-only TFLite export and an inert
``--quantize`` flag (reference: code/yolo.py:386-394); the edge
deployments the paper targets run full-int8 with activation
calibration. This study trains the crowded synthetic task to partial
convergence (the recipe of tools/topk_study.py -- a fully overfit model
is insensitive and the study would say nothing), exports

  * the dynamic-range TFLite (int8 weights, the reference's flavour)
  * the full-int8 TFLite (calibrated on 16 of the training scenes)

through ``export/export.py::export_tf_flavor``, and scores four backends
with the same VOC-2010 evaluator over the training scenes, image by
image: the port's float32 path (``torch_f32``), its W8A8 backbone
(``torch_int8``, ``nn/int8_infer.py`` calibrated on the same 16 scenes),
and both TFLite flavours; the full-int8 model's raw heads go through the
port's ``detect_batch``.

    python -m yoloret_tpu_torch.tools.int8_study [--epochs 60] [--size 160] [--device cuda]

Training and the torch rows run on ``--device`` (float32, on deterministic
kernels: ``device.reproducible``); the TFLite rows need TensorFlow, which
is imported first, so that a machine without it fails before training.

Output: a markdown mAP table.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from yoloret_tpu_torch.tools.topk_study import CLASS_NAMES, build_crowded

BACKENDS = ("torch_f32", "torch_int8", "tflite_f32", "tflite_int8")


def _interp_outputs(interp, images, hw=None):
    for d in interp.get_input_details():
        interp.set_tensor(d["index"], images if d["shape"][-1] == 3 else hw)
    interp.invoke()
    return {
        (np.dtype(o["dtype"]).name, tuple(o["shape"][1:])):
            interp.get_tensor(o["index"])
        for o in interp.get_output_details()
    }


def read_samples(ann: str) -> list:
    """[(RGB uint8 image, ground-truth boxes [N, 5] x1, y1, x2, y2, class)]
    of an annotation list."""
    from PIL import Image

    from yoloret_tpu_torch.data.annotations import parse_annotation_line

    samples = []
    with open(ann) as fh:
        for line in fh:
            if line.strip():
                path, boxes = parse_annotation_line(line)
                samples.append((np.asarray(Image.open(path).convert("RGB"), np.uint8), boxes))
    return samples


def letterboxed(arr: np.ndarray, size: int):
    """(images [1, size, size, 3] float32 in [0, 1], image_hw [1, 2]) of
    one image, as every backend takes it."""
    from yoloret_tpu_torch.ops.letterbox import letterbox_numpy_u8

    img = letterbox_numpy_u8(arr, (size, size)).astype(np.float32) / 255.0
    return img[None], np.asarray([[arr.shape[0], arr.shape[1]]], np.float32)


def torch_detect(pred, size: int):
    """detect(arr) -> (boxes (ymin, xmin, ymax, xmax) in the image's
    pixels, scores, classes) of the valid slots of ``pred.infer``."""
    import torch

    def detect(arr):
        images, hw = letterboxed(arr, size)
        r = pred.infer(torch.from_numpy(images).to(pred.device),
                       torch.from_numpy(hw).to(pred.device))
        m = r.valid[0].cpu().numpy()
        return tuple(t[0].cpu().numpy()[m] for t in (r.boxes, r.scores, r.classes))

    return detect


def backend_map(detect, samples, num_classes: int = len(CLASS_NAMES)) -> float:
    """VOC mAP of ``detect`` over ``samples`` (``read_samples``)."""
    from yoloret_tpu_torch.eval.map import MAPEvaluator

    ev = MAPEvaluator(num_classes=num_classes)
    for arr, gtb in samples:
        db, ds_, dc = detect(arr)
        # gt is (x1, y1, x2, y2, cls); detections (ymin, xmin, ymax, xmax)
        det_xyxy = db[:, [1, 0, 3, 2]] if len(db) else db.reshape(0, 4)
        ev.add_image(det_xyxy, ds_, dc, gtb)
    aps = ev.compute()
    return float(np.mean(list(aps.values()))) if aps else 0.0


def run(epochs: int = 60, size: int = 160, batch: int = 8,
        workdir: str | None = None, max_boxes: int = 12, device="cuda"):
    import tensorflow as tf
    import torch

    from yoloret_tpu_torch.data import load_anchors
    from yoloret_tpu_torch.device import reproducible
    from yoloret_tpu_torch.export.export import export_tf_flavor
    from yoloret_tpu_torch.infer import Predictor
    from yoloret_tpu_torch.ops.postprocess import detect_batch
    from yoloret_tpu_torch.tools.topk_study import crowded_train_cfg
    from yoloret_tpu_torch.train.trainer import train

    workdir = workdir or tempfile.mkdtemp(prefix="yoloret_int8_study_")
    ann, classes, anchors_path = build_crowded(workdir)
    cfg = crowded_train_cfg(workdir, ann, classes, anchors_path,
                            epochs=epochs, size=size, batch=batch,
                            max_boxes=max_boxes)
    weights = os.path.join(
        cfg.log_dir, "mobilenetv2x75_stage2",
        "mobilenetv2x75_trained_weights_final.pt",
    )
    with reproducible(device):
        if not os.path.exists(weights):
            weights = train(cfg, device=device)

        # MAP-grade threshold: at partial convergence most true detections
        # score low, and a 0.05 cut was measured (JAX package) to collapse
        # AP 0.31 -> 0.04 while changing nothing about int8 vs float32
        ecfg = cfg.replace(model=weights, score_threshold=0.0, test_dataset=ann)
        f32_dir = export_tf_flavor(ecfg, os.path.join(workdir, "f32"), "tflite")
        int8_dir = export_tf_flavor(
            ecfg.replace(quantize=True, quantize_samples=16),
            os.path.join(workdir, "int8"), "tflite",
        )

        samples = read_samples(ann)
        anchors = load_anchors(anchors_path)
        nc = len(CLASS_NAMES)
        grids = [(size // s, size // s) for s in (32, 16, 8)]
        # the W8A8 backbone: same trained weights, same 16-image
        # calibration budget as the TFLite converter gets
        calib = np.concatenate([letterboxed(arr, size)[0] for arr, _ in samples[:16]])
        common = dict(backbone=ecfg.backbone, weights=weights, class_names=CLASS_NAMES,
                      anchors=anchors, input_hw=(size, size),
                      score_threshold=ecfg.score_threshold, iou_threshold=ecfg.nms_iou,
                      bf16=False, device=device)
        preds = {"torch_f32": Predictor(**common),
                 "torch_int8": Predictor(use_int8=True, calibration_images=calib, **common)}
        interps = {}
        for name, d, fname in (
            ("tflite_f32", f32_dir, "model.tflite"),
            ("tflite_int8", int8_dir, "model_int8.tflite"),
        ):
            interp = tf.lite.Interpreter(model_path=os.path.join(d, fname))
            interp.allocate_tensors()
            interps[name] = interp
        dev = preds["torch_f32"].device
        anchors_t = torch.as_tensor(anchors, device=dev)

        def tflite_f32(arr):
            images, hw = letterboxed(arr, size)
            outs = _interp_outputs(interps["tflite_f32"], images, hw)
            n_det = [sh[0] for (dt, sh) in outs if dt == "float32" and len(sh) == 2][0]
            m = np.asarray(outs[("bool", (n_det,))][0], bool)
            return tuple(outs[key][0][m] for key in (("float32", (n_det, 4)),
                                                     ("float32", (n_det,)),
                                                     ("int32", (n_det,))))

        def tflite_int8(arr):  # int8 conv stack -> float32 postprocess
            images, hw = letterboxed(arr, size)
            outs = _interp_outputs(interps["tflite_int8"], images)
            heads = [torch.from_numpy(outs[("float32", (gh, gw, 3, 5 + nc))]).to(dev)
                     for gh, gw in grids]
            r = detect_batch(heads, anchors_t, nc, torch.from_numpy(hw).to(dev),
                             score_threshold=ecfg.score_threshold,
                             iou_threshold=ecfg.nms_iou)
            m = r.valid[0].cpu().numpy()
            return tuple(t[0].cpu().numpy()[m] for t in (r.boxes, r.scores, r.classes))

        detectors = {"torch_f32": torch_detect(preds["torch_f32"], size),
                     "torch_int8": torch_detect(preds["torch_int8"], size),
                     "tflite_f32": tflite_f32, "tflite_int8": tflite_int8}
        rows = [(name, backend_map(detectors[name], samples, nc)) for name in BACKENDS]

    base = rows[0][1]
    print(f"\n## Full-int8 TFLite mAP study ({len(CLASS_NAMES)} classes, "
          f"{size}px, partial convergence, MAP-grade thresh 0)\n")
    print("| backend | mAP | delta vs torch_f32 |")
    print("|---|---|---|")
    for backend, m in rows:
        print(f"| {backend} | {m:.4f} | {m - base:+.4f} |")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--size", type=int, default=160)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--workdir", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    run(epochs=a.epochs, size=a.size, batch=a.batch, workdir=a.workdir, device=a.device)


if __name__ == "__main__":
    main()
