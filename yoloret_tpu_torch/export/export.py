"""Model export: the whole inference program as a ``torch.export``
bundle, and TensorFlow's formats. Port of ``yoloret_tpu/export/
export.py`` (``export_stablehlo``, ``_representative_dataset``,
``_export_tflite_int8``, ``export_tf_flavor``, ``export_model``).

The JAX package serialises its inference program (forward, decode, NMS)
as StableHLO that takes the weights as an argument, and stores the
weights beside it. The port does the same with ``torch.export``:

  * ``model.pt2``: the program ``(weights, images, image_hw) -> (boxes
    [ymin, xmin, ymax, xmax], scores, classes, valid)``, images float32
    [B, H, W, 3] in [0, 1], image_hw float32 [B, 2]. It holds no weight
    tensor: ``weights`` is a dict of tensors (``program_weights``). For a
    MobileNetV2 backbone the program runs the stem, then 16
    ``yoloret::mbconv`` nodes (the fused block, BatchNorm folded and the
    weights packed by ``nn/fused_infer.fused_params`` at load), then
    the RFCR and the neck from their module weights; any other backbone
    its stock modules. Then exact top-M with M=256 over the shared pool
    and one ``yoloret::nms`` node (``ops/library.py``).
  * ``weights.pt``: the port's state dict, the file ``--model`` reads;
    with ``quantize`` the int8 state dict of ``export/quantize.py``.
  * ``model.json``: the JAX bundle's keys, with ``torch_version`` and
    the export ``device`` in place of ``jax_version``,
    ``calling_convention_version`` and ``platforms``, and the ``rfcr``
    fusion and ``bf16`` that ``load_bundle`` rebuilds the model with.

A program traced on one device type keeps it (``torch.arange`` and the
like are recorded with their device): export on the device the bundle
will run on. ``load_bundle`` refuses a bundle of another device type.

The TensorFlow flavours (``export_tf_flavor``: the SavedModel, TFLite
dynamic-range and calibrated int8, the tfjs graph model, TF-Serving's
warm-up records) are built from the port's weights by TensorFlow ops:
the detector's forward (``export/tfjs.py``) and the shared-pool
postprocess (``export/tf_postprocess.py``), where the JAX package
converts its program with ``jax2tf``. Their weights are read on the CPU
and held in the graphs as numpy constants; no torch forward runs, and
the artifacts run on TensorFlow's runtimes, not through the port's
kernels.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch
from torch import nn

from yoloret_tpu_torch.configs import RunConfig
from yoloret_tpu_torch.data.annotations import load_anchors, load_classes
from yoloret_tpu_torch.device import DeviceLike, resolve_device
from yoloret_tpu_torch.nn.detector import YoloReT, build_detector
from yoloret_tpu_torch.nn.fused_infer import (
    BlockMeta,
    FusedParams,
    fused_params,
    is_fused,
    mobilenetv2_fused_features,
)
from yoloret_tpu_torch.ops.library import mbconv_block
from yoloret_tpu_torch.ops.mbconv import packed_like
from yoloret_tpu_torch.ops.nms import NMSResult, fused_result
from yoloret_tpu_torch.ops.postprocess import shared_pool_candidates
from yoloret_tpu_torch.utils.checkpoint import load_params, save_params

PROGRAM, WEIGHTS, META = "model.pt2", "weights.pt", "model.json"
NUM_CANDIDATES = 256  # the shared pool of export_stablehlo's detect_batch
MAX_DET = 20
_BLOCK_ARGS = ("we", "be", "wd", "bd", "wp", "bp")
TF_FLAVORS = ("tflite", "serving", "tfjs")


def program_weights(model: YoloReT, anchors) -> Dict[str, torch.Tensor]:
    """The exported program's first argument, on the model's device:
    ``anchors`` [9, 2]; for a MobileNetV2 backbone the folded stem
    (``stem.weight``, ``stem.bias``), each block's folded weights
    (``block_<i>.we`` ... ``.bp``, layouts as ``fused_mbconv``'s) and its
    packed weights (``block_<i>.packed``: the bf16 kernel's layout or the
    float32 kernel's, by the model's dtype), then the
    RFCR and neck entries of the state dict; any other backbone the
    whole state dict."""
    state = model.state_dict()
    dev = next(iter(state.values())).device
    out = {"anchors": torch.as_tensor(np.asarray(anchors, np.float32), device=dev)}
    fused = fused_params(model)
    if fused is None:
        out.update(state)
        return out
    out["stem.weight"], out["stem.bias"] = fused.stem
    for meta in fused.blocks:
        for name, t in zip(_BLOCK_ARGS, meta.args):
            if t is not None:
                out[f"block_{meta.block_id}.{name}"] = t
        if meta.packed is not None:
            out[f"block_{meta.block_id}.packed"] = meta.packed.w
    out.update({k: v for k, v in state.items() if not k.startswith("body.")})
    return out


class _Method(nn.Module):
    """``model.<method>`` as a module's forward, for ``functional_call``."""

    def __init__(self, model: nn.Module, method: str):
        super().__init__()
        self.model = model
        self.method = method

    def forward(self, *args):
        return getattr(self.model, self.method)(*args)


class InferenceProgram(nn.Module):
    """``forward(weights, images, image_hw)`` -> (boxes, scores, classes,
    valid): the traced function of the bundle. The detector it runs is a
    skeleton on the meta device, kept outside the module's registered
    children, whose tensors ``weights`` stands in for at every call: the
    program holds no weight tensor."""

    def __init__(self, backbone: str, num_classes: int, dtype: torch.dtype, rfcr: str,
                 score_threshold: float, nms_iou: float):
        super().__init__()
        with torch.device("meta"):
            skeleton = YoloReT(backbone, num_classes=num_classes, dtype=dtype, rfcr=rfcr)
        object.__setattr__(self, "skeleton", skeleton.eval())
        self.num_classes = num_classes
        self.score_threshold = float(score_threshold)
        self.nms_iou = float(nms_iou)

    def heads(self, weights: Dict[str, torch.Tensor], images: torch.Tensor):
        model = self.skeleton
        call = torch.func.functional_call
        if not is_fused(model):
            state = {k: v for k, v in weights.items() if k != "anchors"}
            return call(model, state, (images,), strict=False)
        model.check_input(images)
        blocks = []
        for i, name in enumerate(model.body.block_names):
            block = getattr(model.body, name)
            args = tuple(weights.get(f"block_{i}.{n}") for n in _BLOCK_ARGS)
            packed = weights.get(f"block_{i}.packed")
            packed = None if packed is None else packed_like(packed, args[0], args[2], args[4])
            blocks.append(BlockMeta(i, block.stride, block.residual, args, packed))
        params = FusedParams((weights["stem.weight"], weights["stem.bias"]), blocks)
        feats = mobilenetv2_fused_features(images.to(model.dtype), params, block=mbconv_block)
        neck = {"model." + k: v for k, v in weights.items()
                if k.startswith(("rfcr.", "neck."))}
        return call(_Method(model, "neck_heads"), neck, (feats,), strict=False)

    def forward(self, weights: Dict[str, torch.Tensor], images: torch.Tensor,
                image_hw: torch.Tensor):
        heads = self.heads(weights, images)
        boxes, cls_scores = shared_pool_candidates(heads, weights["anchors"], self.num_classes,
                                                   image_hw, num_candidates=NUM_CANDIDATES)
        out_boxes, out_scores = torch.ops.yoloret.nms(boxes, cls_scores, MAX_DET, self.nms_iou,
                                                      self.score_threshold, 0.0)
        r = fused_result(out_boxes, out_scores)
        return r.boxes, r.scores, r.classes, r.valid


def export_bundle(cfg: RunConfig, out_dir: str, batch: int = 1,
                  device: DeviceLike = "cuda") -> str:
    """Write the bundle of ``cfg``'s detector (``cfg.backbone``,
    ``cfg.rfcr``, ``cfg.input_size``, ``cfg.model`` or the seeded init of
    seed 0, as ``Predictor``'s default; bf16 when ``cfg.bf16``, int8
    weights when ``cfg.quantize``) for ``batch`` images, traced on
    ``device``; returns ``out_dir``."""
    from yoloret_tpu_torch.export.quantize import quantize_state_dict

    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    class_names = load_classes(cfg.classes_path)
    anchors = load_anchors(cfg.anchors_path)
    num_classes = len(class_names)
    model = build_detector(cfg.backbone, num_classes=num_classes,
                           dtype=torch.bfloat16 if cfg.bf16 else torch.float32, rfcr=cfg.rfcr,
                           device=dev)
    if cfg.model:
        model.load_state_dict(load_params(cfg.model, cfg.use_ema), strict=True)
    program = InferenceProgram(cfg.backbone, num_classes, model.dtype, cfg.rfcr,
                               cfg.score_threshold, cfg.nms_iou)
    h, w = cfg.input_size
    example = (program_weights(model, anchors),
               torch.zeros((batch, h, w, 3), dtype=torch.float32, device=dev),
               torch.full((batch, 2), float(max(h, w)), dtype=torch.float32, device=dev))
    with torch.no_grad():
        exported = torch.export.export(program, example)
    exported.example_inputs = None  # saved, they would carry the weights into the program file
    path = os.path.join(out_dir, PROGRAM)
    torch.export.save(exported, path)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    if cfg.quantize:
        qstate, stats = quantize_state_dict(state)
        torch.save(qstate, os.path.join(out_dir, WEIGHTS))
        print(f"int8 weights: {stats['bytes_fp'] / 1e6:.2f} MB -> "
              f"{stats['bytes_q'] / 1e6:.2f} MB")
    else:
        save_params(os.path.join(out_dir, WEIGHTS), state)
    meta = {
        "backbone": cfg.backbone,
        "input_size": list(cfg.input_size),
        "batch": batch,
        "num_classes": num_classes,
        "class_names": class_names,
        "anchors": np.asarray(anchors).tolist(),
        "score_threshold": cfg.score_threshold,
        "nms_iou": cfg.nms_iou,
        "quantized": bool(cfg.quantize),
        "outputs": ["boxes[ymin,xmin,ymax,xmax]", "scores", "classes", "valid"],
        "rfcr": cfg.rfcr,
        "bf16": bool(cfg.bf16),
        "torch_version": torch.__version__,
        "device": dev.type,
    }
    with open(os.path.join(out_dir, META), "w") as f:
        json.dump(meta, f, indent=2)
    print(f"PyTorch export bundle -> {out_dir} ({os.path.getsize(path)} bytes program, "
          f"traced on {dev.type})")
    return out_dir


class Bundle:
    """A loaded bundle: ``bundle(images, image_hw) -> NMSResult``, with
    ``meta`` (``model.json``), ``program`` (the ``ExportedProgram``) and
    ``weights`` (its first argument, folded and packed at load).

    The program's module checks every input against its signature before
    each call: for the ~300 weight tensors that cost ~7 ms of host a call
    on an H100's host, more than a b1 forward. The weights do not change
    after load, so they are checked once, by a first call on zeros here;
    later calls check only ``images`` and ``image_hw``."""

    def __init__(self, meta: dict, program, weights: Dict[str, torch.Tensor]):
        self.meta = meta
        self.program = program
        self.weights = weights
        self._fn = program.module()
        dev = next(iter(weights.values())).device
        b, (h, w) = meta["batch"], meta["input_size"]
        self._specs = (((b, h, w, 3), torch.float32, dev), ((b, 2), torch.float32, dev))
        self(*(torch.zeros(shape, dtype=dt, device=d) for shape, dt, d in self._specs))
        self._fn.validate_inputs = False

    def __call__(self, images: torch.Tensor, image_hw: torch.Tensor) -> NMSResult:
        for t, (shape, dt, dev) in zip((images, image_hw), self._specs):
            if tuple(t.shape) != shape or t.dtype != dt or t.device != dev:
                raise ValueError(f"the bundle takes {shape} {dt} on {dev}, not "
                                 f"{tuple(t.shape)} {t.dtype} on {t.device}")
        with torch.inference_mode():
            return NMSResult(*self._fn(self.weights, images, image_hw))


def load_bundle(out_dir: str, device: DeviceLike = "cuda") -> Bundle:
    """Load a bundle of ``export_bundle`` on ``device`` (which must be of
    the type it was traced on): the program, the weights (dequantized
    where ``quantized``), folded and packed once (``program_weights``).
    On the card its ``yoloret::mbconv`` and ``yoloret::nms`` nodes launch
    the Hopper kernels (``fused_mbconv.launches``,
    ``suppress.launches``)."""
    import yoloret_tpu_torch.ops.library  # noqa: F401  (registers the operators)
    from yoloret_tpu_torch.export.quantize import dequantize_state_dict

    dev = resolve_device(device)
    with open(os.path.join(out_dir, META)) as f:
        meta = json.load(f)
    if meta["device"] != dev.type:
        raise ValueError(f"{out_dir} was exported on {meta['device']!r} and its program keeps "
                         f"that device: it cannot run on {dev.type!r}; export it again there")
    program = torch.export.load(os.path.join(out_dir, PROGRAM))
    state = torch.load(os.path.join(out_dir, WEIGHTS), map_location="cpu", weights_only=True)
    if meta["quantized"]:
        state = dequantize_state_dict(state)
    model = YoloReT(meta["backbone"], num_classes=meta["num_classes"],
                    dtype=torch.bfloat16 if meta["bf16"] else torch.float32, rfcr=meta["rfcr"])
    model.load_state_dict(state, strict=True)
    model.to(dev).eval()
    return Bundle(meta, program, program_weights(model, meta["anchors"]))


def _representative_dataset(cfg: RunConfig, batch: int, n_samples: int = 32):
    """Calibration feed of the full-int8 conversion: ``n_samples``
    letterboxed images of the ``cfg.test_dataset``, else
    ``cfg.train_dataset``, annotation list (a file, not a glob), cycled;
    uniform noise of ``RandomState(0)`` without one. Each sample is a dict
    ``{"images": [batch, H, W, 3] float32 in [0, 1], "image_hw": [batch,
    2]}`` (the signature's input names: the calibrator need not take
    them in the signature's order)."""
    h, w = cfg.input_size

    def gen():
        from PIL import Image

        from yoloret_tpu_torch.data.annotations import parse_annotation_line
        from yoloret_tpu_torch.ops.letterbox import letterbox_numpy_u8

        paths = []
        for src in (cfg.test_dataset, cfg.train_dataset):
            if src and os.path.exists(src) and not any(c in src for c in "*?["):
                with open(src) as fh:
                    paths = [parse_annotation_line(line)[0] for line in fh if line.strip()]
                break
        rng = np.random.RandomState(0)
        for i in range(n_samples):
            if paths:
                arr = np.asarray(Image.open(paths[i % len(paths)]).convert("RGB"), np.uint8)
                ih, iw = arr.shape[:2]
                img = letterbox_numpy_u8(arr, (h, w)).astype(np.float32) / 255.0
            else:
                ih, iw = h, w
                img = rng.rand(h, w, 3).astype(np.float32)
            images = np.broadcast_to(img, (batch, h, w, 3)).copy()
            hw = np.zeros((batch, 2), np.float32)
            hw[:, 0], hw[:, 1] = float(ih), float(iw)
            yield {"images": images, "image_hw": hw}

    return gen


def _export_tflite_int8(cfg: RunConfig, out_dir: str, batch: int, model: YoloReT) -> str:
    """Full-int8 TFLite of the conv stack (``model_int8.tflite``, float
    input and outputs: the three raw heads), calibrated on
    ``cfg.quantize_samples`` samples of ``_representative_dataset``; the
    graph the reference's own TFLite export covers (it converts its model
    without the NMS tail, code/yolo.py:386-394). Decode and NMS stay
    float32: run ``model.tflite``, or the heads through a float
    postprocess. Returns the path, or "" with a message when the
    conversion fails."""
    import tensorflow as tf

    from yoloret_tpu_torch.export.tfjs import tf_mirror

    raw = tf_mirror(model, batch, cfg.input_size)
    module = tf.Module()
    module.raw = raw
    raw_dir = os.path.join(out_dir, "saved_model_raw")
    tf.saved_model.save(module, raw_dir, signatures={"serving_default": raw})
    conv = tf.lite.TFLiteConverter.from_saved_model(raw_dir)
    conv.optimizations = [tf.lite.Optimize.DEFAULT]
    rep = _representative_dataset(cfg, batch, n_samples=cfg.quantize_samples)

    def images_only():
        for d in rep():
            yield {"images": d["images"]}

    conv.representative_dataset = images_only
    conv.target_spec.supported_ops = [
        tf.lite.OpsSet.TFLITE_BUILTINS_INT8,
        tf.lite.OpsSet.TFLITE_BUILTINS,  # for the ops that do not quantize
    ]
    path = os.path.join(out_dir, "model_int8.tflite")
    try:
        blob = conv.convert()
    except Exception as e:
        print(f"full-int8 conversion failed for backbone {cfg.backbone!r} "
              f"({type(e).__name__}: {str(e)[:200]}...); the dynamic-range "
              f"f32 pipeline artifact model.tflite is still valid")
        return ""
    with open(path, "wb") as f:
        f.write(blob)
    print(f"TFLite flatbuffer (full-int8 conv stack, calibrated on "
          f"{cfg.quantize_samples} samples) -> {path}")
    return path


def tf_program(cfg: RunConfig, model: YoloReT, batch: int = 1):
    """tf.function ``infer(images, image_hw)`` -> (boxes [ymin, xmin,
    ymax, xmax], scores, classes, valid): ``model``'s forward in TF ops
    (``export/tfjs.py::tf_mirror``) and the shared-pool postprocess of
    ``export/tf_postprocess.py`` at M=256 with ``cfg``'s thresholds, for
    images [batch, H, W, 3] float32 in [0, 1] and image_hw [batch, 2]."""
    import tensorflow as tf

    from yoloret_tpu_torch.export import tf_postprocess
    from yoloret_tpu_torch.export.tfjs import tf_mirror

    raw = tf_mirror(model, batch, cfg.input_size)
    anchors = load_anchors(cfg.anchors_path)

    def infer(images, image_hw):
        return tf_postprocess.detect(raw(images), anchors, image_hw,
                                     score_threshold=cfg.score_threshold,
                                     iou_threshold=cfg.nms_iou, num_candidates=NUM_CANDIDATES,
                                     max_det=MAX_DET)

    h, w = cfg.input_size
    return tf.function(infer, input_signature=[
        tf.TensorSpec([batch, h, w, 3], tf.float32, name="images"),
        tf.TensorSpec([batch, 2], tf.float32, name="image_hw")], autograph=False)


def export_tf_flavor(cfg: RunConfig, out_dir: str, flavor: str, batch: int = 1) -> str:
    """The reference's TensorFlow artifacts (code/yolo.py:333-394) in
    ``out_dir``, float32 whatever ``cfg.bf16`` says (bf16 is a compute
    choice of the card with no meaning for an edge artifact, and the JAX
    package's TFLite converter fails on a bf16 graph): always
    ``saved_model/``, whose ``serving_default`` signature is
    ``tf_program`` (``images``, ``image_hw``); then by ``flavor``:

    - ``tflite``: ``model.tflite``, the SavedModel converted with
      ``Optimize.DEFAULT`` (dynamic-range int8 weights), and with
      ``cfg.quantize`` also ``model_int8.tflite`` (``_export_tflite_int8``);
    - ``tfjs``: ``tfjs_model/``, the tfjs graph model of the conv stack
      (``mobilenetv2*`` and ``efficientnetb*``; for another backbone the
      SavedModel is staged and a message names the ``tensorflowjs_converter``
      command that finishes it, as the JAX package does);
    - ``serving``: TF-Serving's warm-up records of two
      ``_representative_dataset`` batches in the SavedModel's
      ``assets.extra/``.

    Every backbone of the registry. The weights (``cfg.model``, else the
    seeded init of seed 0) are read on the CPU; ValueError, before
    anything is written, for the RFCR ``concat`` and ``none`` fusions
    (``export/tfjs.py::check_mirrored``). Needs TensorFlow."""
    import tensorflow as tf

    from yoloret_tpu_torch.export.tfjs import export_tfjs_graph_model, load_detector

    model = load_detector(cfg)
    os.makedirs(out_dir, exist_ok=True)
    infer = tf_program(cfg, model, batch)
    module = tf.Module()
    module.infer = infer
    saved_dir = os.path.join(out_dir, "saved_model")
    tf.saved_model.save(module, saved_dir, signatures={"serving_default": infer})
    if flavor == "tflite":
        conv = tf.lite.TFLiteConverter.from_saved_model(saved_dir)
        conv.optimizations = [tf.lite.Optimize.DEFAULT]
        blob = conv.convert()  # before the open: a failed conversion leaves no file
        with open(os.path.join(out_dir, "model.tflite"), "wb") as f:
            f.write(blob)
        print(f"TFLite flatbuffer (dynamic-range) -> {out_dir}/model.tflite")
        if cfg.quantize:
            _export_tflite_int8(cfg, out_dir, batch, model)
    elif flavor == "tfjs":
        try:
            tfjs_dir = export_tfjs_graph_model(cfg, os.path.join(out_dir, "tfjs_model"), batch,
                                               model)
            print(f"TF.js graph model (conv stack, raw heads) -> {tfjs_dir}; full-pipeline "
                  f"SavedModel at {saved_dir}")
        except ValueError as e:  # a backbone outside the graph model's families
            print(f"native tfjs converter: {e}; SavedModel staged at {saved_dir} - finish "
                  f"with: tensorflowjs_converter --input_format=tf_saved_model {saved_dir} "
                  f"{out_dir}/tfjs_model")
    else:
        from yoloret_tpu_torch.export.warmup import write_warmup_records

        rep = _representative_dataset(cfg, batch, n_samples=2)
        write_warmup_records(saved_dir, rep(), model_name=cfg.backbone)
        print(f"TF-Serving SavedModel -> {saved_dir}")
    return out_dir


def export_model(cfg: RunConfig, flavor: str = "export", device: DeviceLike = "cuda") -> str:
    """The CLI's EXPORT / TFLITE / SERVING / TFJS, for batch 1, in
    ``cfg.export or cfg.output or export_<backbone>``: EXPORT the bundle
    traced on ``device``; a TensorFlow flavour ``export_tf_flavor``'s
    artifacts (on the CPU, whatever ``device`` says) where TensorFlow can
    be imported, else the bundle with a message, as the JAX package writes
    its StableHLO bundle. ``ValueError`` without ``cfg.classes_path`` and
    ``cfg.anchors_path``."""
    out_dir = cfg.export or cfg.output or f"export_{cfg.backbone}"
    if flavor not in ("export",) + TF_FLAVORS:
        raise ValueError(f"unknown export flavour {flavor!r}")
    if not (cfg.classes_path and cfg.anchors_path):
        raise ValueError(f"{flavor.upper()} needs --classes_path and --anchors_path")
    if flavor in TF_FLAVORS:
        try:
            import tensorflow  # noqa: F401
        except ImportError:
            print(f"{flavor}: TensorFlow runtime not present in this image; writing the "
                  "portable PyTorch export bundle instead.")
        else:
            return export_tf_flavor(cfg, out_dir, flavor)
    return export_bundle(cfg, out_dir, device=device)


def bundle_graph_counts(program) -> Dict[str, int]:
    """Nodes of an ``ExportedProgram`` by kind: ``mbconv`` and ``nms``
    (the operators), ``argmax`` (an unrolled greedy round would hold
    one), and the tensors it holds (``state_dict`` and constants)."""
    targets = [n.target for n in program.graph.nodes if n.op == "call_function"]
    return {"mbconv": targets.count(torch.ops.yoloret.mbconv.default),
            "nms": targets.count(torch.ops.yoloret.nms.default),
            "argmax": targets.count(torch.ops.aten.argmax.default),
            "tensors": len(program.state_dict) + len(program.constants)}
