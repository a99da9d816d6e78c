"""The detector's forward in TensorFlow ops, and the tfjs graph-model
export. Port of ``yoloret_tpu/export/tfjs.py``: the mirror is built from
the port's weights instead of a Flax tree; the graph-model writer and
reader are copies.

1. **TF mirror** (``build_tf_mirror``, ``tf_mirror``): the inference
   forward of a port ``YoloReT`` rebuilt in plain TF ops, every
   BatchNorm folded into the conv before it (numpy float32, eps 1e-3, as
   the JAX package's ``_fold``), the torch layouts turned into TF's
   (``[Cout, Cin, kh, kw]`` -> ``[kh, kw, Cin, Cout]``; depthwise
   ``[C, 1, kh, kw]`` -> ``[kh, kw, C, 1]``), convolutions with TF's
   ``"SAME"`` padding (the port's ``same_padding`` pads as it does, so no
   ``Pad`` op), swish as ``x * sigmoid(x)``, the SE squeeze as ``Mean``.
   The traced graph holds only the ops of ``TFJS_SAFE_OPS``, each in the
   tfjs kernel registry. The weights are read on the CPU and held as
   numpy constants in the graph: no torch forward runs.
2. **Graph-model writer** (``write_graph_model``): freezes the mirror to
   a GraphDef and writes the layout ``tensorflowjs_converter`` writes:
   ``model.json`` ({format: "graph-model", modelTopology = the GraphDef
   as JSON, signature, weightsManifest}) and 4 MB
   ``group1-shardNofM.bin`` shards holding every Const payload in
   manifest order (the Const nodes keep dtype and shape, not their
   content; the tfjs executor resolves them by name from the weights).

The artifact is the conv stack, as the reference's TFJS and TFLite
exports are: input ``images`` [B, H, W, 3] RGB float32 in [0, 1], outputs
the three raw heads [B, gh, gw, A, 5+C] (decode and NMS run in the
consumer). ``read_graph_model`` loads the artifact back into a TF graph.
TensorFlow is imported inside the functions that need it.

Coverage (``check_mirrored``, ``check_graph_model``): the mirror, and
with it the SavedModel, TFLite and TF-Serving flavours, covers every
backbone of the registry, as the JAX package's ``jax2tf`` flavours do:
MobileNetV2, EfficientNet and DarkNet-53 (LeakyReLU, the max-pool taps)
into the weighted-sum RFCR and the neck, and the full YOLO-Nano and
Yolo-Fastest(-XL) bodies, which return their three heads without RFCR
or neck. The tfjs graph model covers the JAX mirror's families,
``mobilenetv2*`` and ``efficientnetb*``, whose ops are all in
``TFJS_SAFE_OPS``. The RFCR ``concat`` and ``none`` fusions are refused
(``UNMIRRORED``).
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from yoloret_tpu_torch.configs import RunConfig
from yoloret_tpu_torch.data.annotations import load_classes
from yoloret_tpu_torch.nn import darknet, layers, legacy
from yoloret_tpu_torch.nn.detector import BACKBONES, YoloReT, build_detector
from yoloret_tpu_torch.nn.efficientnet import _TAP_STAGES
from yoloret_tpu_torch.nn.mobilenetv2 import _TAP_BLOCKS
from yoloret_tpu_torch.utils.checkpoint import load_params

_BN_EPS = 1e-3  # every ConvBN / DepthwiseConvBN of nn/layers.py

# The ops the mirror may emit. All are implemented by the tfjs runtime
# (its converter's op registry); tests hold exported graphs inside this set.
TFJS_SAFE_OPS = frozenset({
    "Placeholder", "Const", "Identity", "NoOp",
    "Conv2D", "DepthwiseConv2dNative", "BiasAdd",
    "Relu6", "Sigmoid", "Mul", "AddV2",
    "Mean", "MaxPool", "ResizeNearestNeighbor",
    "ConcatV2", "Reshape",
})

GRAPH_MODEL_KINDS = ("mobilenetv2", "efficientnet")
UNMIRRORED = ("the TensorFlow flavours export the weighted-sum RFCR only: the JAX package's "
              "flavours build the detector without its rfcr (they export a weighted-sum model "
              "whatever the config says), so a {} mirror would have no reference to be held "
              "against")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _fold(conv: layers.Conv2dSame, bn: layers.BatchNorm) -> Tuple[np.ndarray, np.ndarray]:
    """BN-folded (kernel in TF's layout, bias) as numpy float32: kernel
    * gamma / sqrt(var + eps), beta - mean * gamma / sqrt(var + eps)."""
    k = _np(conv.weight)
    k = k.transpose(2, 3, 0, 1) if conv.groups > 1 else k.transpose(2, 3, 1, 0)
    m = _np(bn.weight) / np.sqrt(_np(bn.running_var) + _BN_EPS)
    b = _np(bn.bias) - _np(bn.running_mean) * m
    if conv.groups > 1:
        return k * m[:, None], b
    return k * m, b


def check_mirrored(backbone: str, rfcr: str) -> None:
    """ValueError unless the mirror covers ``backbone`` with ``rfcr``:
    every backbone of the registry, with the weighted-sum RFCR where it
    has one (a full body has none, so its ``rfcr`` means nothing)."""
    if BACKBONES[backbone][0] != "fullbody" and rfcr != "weighted_sum":
        raise ValueError(f"rfcr={rfcr!r}: {UNMIRRORED.format(repr(rfcr))}")


def check_graph_model(backbone: str) -> None:
    """ValueError (the JAX package's message) unless the tfjs graph model
    covers ``backbone``: ``mobilenetv2*`` and ``efficientnetb*``."""
    if BACKBONES[backbone][0] not in GRAPH_MODEL_KINDS:
        raise ValueError(f"tfjs export covers the reference's released configs "
                         f"(mobilenetv2*/efficientnetb* backbones); got {backbone!r}")


class _TFMirror:
    """Walks a port ``YoloReT`` (nn/detector.py, nn/mobilenetv2.py,
    nn/efficientnet.py, nn/darknet.py, nn/legacy.py, nn/rfcr.py,
    nn/heads.py) and emits its inference forward in TF ops."""

    def __init__(self, tf, model: YoloReT):
        self.tf = tf
        self.model = model

    # -- primitive layers ----------------------------------------------------
    def _act(self, x, act):
        if act is layers.relu6:
            return self.tf.nn.relu6(x)
        if act is layers.swish:
            return x * self.tf.sigmoid(x)
        if act is layers.leaky:
            return self.tf.nn.leaky_relu(x, alpha=0.1)
        assert act is None, act
        return x

    def conv_bn(self, x, mod, *, name: str):
        """ConvBN / DepthwiseConvBN with the BN folded into a BiasAdd."""
        tf = self.tf
        conv = mod.conv if isinstance(mod, layers.ConvBN) else mod.dwconv
        s = conv.stride
        with tf.name_scope(name):
            k, b = _fold(conv, mod.bn)
            if conv.groups > 1:
                x = tf.nn.depthwise_conv2d(x, tf.constant(k), [1, s, s, 1], "SAME")
            else:
                x = tf.nn.conv2d(x, tf.constant(k), s, "SAME")
            x = tf.nn.bias_add(x, tf.constant(b))
            return self._act(x, mod.act)

    def conv(self, x, conv: layers.Conv2dSame, *, name: str):
        """A 1x1 conv, with its bias if it has one (the RFCR collect and
        head pred convs have none, the SE convs have one)."""
        tf = self.tf
        with tf.name_scope(name):
            x = tf.nn.conv2d(x, tf.constant(_np(conv.weight).transpose(2, 3, 1, 0)), 1, "SAME")
            if conv.bias is not None:
                x = tf.nn.bias_add(x, tf.constant(_np(conv.bias)))
            return x

    def maxpool(self, x, stride: int):
        return self.tf.nn.max_pool2d(x, stride, stride, "VALID")

    def upsample2x(self, x):
        h, w = int(x.shape[1]), int(x.shape[2])
        # nn/layers.py::upsample2x: nearest, no corner alignment
        return self.tf.compat.v1.image.resize_nearest_neighbor(
            x, [2 * h, 2 * w], align_corners=False, half_pixel_centers=False)

    def block(self, x, blk, *, name: str):
        """InvertedResidual (ReLU6, no SE) and MBConv (swish, SE): expand
        (if any), depthwise, SE (if any), project, residual."""
        tf = self.tf
        inputs = x
        if blk.expand is not None:
            x = self.conv_bn(x, blk.expand, name=f"{name}/expand")
        x = self.conv_bn(x, blk.depthwise, name=f"{name}/depthwise")
        se = getattr(blk, "se", None)
        if se is not None:
            with tf.name_scope(f"{name}/se"):
                g = tf.reduce_mean(x, [1, 2], keepdims=True)
                g = self.conv(g, se.reduce, name="reduce")
                g = g * tf.sigmoid(g)  # swish
                g = self.conv(g, se.excite, name="excite")
                x = x * tf.sigmoid(g)
        x = self.conv_bn(x, blk.project, name=f"{name}/project")
        return x + inputs if blk.residual else x

    def separable(self, x, mod, *, name: str):
        """SeparableConvBN: depthwise, then pointwise, each BN + ReLU6."""
        x = self.conv_bn(x, mod.depthwise, name=f"{name}/depthwise")
        return self.conv_bn(x, mod.pointwise, name=f"{name}/pointwise")

    # -- backbone ------------------------------------------------------------
    def backbone_feats(self, x) -> Dict[str, Any]:
        body = self.model.body
        feats: Dict[str, Any] = {}
        x = self.conv_bn(x, body.stem, name="body/stem")
        if self.model.kind == "darknet":
            for si, (repeats, _) in enumerate(darknet._STAGES):
                x = self.conv_bn(x, getattr(body, f"down_{si}"), name=f"body/down_{si}")
                for r in range(repeats):
                    bname = f"stage_{si}_block_{r}"
                    blk = getattr(body, bname)
                    y = self.conv_bn(x, blk.reduce, name=f"body/{bname}/reduce")
                    x = x + self.conv_bn(y, blk.expand, name=f"body/{bname}/expand")
                if si in darknet._TAPS:
                    feats[darknet._TAPS[si]] = x
            return feats
        if self.model.kind == "mobilenetv2":
            for block_id, bname in enumerate(body.block_names):
                x = self.block(x, getattr(body, bname), name=f"body/{bname}")
                if block_id in _TAP_BLOCKS:
                    feats[_TAP_BLOCKS[block_id]] = x
            return feats
        for si, names in body.stage_blocks:
            for bname in names:
                x = self.block(x, getattr(body, bname), name=f"body/{bname}")
            if si in _TAP_STAGES:
                feats[_TAP_STAGES[si]] = x
        return feats

    # -- RFCR (nn/rfcr.py) ---------------------------------------------------
    def rfcr(self, b1, b2, b3, b4):
        tf = self.tf
        r = self.model.rfcr
        collected = [self.upsample2x(self.conv(b1, r.collect_1, name="rfcr/collect_1")),
                     self.conv(b2, r.collect_2, name="rfcr/collect_2"),
                     self.maxpool(self.conv(b3, r.collect_3, name="rfcr/collect_3"), 2),
                     self.conv(b4, r.collect_4, name="rfcr/collect_4")]
        alpha = _np(r.fuse_weights.alpha)
        with tf.name_scope("rfcr/fuse_weights"):
            bc = tf.constant(alpha[0]) * collected[0]
            for i in range(1, 4):
                bc = bc + tf.constant(alpha[i]) * collected[i]
        bc = self.conv_bn(bc, r.fuse_conv.depthwise, name="rfcr/fuse_conv/depthwise")
        bc = self.conv_bn(bc, r.fuse_conv.pointwise, name="rfcr/fuse_conv/pointwise")
        return (tf.concat([b1, self.maxpool(bc, 2)], axis=-1), tf.concat([b2, bc], axis=-1),
                tf.concat([b3, self.upsample2x(bc)], axis=-1))

    # -- neck (nn/heads.py) --------------------------------------------------
    def head(self, x, name: str):
        h = getattr(self.model.neck, name)
        x = self.conv_bn(x, h.expand, name=f"neck/{name}/expand")
        x = self.block(x, h.mbconv, name=f"neck/{name}/mbconv")
        y = None if h.pred is None else self.conv(x, h.pred, name=f"neck/{name}/pred")
        return x, y

    def squeeze(self, x, name: str):
        return self.conv_bn(x, getattr(self.model.neck, name), name=f"neck/{name}")

    def neck(self, b1, b2, b3):
        tf = self.tf
        c1, _ = self.head(b1, "fpn_head_32")
        x = self.squeeze(c1, "fpn_squeeze_32")
        c2, _ = self.head(tf.concat([self.upsample2x(x), b2], axis=-1), "fpn_head_16")
        x = self.squeeze(c2, "fpn_squeeze_16")
        c3, _ = self.head(tf.concat([self.upsample2x(x), b3], axis=-1), "fpn_head_8")
        x, y3 = self.head(c3, "pan_head_8")
        x = self.squeeze(x, "pan_squeeze_8")
        x, y2 = self.head(tf.concat([self.maxpool(x, 2), c2], axis=-1), "pan_head_16")
        x = self.squeeze(x, "pan_squeeze_16")
        _, y1 = self.head(tf.concat([self.maxpool(x, 2), c1], axis=-1), "pan_head_32")
        return y1, y2, y3

    # -- the full legacy bodies (nn/legacy.py) --------------------------------
    def run(self, x, *names):
        """The body's submodules ``names`` in order: ConvBN and
        DepthwiseConvBN, and YOLO-Nano's EP and PEP and Yolo-Fastest's
        block, each with its residual."""
        for n in names:
            mod, name = getattr(self.model.body, n), f"body/{n}"
            if isinstance(mod, (layers.ConvBN, layers.DepthwiseConvBN)):
                x = self.conv_bn(x, mod, name=name)
                continue
            if isinstance(mod, legacy.EP):
                y = self.separable(x, mod.conv.sep, name=f"{name}/conv")
            elif isinstance(mod, legacy.PEP):
                y = self.conv_bn(x, mod.proj, name=f"{name}/proj")
                y = self.separable(y, mod.conv.sep, name=f"{name}/conv")
            else:
                assert isinstance(mod, legacy._FastestBlock), type(mod)
                y = self.conv_bn(x, mod.expand, name=f"{name}/expand")
                y = self.conv_bn(y, mod.depthwise, name=f"{name}/depthwise")
                y = self.conv_bn(y, mod.project, name=f"{name}/project")
            x = x + y if mod.residual else y
        return x

    def body_head(self, x, name: str):
        return self.conv(x, getattr(self.model.body, name), name=f"body/{name}")

    def fca(self, x):
        """FCA: global mean, the two bias-free dense layers as MatMul
        (ReLU6, then sigmoid), scale."""
        tf, fca = self.tf, self.model.body.fca
        with tf.name_scope("body/fca"):
            s = tf.reduce_mean(x, [1, 2])
            s = tf.nn.relu6(tf.matmul(s, tf.constant(_np(fca.reduce.weight).T)))
            s = tf.sigmoid(tf.matmul(s, tf.constant(_np(fca.expand.weight).T)))
            return x * tf.reshape(s, [-1, 1, 1, int(s.shape[-1])])

    def nano(self, x):
        """YoloNano.forward: (y1, y2, y3) before the split."""
        tf = self.tf
        x = self.run(x, "stem_a", "stem_b", "p1", "e1", "p2", "p3", "e2", "p4", "c_mid")
        out52 = self.run(self.fca(x), "p5", "p6", "p7")
        p8 = (f"p8_{i}" for i in range(len(self.model.body.p8_mids)))
        out26 = self.run(out52, "e3", *p8, "p9")
        out13 = self.run(out26, "e4", "p10", "c_down", "e5", "p11")
        x1 = self.run(out13, "n13_a")
        x = self.run(x1, "n13_b")
        x = self.run(tf.concat([self.upsample2x(x), out26], axis=-1), "n26_a", "n26_b")
        x2 = self.run(x, "n26_c")
        x = self.run(x2, "n26_d")
        x = self.run(tf.concat([self.upsample2x(x), out52], axis=-1), "n52_a", "n52_b",
                     "n52_c")
        return (self.body_head(self.run(x1, "n13_e"), "head_13"),
                self.body_head(self.run(x2, "n26_e"), "head_26"),
                self.body_head(x, "head_52"))

    def fastest(self, x):
        """YoloFastest.forward (plain or ``xl``): (y1, y2, y3) before the
        split."""
        x = self.run(x, "stem_conv", "stem_pw", "stem_dw", "stem_proj")
        routes = {}
        for step in self.model.body.steps:
            if step.startswith("route"):
                routes[step] = x
            else:
                x = self.run(x, step)
        x = self.run(x, "bridge")
        b1 = self.tf.concat([routes["route1"], self.upsample2x(x)], axis=-1)
        b1 = self.run(b1, "h16_a", "h16_dw1", "h16_b", "h16_dw2", "h16_c")
        b2 = self.run(x, "h32_dw1", "h32_a", "h32_dw2", "h32_b")
        return (self.body_head(b2, "head_32"), self.body_head(b1, "head_16"),
                self.body_head(routes["route2"], "head_8"))

    # -- full forward --------------------------------------------------------
    def forward(self, images):
        tf = self.tf
        m = self.model
        if m.kind == "fullbody":  # its own neck and heads (nn/detector.py)
            heads = (self.nano if isinstance(m.body, legacy.YoloNano) else self.fastest)(images)
        else:
            feats = self.backbone_feats(images)
            b4 = self.maxpool(feats["c2"], 4)
            heads = self.neck(*self.rfcr(feats["c5"], feats["c4"], feats["c3"], b4))

        def split(y, i):
            b, gh, gw = (int(d) for d in y.shape[:3])
            y = tf.reshape(y, [b, gh, gw, m.num_anchors, 5 + m.num_classes])
            return tf.identity(y, name=f"y{i}")

        return tuple(split(y, i) for i, y in enumerate(heads, start=1))


def tf_mirror(model: YoloReT, batch: int, input_hw: Tuple[int, int]):
    """tf.function ``raw(images)`` -> (y1, y2, y3) of ``model``'s weights
    (read on the CPU, inlined as graph constants), for ``images``
    [batch, H, W, 3] float32. ValueError for the RFCR ``concat`` and
    ``none`` fusions (``check_mirrored``)."""
    import tensorflow as tf

    check_mirrored(model.backbone, model.rfcr_fusion)
    h, w = input_hw
    return tf.function(_TFMirror(tf, model).forward,
                       input_signature=[tf.TensorSpec([batch, h, w, 3], tf.float32,
                                                      name="images")],
                       autograph=False)


def load_detector(cfg: RunConfig) -> YoloReT:
    """``cfg``'s float32 detector on the CPU: ``cfg.model`` (its EMA
    weights with ``cfg.use_ema``), else the seeded init of seed 0, as
    ``export_bundle`` builds it."""
    check_mirrored(cfg.backbone, cfg.rfcr)
    model = build_detector(cfg.backbone, num_classes=len(load_classes(cfg.classes_path)),
                           dtype=torch.float32, rfcr=cfg.rfcr, device="cpu")
    if cfg.model:
        model.load_state_dict(load_params(cfg.model, cfg.use_ema), strict=True)
    return model.eval()


def build_tf_mirror(cfg: RunConfig, batch: int = 1):
    """(tf.function raw(images) -> (y1, y2, y3), the port model whose
    weights it holds) for ``cfg``. ValueError for the RFCR ``concat`` and
    ``none`` fusions (``check_mirrored``)."""
    model = load_detector(cfg)
    return tf_mirror(model, batch, cfg.input_size), model


def write_graph_model(concrete_fn, out_dir: str, shard_bytes: int = 4 * 1024 * 1024) -> str:
    """Serialize a frozen concrete function to the tfjs graph-model
    layout: model.json + group1-shardNofM.bin weight shards."""
    import tensorflow as tf
    from google.protobuf import json_format
    from tensorflow.python.framework import tensor_util

    from yoloret_tpu_torch import __version__

    if concrete_fn.captured_inputs:
        raise ValueError("graph has captured inputs: weights must be inlined Consts")
    graph_def = concrete_fn.graph.as_graph_def()

    blob = bytearray()
    manifest: List[Dict[str, Any]] = []
    for node in graph_def.node:
        if node.op != "Const":
            continue
        t = node.attr["value"].tensor
        arr = np.asarray(tensor_util.MakeNdarray(t))
        dtype = {"float32": "float32", "int32": "int32", "int64": "int32",
                 "bool": "bool"}.get(arr.dtype.name)
        if dtype is None:
            raise ValueError(f"unsupported Const dtype {arr.dtype} at node {node.name}")
        if arr.dtype.name == "int64":  # tfjs has no int64; its converter narrows
            if arr.size and (np.abs(arr) > 2**31 - 1).any():
                raise ValueError(f"int64 Const {node.name} overflows int32")
            arr = arr.astype(np.int32)
            t.dtype = tf.int32.as_datatype_enum
        manifest.append({"name": node.name, "shape": [int(d) for d in arr.shape],
                         "dtype": dtype})
        blob += arr.tobytes()
        # keep dtype and shape, drop the content: the tfjs executor
        # resolves Const nodes from the weight map
        t.ClearField("tensor_content")
        for field in ("half_val", "float_val", "double_val", "int_val", "string_val",
                      "int64_val", "bool_val", "uint32_val", "uint64_val"):
            t.ClearField(field)

    os.makedirs(out_dir, exist_ok=True)
    n_shards = max(1, math.ceil(len(blob) / shard_bytes))
    paths = [f"group1-shard{i + 1}of{n_shards}.bin" for i in range(n_shards)]
    for i, path in enumerate(paths):
        with open(os.path.join(out_dir, path), "wb") as f:
            f.write(bytes(blob[i * shard_bytes:(i + 1) * shard_bytes]))

    def _sig(tensors, names=None):
        out = {}
        for i, tens in enumerate(tensors):
            key = names[i] if names else tens.name.split(":")[0]
            out[key] = {"name": tens.name, "dtype": "DT_FLOAT",
                        "tensorShape": {"dim": [{"size": str(int(d))} for d in tens.shape]}}
        return out

    model_json = {
        "format": "graph-model",
        "generatedBy": f"tensorflow {tf.__version__}",
        "convertedBy": f"yoloret_tpu_torch {__version__}",
        "signature": {
            "inputs": _sig(concrete_fn.inputs),
            "outputs": _sig(concrete_fn.outputs,
                            [f"y{i + 1}" for i in range(len(concrete_fn.outputs))]),
        },
        "modelTopology": json_format.MessageToDict(graph_def),
        "weightsManifest": [{"paths": paths, "weights": manifest}],
    }
    with open(os.path.join(out_dir, "model.json"), "w") as f:
        json.dump(model_json, f)
    return out_dir


def read_graph_model(model_dir: str):
    """Load a graph-model artifact back into an executable TF graph, as
    the JS runtime would: (tf.Graph, signature dict)."""
    import tensorflow as tf
    from google.protobuf import json_format
    from tensorflow.python.framework import tensor_util

    with open(os.path.join(model_dir, "model.json")) as f:
        meta = json.load(f)
    group = meta["weightsManifest"][0]
    blob = b""
    for p in group["paths"]:
        with open(os.path.join(model_dir, p), "rb") as f:
            blob += f.read()
    np_dtypes = {"float32": np.float32, "int32": np.int32, "bool": np.bool_}
    weights: Dict[str, np.ndarray] = {}
    off = 0
    for w in group["weights"]:
        dt = np_dtypes[w["dtype"]]
        count = int(np.prod(w["shape"])) if w["shape"] else 1
        nbytes = count * np.dtype(dt).itemsize
        weights[w["name"]] = np.frombuffer(blob[off:off + nbytes], dt).reshape(w["shape"])
        off += nbytes
    if off != len(blob):
        raise ValueError(f"weight shards hold {len(blob)} bytes but the manifest consumes {off}")

    graph_def = json_format.ParseDict(meta["modelTopology"], tf.compat.v1.GraphDef())
    for node in graph_def.node:
        if node.op == "Const" and node.name in weights:
            node.attr["value"].tensor.CopyFrom(tensor_util.make_tensor_proto(weights[node.name]))
    graph = tf.Graph()
    with graph.as_default():
        tf.graph_util.import_graph_def(graph_def, name="")
    return graph, meta["signature"]


def export_tfjs_graph_model(cfg: RunConfig, out_dir: str, batch: int = 1,
                            model: YoloReT = None) -> str:
    """cfg -> tfjs graph-model directory (the reference's TFJS mode,
    code/yolo.py:333-348, without the external converter); ``model``: the
    detector to export, else ``load_detector(cfg)``'s. ValueError, before
    anything is built, outside ``mobilenetv2*`` / ``efficientnetb*``
    (``check_graph_model``)."""
    check_graph_model(cfg.backbone)
    raw = build_tf_mirror(cfg, batch)[0] if model is None else tf_mirror(model, batch,
                                                                          cfg.input_size)
    return write_graph_model(raw.get_concrete_function(), out_dir)
