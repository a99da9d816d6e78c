"""ImageNet backbone weights from Keras H5 files. Port of
``yoloret_tpu/utils/keras_import.py``.

The reference initializes backbones from the public Keras-applications /
qubvel H5 releases and copies them layer by layer into the detector
(truncated transfer learning, reference: code/yolo3/model.py:180-224;
EfficientNet weight table at code/yolo3/efficientnet.py:35-108). This
module writes those H5 weights straight into the port's state dict:

  * MobileNetV2: by layer NAME (Conv1 / block_N_{expand,depthwise,
    project}[_BN] / Conv_1), robust to partial files (no_top).
  * EfficientNet: by ORDER -- qubvel layer names are positional
    (conv2d_N / batch_normalization_N), but their build order is the
    detector's definition order (stem, [expand], depthwise, SE reduce/
    excite, project per block, then top).

Layouts: Keras conv kernels are HWIO, the port's OIHW; Keras depthwise
kernels are (kh, kw, ch, 1), the port's [ch, 1, kh, kw]; a BN tuple
(gamma, beta, moving_mean, moving_variance) becomes ``weight``, ``bias``,
``running_mean``, ``running_var``. Reading needs ``h5py``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

import numpy as np
import torch


def _load_h5_weights(path: str) -> Dict[str, np.ndarray]:
    """Flatten an H5 weight file into {'layer/weight': array} with ':0'
    suffixes stripped; supports both keras-applications layouts."""
    import h5py

    out: Dict[str, np.ndarray] = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            key = name
            if key.endswith(":0"):
                key = key[:-2]
            parts = [p for p in key.split("/") if p]
            # keras nests layer/layer/weight; drop the duplicate
            if len(parts) >= 2 and parts[0] == parts[1]:
                parts = parts[1:]
            if parts and parts[0] == "model_weights":
                parts = parts[1:]
            out["/".join(parts[-2:])] = np.asarray(obj)

    with h5py.File(path, "r") as f:
        f.visititems(visit)
    return out


def _conv(k: np.ndarray) -> np.ndarray:
    """Keras HWIO -> OIHW."""
    return np.ascontiguousarray(k.transpose(3, 2, 0, 1))


def _dw(k: np.ndarray) -> np.ndarray:
    """Keras depthwise (kh, kw, ch, 1) -> [ch, 1, kh, kw]."""
    return np.ascontiguousarray(k.transpose(2, 3, 0, 1))


def _bn(out: Dict[str, np.ndarray], w: Mapping[str, np.ndarray], keras_name: str,
        module: str) -> None:
    for keras_leaf, leaf in (("gamma", "weight"), ("beta", "bias"),
                             ("moving_mean", "running_mean"),
                             ("moving_variance", "running_var")):
        out[f"{module}.{leaf}"] = w[f"{keras_name}/{keras_leaf}"]


def import_mobilenetv2_h5(path: str, expected_blocks: int = 16) -> Dict[str, np.ndarray]:
    """The backbone weights of a Keras MobileNetV2 H5 file, by layer
    name, as {name in the detector's ``body``: array in the port's
    layout} (e.g. ``block_1.expand.conv.weight``)."""
    w = _load_h5_weights(path)
    out: Dict[str, np.ndarray] = {}

    def conv(keras_name, module, depthwise=False):
        key = f"{keras_name}/depthwise_kernel" if depthwise else f"{keras_name}/kernel"
        if key not in w:
            return False
        out[f"{module}.weight"] = _dw(w[key]) if depthwise else _conv(w[key])
        return True

    def bn(keras_name, module):
        if f"{keras_name}/gamma" not in w:
            return False
        _bn(out, w, keras_name, module)
        return True

    if not conv("Conv1", "stem.conv"):
        raise ValueError(f"{path} is not a Keras MobileNetV2 H5 (no Conv1/kernel)")
    bn("bn_Conv1", "stem.bn")
    # block 0 (Keras "expanded_conv", no expand conv)
    conv("expanded_conv_depthwise", "block_0.depthwise.dwconv", depthwise=True)
    bn("expanded_conv_depthwise_BN", "block_0.depthwise.bn")
    conv("expanded_conv_project", "block_0.project.conv")
    bn("expanded_conv_project_BN", "block_0.project.bn")
    for n in range(1, expected_blocks + 1):
        if not conv(f"block_{n}_expand", f"block_{n}.expand.conv"):
            break
        bn(f"block_{n}_expand_BN", f"block_{n}.expand.bn")
        conv(f"block_{n}_depthwise", f"block_{n}.depthwise.dwconv", depthwise=True)
        bn(f"block_{n}_depthwise_BN", f"block_{n}.depthwise.bn")
        conv(f"block_{n}_project", f"block_{n}.project.conv")
        bn(f"block_{n}_project_BN", f"block_{n}.project.bn")
    if "Conv_1/kernel" in w:
        conv("Conv_1", "top.conv")
        bn("Conv_1_bn", "top.bn")
    return out


def import_efficientnet_h5(path: str, body_names: Iterable[str]) -> Dict[str, np.ndarray]:
    """Order-based import of a qubvel EfficientNet H5 file into the
    detector's ``body``, whose state-dict names ``body_names`` (relative
    to the body, e.g. ``stage_0_block_0.se.reduce.weight``) give the
    blocks and which of them have an expand conv and squeeze-excite."""
    w = _load_h5_weights(path)
    names = list(body_names)

    def indexed(prefix):
        """qubvel positional layer names ``prefix``, ``prefix_1``, ... sorted."""
        found = {}
        for k in w:
            layer = k.split("/")[0]
            if layer == prefix:
                found.setdefault(0, layer)
            elif layer.startswith(prefix + "_"):
                suffix = layer[len(prefix) + 1:]
                if suffix.isdigit():
                    found.setdefault(int(suffix), layer)
        return [found[i] for i in sorted(found)]

    layers = {"conv": indexed("conv2d"), "dw": indexed("depthwise_conv2d"),
              "bn": indexed("batch_normalization")}
    taken = {"conv": 0, "dw": 0, "bn": 0}
    out: Dict[str, np.ndarray] = {}

    def take(kind):
        i = taken[kind]
        if i >= len(layers[kind]):
            raise ValueError(f"{path}: the detector needs more {kind} layers than the file's "
                             f"{len(layers[kind])}")
        taken[kind] += 1
        return layers[kind][i]

    def take_conv(module, bias=False):
        name = take("conv")
        out[f"{module}.weight"] = _conv(w[f"{name}/kernel"])
        if bias:
            out[f"{module}.bias"] = w[f"{name}/bias"]

    def take_bn(module):
        _bn(out, w, take("bn"), module)

    def has(block, part):
        return any(n.startswith(f"{block}.{part}.") for n in names)

    take_conv("stem.conv")
    take_bn("stem.bn")
    blocks = sorted({n.split(".")[0] for n in names if n.startswith("stage_")},
                    key=lambda s: (int(s.split("_")[1]), int(s.split("_")[3])))
    for block in blocks:
        if has(block, "expand"):
            take_conv(f"{block}.expand.conv")
            take_bn(f"{block}.expand.bn")
        out[f"{block}.depthwise.dwconv.weight"] = _dw(w[f"{take('dw')}/depthwise_kernel"])
        take_bn(f"{block}.depthwise.bn")
        if has(block, "se"):
            take_conv(f"{block}.se.reduce", bias=True)
            take_conv(f"{block}.se.excite", bias=True)
        take_conv(f"{block}.project.conv")
        take_bn(f"{block}.project.bn")
    if taken["conv"] < len(layers["conv"]) and has("top", "conv"):
        take_conv("top.conv")
        take_bn("top.bn")
    return out


def load_backbone_weights(state_dict: Mapping[str, torch.Tensor], h5_path: str,
                          backbone: str) -> Dict[str, torch.Tensor]:
    """A copy of a detector's state dict with its backbone (``body.*``)
    replaced by the ImageNet weights of ``h5_path``. Weights the detector
    does not build (the Keras ``top``) are skipped; a shape that differs
    from the model's raises ``ValueError``."""
    prefix = "body."
    body_names = [k[len(prefix):] for k in state_dict if k.startswith(prefix)]
    if backbone.startswith("mobilenetv2"):
        weights = import_mobilenetv2_h5(h5_path)
    elif backbone.startswith("efficientnet"):
        weights = import_efficientnet_h5(h5_path, body_names)
    else:
        raise ValueError(f"no H5 importer for backbone {backbone!r}")
    out = {k: v.clone() for k, v in state_dict.items()}
    for name, arr in weights.items():
        key = prefix + name
        if key not in out:
            continue  # e.g. 'top', not built in detector mode
        have = out[key]
        if tuple(have.shape) != arr.shape:
            raise ValueError(f"shape mismatch at {key}: h5 {arr.shape} (as the port lays it "
                             f"out) vs model {tuple(have.shape)}")
        out[key] = torch.from_numpy(np.array(arr)).to(have.dtype)
    return out
