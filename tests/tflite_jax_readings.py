"""Prints the readings that ``tests/test_torch_tf_export_legacy.py``
holds the port's Yolo-Fastest TFLITE artifacts against: each head's
relative RMS distance from the float program's, and the dynamic-range
slate's largest score and box distances at score threshold 0.6, for the
port's and the JAX package's TFLITE with ``--quantize``, made from the
test's weights, image and calibration JPEGs; and the same for the port's
dynamic-range model with its BatchNorm left unfolded (the conv of the raw
kernel, then the scale and shift), which tests whether folding moves the
quantization. Not a test (about a minute on a CPU, most of it the JAX
package's two ``jax2tf`` conversions):

    JAX_PLATFORMS=cpu python tests/tflite_jax_readings.py
"""

import os
import pathlib
import sys
import tempfile
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_torch_tf_export_legacy as legacy  # noqa: E402
from yoloret_tpu_torch.export import tfjs  # noqa: E402
from yoloret_tpu_torch.export.export import export_tf_flavor  # noqa: E402
from yoloret_tpu_torch.nn import layers  # noqa: E402
from yoloret_tpu.configs import RunConfig as JaxRunConfig  # noqa: E402
from yoloret_tpu.export.export import export_tf_flavor as jax_export_tf_flavor  # noqa: E402
from yoloret_tpu.utils.checkpoint import save_params as jax_save_params  # noqa: E402


def slate_distances(p, path):
    """The largest score and box distances of a dynamic-range model's
    kept detections from the float program's."""
    hw = np.full((1, 2), float(legacy.PROGRAM_SIZE), np.float32)
    _, outs = legacy.run_tflite(path, p.images, hw)
    n = len(legacy.CLASSES) * 20
    by = {(np.dtype(dt).name, shape): t for dt, shape, t in outs}
    want = legacy.port_slate(p, p.images, hw, legacy.TFLITE_SCORE)
    m = want[3][0]
    return (float(np.abs(by[("float32", (n,))][0][m] - want[1][0][m]).max()),
            float(np.abs(by[("float32", (n, 4))][0][m] - want[0][0][m]).max()))


def unfolded_conv_bn(self, x, mod, *, name: str):
    """``_TFMirror.conv_bn`` with the BatchNorm as a multiply and an add
    after the conv of the raw kernel."""
    tf = self.tf
    conv = mod.conv if isinstance(mod, layers.ConvBN) else mod.dwconv
    s, bn = conv.stride, mod.bn
    k = tfjs._np(conv.weight)
    k = k.transpose(2, 3, 0, 1) if conv.groups > 1 else k.transpose(2, 3, 1, 0)
    m = tfjs._np(bn.weight) / np.sqrt(tfjs._np(bn.running_var) + tfjs._BN_EPS)
    with tf.name_scope(name):
        if conv.groups > 1:
            x = tf.nn.depthwise_conv2d(x, tf.constant(k), [1, s, s, 1], "SAME")
        else:
            x = tf.nn.conv2d(x, tf.constant(k), s, "SAME")
        x = x * tf.constant(m) + tf.constant(tfjs._np(bn.bias) - tfjs._np(bn.running_mean) * m)
        return self._act(x, mod.act)


def readings(root: pathlib.Path) -> None:
    p = legacy.fastest.__wrapped__(types.SimpleNamespace(mktemp=lambda name: root))
    port = legacy.tflite.__wrapped__(p)
    jax_save_params(str(root / "jax_ckpt"), p.variables)
    cfg = JaxRunConfig(backbone="yolo_fastest",
                       input_size=(legacy.PROGRAM_SIZE, legacy.PROGRAM_SIZE),
                       classes_path=p.cfg.classes_path, anchors_path=p.cfg.anchors_path,
                       model=str(root / "jax_ckpt"), score_threshold=legacy.TFLITE_SCORE,
                       quantize=True, quantize_samples=3,
                       train_dataset=legacy._calibration_list(p))
    jax = jax_export_tf_flavor(cfg, str(root / "jax_tfl"), "tflite")
    for name, out in (("port", port), ("jax", jax)):
        dyn = os.path.join(out, "model.tflite")
        print(f"{name} dynamic-range heads (/32, /16, /8):",
              [round(d, 6) for d in legacy.pipeline_head_distances(p, dyn)])
        print(f"{name} dynamic-range slate (score, box px):", slate_distances(p, dyn))
        print(f"{name} full-int8 heads (/32, /16, /8):",
              [round(d, 6) for d in legacy.int8_head_distances(
                  p, os.path.join(out, "model_int8.tflite"))])
    tfjs._TFMirror.conv_bn = unfolded_conv_bn
    cfg = p.cfg.replace(score_threshold=legacy.TFLITE_SCORE)
    dyn = os.path.join(export_tf_flavor(cfg, str(root / "unfolded"), "tflite"), "model.tflite")
    print("port unfolded dynamic-range heads (/32, /16, /8):",
          [round(d, 6) for d in legacy.pipeline_head_distances(p, dyn)])
    print("port unfolded dynamic-range slate (score, box px):", slate_distances(p, dyn))


if __name__ == "__main__":
    with tempfile.TemporaryDirectory(prefix="tflite_readings_") as tmp:
        readings(pathlib.Path(tmp))
