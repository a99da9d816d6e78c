"""Weight bridge from the JAX package's Flax variables to the port.

``from_flax`` takes the ``{'params', 'batch_stats'}`` tree as numpy
arrays (``jax.device_get(variables)``) and returns the state dict of
``nn.detector.YoloReT``. Module paths are the same in both trees; only
the leaves are renamed and, for convolutions, relaid out:

  * conv kernels HWIO -> OIHW; depthwise ``[kh, kw, 1, C]`` -> ``[C, 1, kh, kw]``
    (one transpose, ``(3, 2, 0, 1)``, does both);
  * ``Dense`` kernels ``[in, out]`` -> ``nn.Linear`` weights ``[out, in]``;
  * BatchNorm ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
    ``running_mean``/``running_var``;
  * conv ``bias`` and the RFCR ``fuse_weights/alpha`` carry over as they are.

``int8_from_flax`` carries the JAX package's quantized int8 tree across
the same way, so that both int8 forwards can run from one set of codes.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias", "alpha": "alpha"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _walk(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_flax(variables: Mapping[str, Any], model: Optional[nn.Module] = None
              ) -> Dict[str, torch.Tensor]:
    """Flax variables -> port state dict (float32 CPU tensors).

    Raises ``KeyError`` on a leaf name it does not know, and, when
    ``model`` is given, on any key that ``model.state_dict()`` lacks or
    that the tree does not provide."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unknown variable collections {sorted(unknown)}")
    out: Dict[str, torch.Tensor] = {}
    for coll, leaves in (("params", _PARAM_LEAVES), ("batch_stats", _STAT_LEAVES)):
        for path, value in _walk(variables.get(coll, {})):
            *mods, leaf = path
            if leaf not in leaves:
                raise KeyError(f"unknown {coll} leaf {'/'.join(path)!r}")
            arr = np.array(value, np.float32)  # a copy: jax arrays are read-only
            if leaf == "kernel":
                if arr.ndim not in (2, 4):
                    raise KeyError(f"kernel {'/'.join(path)!r} is neither a 4-D conv nor a "
                                   f"2-D dense kernel: {arr.shape}")
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            out[".".join(mods + [leaves[leaf]])] = torch.from_numpy(np.ascontiguousarray(arr))
    if model is not None:
        want = set(model.state_dict())
        missing, extra = sorted(want - set(out)), sorted(set(out) - want)
        if missing or extra:
            raise KeyError(f"state dict mismatch: missing {missing[:8]}, unknown {extra[:8]}")
    return out


def int8_from_flax(qp: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX package's int8 parameter tree (``yoloret_tpu/nn/
    int8_infer.py::quantize_*``, leaves as numpy arrays) -> the port's
    (``nn/int8_infer.py``), CPU tensors:

      * the stem kernel HWIO -> OIHW, float32;
      * 1x1 int8 kernels ``[1, 1, Cin, Cout]`` -> ``[Cin, Cout]`` int8,
        column-major (``int_mm``'s weight layout);
      * depthwise int8 kernels ``[k, k, 1, C]`` -> ``[C, 1, k, k]``;
      * squeeze-excite kernels ``[1, 1, Cin, Cout]`` -> ``[Cin, Cout]``
        float32;
      * dequant factors and biases -> float32 tensors; scales stay Python
        floats, strides ints, flags bools, ``act`` its string, ``taps``
        {block index: key}."""

    def leaf(name, v):
        if not isinstance(v, (np.ndarray, np.generic)) and not hasattr(v, "__array__"):
            return v
        a = np.asarray(v)
        if a.ndim == 0:
            return a.item()
        if name in ("kernel", "wd_q"):
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 4:  # we_q, wp_q, se_*_w: [1, 1, Cin, Cout]
            a = a[0, 0]
        t = torch.from_numpy(np.array(a, order="C"))  # a copy: jax arrays are read-only
        if t.dtype == torch.int8:
            return t.t().contiguous().t() if t.dim() == 2 else t
        return t.float()

    out: Dict[str, Any] = {
        "stem": {k: leaf(k, v) for k, v in qp["stem"].items()},
        "blocks": [{k: leaf(k, v) for k, v in blk.items()} for blk in qp["blocks"]],
    }
    if "taps" in qp:
        out["taps"] = {int(k): str(v) for k, v in qp["taps"].items()}
    return out
