"""Post-training int8 weight quantization of a weight file. Port of
``yoloret_tpu/export/quantize.py`` (``quantize_tree``,
``dequantize_tree``) onto the port's state dict.

Symmetric per-output-channel int8 of every conv / depthwise / dense
weight (~4x smaller weight file), dequantized back to float32 at load.
BatchNorm, biases and the RFCR fusion weights stay float32. The JAX
package reduces over every axis but the last (HWIO, [in, out]); the
port's weights are OIHW, depthwise [C, 1, kh, kw] and Linear [out, in]
(``weights.py``), so the output channel is axis 0 here. The arithmetic
is the JAX package's, in numpy float32 (the division, then rounding half
to even, then the clip), so the codes and scales are its bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

# The BatchNorm running statistics: the JAX package's ``batch_stats``,
# which it stores beside the quantized parameters and counts nowhere.
_STATS = ("running_mean", "running_var")


def quantize_state_dict(state: Mapping[str, torch.Tensor], min_size: int = 128
                        ) -> Tuple[Dict[str, Any], Dict[str, int]]:
    """Quantize every weight of ``state`` whose Flax counterpart is a
    ``kernel`` leaf with >= ``min_size`` elements (a ``.weight`` of two or
    more dimensions: conv, depthwise, dense).

    Returns (the state dict with ``{"q": int8, "scale": float32 [out]}``
    in place of those weights, stats ``quantized``, ``kept``,
    ``bytes_fp``, ``bytes_q`` over the parameters, as ``quantize_tree``
    counts them)."""
    stats = {"quantized": 0, "kept": 0, "bytes_fp": 0, "bytes_q": 0}
    out: Dict[str, Any] = {}
    for name, t in state.items():
        if name.rsplit(".", 1)[-1] in _STATS:
            out[name] = t
            continue
        arr = t.detach().cpu().numpy()
        stats["bytes_fp"] += arr.nbytes
        if name.endswith(".weight") and arr.size >= min_size and arr.ndim >= 2:
            flat = arr.reshape(arr.shape[0], -1)
            scale = np.maximum(np.abs(flat).max(axis=1), 1e-8) / 127.0
            bcast = scale.reshape((-1,) + (1,) * (arr.ndim - 1))
            q = np.clip(np.round(arr / bcast), -127, 127).astype(np.int8)
            scale = scale.astype(np.float32)
            stats["quantized"] += 1
            stats["bytes_q"] += q.nbytes + scale.nbytes
            out[name] = {"q": torch.from_numpy(q), "scale": torch.from_numpy(scale)}
        else:
            stats["kept"] += 1
            stats["bytes_q"] += arr.nbytes
            out[name] = t
    return out, stats


def dequantize_state_dict(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_state_dict`: float32 ``q * scale`` per
    output channel in place of each quantized weight."""
    out = {}
    for name, v in state.items():
        if isinstance(v, Mapping):
            q = v["q"]
            v = q.float() * v["scale"].float().reshape((-1,) + (1,) * (q.dim() - 1))
        out[name] = v
    return out
