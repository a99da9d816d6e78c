"""Truncated transfer learning as frozen/trainable labels by parameter
name. Port of ``yoloret_tpu/train/freeze.py``.

The JAX package keeps one parameter tree and wraps the optimizer with
``optax.multi_transform``: frozen leaves get ``set_to_zero`` updates and
no optimizer state. Here the labels pick the parameters the optimizer
holds (``train/step.py``); a frozen parameter also stops taking
gradients. Module paths are the same in both packages
(``body.block_3.expand.conv.weight`` here, ``body/block_3/expand/conv/
kernel`` there), so "truncate after block k" is the same name
predicate: MobileNetV2 blocks are ``block_0..block_16`` and EfficientNet
blocks ``stage_S_block_R``.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Optional

TRAINABLE = "trainable"
FROZEN = "frozen"

_MNV2_BLOCK = re.compile(r"^block_(\d+)$")
_EFFNET_BLOCK = re.compile(r"^stage_(\d+)_block_(\d+)$")


def _block_depth(name: str) -> Optional[float]:
    """Depth key of a backbone submodule name: the stem is -1, ``top``
    infinity; None for a name that is not depth-ordered."""
    if name == "stem":
        return -1.0
    m = _MNV2_BLOCK.match(name)
    if m:
        return float(m.group(1))
    m = _EFFNET_BLOCK.match(name)
    if m:
        return float(m.group(1)) * 100 + float(m.group(2))
    if name == "top":
        return float("inf")
    return None


def backbone_freeze_mask(names: Iterable[str], body_key: str = "body",
                         upto_block: Optional[float] = None) -> Dict[str, str]:
    """{parameter name: FROZEN or TRAINABLE}: FROZEN for the backbone's
    parameters (``upto_block`` None, the reference's configs), or only
    for the stem and the blocks of depth key <= ``upto_block`` (the
    truncation study); TRAINABLE elsewhere."""
    labels = {}
    for name in names:
        path = name.split(".")
        label = TRAINABLE
        if path[0] == body_key:
            if upto_block is None:
                label = FROZEN
            else:
                depth = _block_depth(path[1]) if len(path) > 1 else None
                if depth is not None and depth <= upto_block:
                    label = FROZEN
        labels[name] = label
    return labels

