"""Device selection for the port's entry points: the card by default,
the CPU only when the caller asks for it, never a quiet fallback."""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``torch.device`` for ``device`` (``None`` means ``"cuda"``).

    Raises ``RuntimeError`` when a CUDA device is asked for (the
    default) and none is available: a caller who wants the CPU passes
    ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: to a CUDA device pinned and
    asynchronous (the copy overlaps the stream's queued work)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)
