"""Device selection for the port's entry points: the card by default,
the CPU only when the caller asks for it, never a quiet fallback."""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Union

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


@contextlib.contextmanager
def reproducible(device: DeviceLike = "cuda") -> Iterator[None]:
    """On a CUDA device, for the duration: float32 convolutions and
    products in float32 (cuDNN's and cuBLAS's TF32 off), and deterministic
    kernels (PyTorch's deterministic algorithms, cuDNN's deterministic
    convolutions, cuBLAS with a fixed workspace). A float32 training run
    then computes in float32 and gives the same numbers every time on one
    kind of card and software, so that a learning check's result depends
    on the code, not on the order of atomic additions in the backward
    pass or on TF32's 10-bit products (on one H100 the self-check's mAP
    moved across its threshold with either: PERF.md, section 6). The
    CPU's kernels are float32 and deterministic already: there it changes
    nothing. ``CUBLAS_WORKSPACE_CONFIG`` is set when unset; cuBLAS takes
    it at its first use in the process."""
    if torch.device("cuda" if device is None else device).type != "cuda":
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled(),
              cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32)
    torch.use_deterministic_algorithms(True)
    cudnn.deterministic, cudnn.benchmark = True, False
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = before[2:5]
        matmul.allow_tf32 = before[5]


def on_device(device: torch.device):
    """A context in which ``device`` is the current CUDA device, as a
    launch through the kernels' C interface needs (its stream belongs to
    that device); nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
