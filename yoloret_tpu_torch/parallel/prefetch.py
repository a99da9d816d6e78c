"""Device-side input double buffering. Port of
``yoloret_tpu/parallel/prefetch.py`` (reference: code/yolo3/data.py:133,
``prefetch(AUTOTUNE)``).

``device_prefetch`` keeps ``size`` batches already on the device ahead
of the consumer. On CUDA each host leaf goes through a pinned buffer
and is copied on a side stream; the consumer's stream waits on the
copy's event before the batch is handed over, so the copy of batch n+1
overlaps the compute of batch n. Leaves already on the device pass as
they are (the port's ``Dataset`` finalizes its batches on the device:
there the wrapper only reads ahead, enqueuing batch n+1's augmentation
before step n). Host scalars (``n_valid``) stay on the host, as in JAX.
"""

from __future__ import annotations

import collections
from typing import Any, Iterator

import numpy as np
import torch

from yoloret_tpu_torch.device import DeviceLike, resolve_device
from yoloret_tpu_torch.parallel.mesh import rank, world


def _rows(x: Any, lo: int, hi: int) -> Any:
    if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim > 0:
        return x[lo:hi]
    return x


def device_prefetch(it: Iterator[dict], device: DeviceLike = "cuda", size: int = 2,
                    local_data: bool = False) -> Iterator[dict]:
    """Yield the batches (dicts) of ``it`` with up to ``size`` already on
    ``device``.

    ``local_data=True``: each leaf holds only this rank's rows already (a
    rank-sharded ``Dataset`` stream). ``local_data=False``: each leaf
    holds the global batch, and in a process group of n ranks each rank
    keeps its n-th of the rows, in order (the JAX package's data-sharded
    ``device_put``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    n, r = world(), rank()

    def put(batch: dict):
        if not local_data and n > 1:
            b = next(v.shape[0] for v in batch.values()
                     if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim > 0)
            if b % n:
                raise ValueError(f"a batch of {b} rows does not split over {n} ranks")
            k = b // n
            batch = {key: _rows(v, r * k, (r + 1) * k) for key, v in batch.items()}
        if stream is None:
            return {k: torch.as_tensor(v).to(dev) if isinstance(v, (np.ndarray, torch.Tensor))
                    and v.ndim > 0 else v for k, v in batch.items()}, None
        out = {}
        with torch.cuda.stream(stream):
            for k, v in batch.items():
                if isinstance(v, np.ndarray) and v.ndim > 0:
                    v = torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, torch.Tensor) and v.ndim > 0 and v.device != dev:
                    if v.device.type == "cpu":
                        v = v.pin_memory()
                    v = v.to(dev, non_blocking=True)
                out[k] = v
        event = torch.cuda.Event()
        event.record(stream)
        return out, event

    def hand_over(item):
        batch, event = item
        if event is not None:
            current = torch.cuda.current_stream(dev)
            current.wait_event(event)
            for v in batch.values():
                if isinstance(v, torch.Tensor) and v.device == dev:
                    v.record_stream(current)
        return batch

    buf: collections.deque = collections.deque()
    for batch in it:
        buf.append(put(batch))
        if len(buf) > size:
            yield hand_over(buf.popleft())
    while buf:
        yield hand_over(buf.popleft())
