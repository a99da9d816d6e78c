"""Data parallelism on ``torch.distributed``. Port of
``yoloret_tpu/parallel/mesh.py`` (reference: code/train.py:48-56,
code/yolo3/train.py:55-75, the ``tf.distribute`` strategies).

The JAX package has one program over a ``(data, model)`` device mesh and
lets XLA insert the collectives. The port follows PyTorch's idiom:

  * **Training is multi-process**: one process a device, in a process
    group (NCCL on CUDA, gloo on the CPU or where ranks share a card).
    The step all-reduces the BatchNorm statistics and the gradients
    itself (``nn/layers.py``, ``train/step.py``). ``init_distributed``
    joins a group from ``torchrun``'s environment (the counterpart of
    ``jax.distributed.initialize()``); ``spawn`` starts one worker a
    device of a mesh on this host.
  * **Evaluation and serving are single-process**: one process drives
    the mesh's devices, each holding its own replica of the weights
    (``replicate``), and splits each batch in order (``shard_batch``);
    ``infer/predictor.py`` is the user.

A ``Mesh`` may name one device several times (``make_mesh(["cpu"] *
8)``, ``make_mesh(["cuda:0", "cuda:0"])``), the counterpart of the JAX
tests' virtual CPU devices: each entry is a replica or a rank of its
own. The ``model`` axis splits each image's height (spatial sharding,
``parallel/spatial.py``): data shard i runs on its model group,
``devices[i * model:(i + 1) * model]``, row-major as the JAX mesh; the
group's first device (``data_devices``) takes the shard's input and its
outputs.

With no process group there is no collective: that is the one-device
program. A group of any size, 1 included, runs every collective. Each
rendezvous and collective has the group's timeout (``TIMEOUT`` unless
the caller gives one), so a peer that hangs fails the run.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
import os
import tempfile
from collections import Counter
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
TIMEOUT = datetime.timedelta(minutes=30)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices`` in row-major ``(data, model)`` order."""

    devices: tuple
    data: int
    model: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    def group(self, i: int) -> tuple:
        """The devices of data shard ``i``, its model shards in order."""
        return self.devices[i * self.model:(i + 1) * self.model]

    @property
    def data_devices(self) -> tuple:
        """The first device of each data shard's group."""
        return self.devices[::self.model]


def make_mesh(devices: Optional[Sequence[Any]] = None, data: Optional[int] = None,
              model: int = 1, device: Any = "cuda") -> Mesh:
    """A ``(data, model)`` mesh over ``devices`` (default: every device of
    ``device``'s type that this process sees: each CUDA device, none
    without CUDA, or the one CPU), the first ``data * model`` of them."""
    if devices is None:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if torch.device(device).type == "cuda" else [device])
    devs = [torch.device(d) for d in devices]
    n = len(devs)
    if data is None:
        data = max(1, n // model)
    if data * model > n or data < 1 or model < 1:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {n}")
    return Mesh(tuple(devs[:data * model]), data, model)


def _copy_to(tree: Any, device: torch.device) -> Any:
    """A copy of ``tree`` (a module, or tensors in dicts and lists) on
    ``device``."""
    if isinstance(tree, torch.nn.Module):
        return copy.deepcopy(tree).to(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True)
    if isinstance(tree, dict):
        return {k: _copy_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_to(v, device) for v in tree]
    return tree


def replicate(mesh: Mesh, tree: Any) -> List[Any]:
    """One copy of ``tree`` (a module, or tensors in dicts and lists) per
    entry of the mesh, each on its device; a repeated device holds a copy
    per entry."""
    return [_copy_to(tree, d) for d in mesh.devices]


def shard_batch(mesh: Mesh, batch: Any) -> List[Any]:
    """``batch`` (a tensor, or a tuple of them with a common leading axis)
    split in order into ``mesh.data`` equal shards, shard i on the first
    device of its model group (``mesh.data_devices[i]``)."""
    n = mesh.data

    def split(x, i):
        if isinstance(x, tuple):
            return tuple(split(v, i) for v in x)
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} rows does not split over the mesh data "
                             f"axis ({n})")
        k = x.shape[0] // n
        return x[i * k:(i + 1) * k].to(mesh.data_devices[i])

    return [split(batch, i) for i in range(n)]


# -- the process group --------------------------------------------------------

def in_group() -> bool:
    """Whether this process is a rank of a process group (the collectives
    run only then)."""
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if in_group() else 1


def rank() -> int:
    return dist.get_rank() if in_group() else 0


def default_backend(devices: Sequence[Any]) -> str:
    """NCCL when every rank has a CUDA device of its own, else gloo (the
    CPU, or ranks sharing a card: NCCL refuses two ranks on one GPU;
    gloo broadcasts and all-reduces CUDA tensors)."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


def init_distributed(multihost: bool = False, *, rank: Optional[int] = None,
                     world_size: Optional[int] = None, device: Any = None,
                     backend: Optional[str] = None, store: Optional[Any] = None,
                     timeout: datetime.timedelta = TIMEOUT) -> torch.device:
    """Join a process group and return this rank's device.

    ``multihost=True`` reads ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``): the
    device is ``cuda:LOCAL_RANK`` (``device`` overrides it) and the
    backend NCCL. Otherwise ``rank``, ``world_size``, ``device`` and a
    rendezvous ``store`` (e.g. a ``FileStore``) come from the caller. The backend defaults to ``default_backend`` of
    this rank's device."""
    if multihost:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        if device is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or default_backend([dev]), store=store, rank=rank,
                            world_size=world_size, timeout=timeout)
    return dev


def _worker(index: int, fn: Callable, args: tuple, devices: tuple, backend: str,
            path: str, timeout: datetime.timedelta, threads: Optional[int]) -> None:
    torch.set_num_threads(threads or max(1, torch.get_num_threads() // len(devices)))
    store = dist.FileStore(path, len(devices))
    dev = init_distributed(rank=index, world_size=len(devices), device=devices[index],
                           backend=backend, store=store, timeout=timeout)
    try:
        fn(dev, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, mesh: Mesh, args: tuple = (), *, store_path: Optional[str] = None,
          timeout: datetime.timedelta = TIMEOUT, threads: Optional[int] = None) -> None:
    """Run ``fn(device, *args)`` in one spawned process a rank, rank i on
    the mesh's i-th device (``default_backend``), in a group that meets in
    a ``FileStore`` at ``store_path`` (a new temporary file when None),
    each rank with ``threads`` torch threads (default: this host's share);
    returns when every rank has, and raises when one fails. ``fn`` must be
    importable by name (a module-level function)."""
    import torch.multiprocessing as mp

    devices = tuple(str(d) for d in mesh.devices)
    backend = default_backend(devices)
    with tempfile.TemporaryDirectory(prefix="yoloret-dp-") as tmp:
        path = store_path or os.path.join(tmp, "store")
        mp.start_processes(_worker, args=(fn, args, devices, backend, path, timeout, threads),
                           nprocs=len(devices), start_method="spawn", join=True)


# payload bytes of the collectives by kind, while ``count_collectives`` runs
_counts: Optional[Counter] = None


@contextlib.contextmanager
def count_collectives() -> Iterator[Counter]:
    """Inside, every collective of this module adds its payload bytes
    (the tensor it hands the process group) to the yielded counter under
    its kind, ``all_reduce`` or ``broadcast``."""
    global _counts
    before, _counts = _counts, Counter()
    try:
        yield _counts
    finally:
        _counts = before


def _all_reduce(t: torch.Tensor) -> None:
    if _counts is not None:
        _counts["all_reduce"] += t.numel() * t.element_size()
    dist.all_reduce(t)


def _broadcast(t: torch.Tensor, src: int) -> None:
    if _counts is not None:
        _counts["broadcast"] += t.numel() * t.element_size()
    dist.broadcast(t, src)


def barrier() -> None:
    if in_group():
        dist.barrier()


def _buckets(tensors: Sequence[torch.Tensor]) -> Dict[Any, List[torch.Tensor]]:
    out: Dict[Any, List[torch.Tensor]] = {}
    for t in tensors:
        out.setdefault((t.dtype, t.device), []).append(t)
    return out


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks, in place: one flat
    buffer a dtype, summed, divided by the world size. Every rank ends
    with the same bits. No-op without a group."""
    if not in_group():
        return
    n = world()
    for group in _buckets(tensors).values():
        flat = torch._utils._flatten_dense_tensors(group)
        _all_reduce(flat)
        flat.div_(n)
        for t, v in zip(group, torch._utils._unflatten_dense_tensors(flat, group)):
            t.copy_(v)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor with rank ``src``'s, in place (one flat
    buffer a dtype). No-op without a group."""
    if not in_group():
        return
    for group in _buckets(tensors).values():
        flat = torch._utils._flatten_dense_tensors(group)
        _broadcast(flat, src)
        for t, v in zip(group, torch._utils._unflatten_dense_tensors(flat, group)):
            t.copy_(v)


class _MeanOverRanks(torch.autograd.Function):
    """y = the mean over the ranks of x; the backward is the same mean of
    the gradients, since every rank's loss reads y."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        _all_reduce(y)
        return y.div_(world())

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        _all_reduce(g)
        return g.div_(world())


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks of per-rank ``x`` (e.g. a BatchNorm's
    statistics, each rank holding as many rows), differentiably. Identity
    without a group."""
    return _MeanOverRanks.apply(x) if in_group() else x
