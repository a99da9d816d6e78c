"""Spatial parallelism: the mesh's ``model`` axis splits each image's
height. Port of ``yoloret_tpu/parallel/mesh.py::spatial_sharding``
(``P(DATA_AXIS, MODEL_AXIS)`` on ``[B, H, W, C]``), where GSPMD inserts
the convolutions' halo exchanges; here the port inserts them itself.

**Partition** (``partition_rows``). An image's rows are cut at multiples
of the backbones' deepest stride (32): shard k of m starts at row
``32 * round(k * R / m)`` (halves up), R = H / 32 the rows of the
deepest map. Every map of the network then splits at whole rows of its
own level, and every pooling window, ``upsample2x``, ``space_to_depth``,
concatenation and elementwise op is local to a shard. Only convolutions
with a kernel above 1 or a stride (their halo rows) and the global means
of squeeze-excite and FCA cross a shard boundary.

**Exchange** (``Shard.rows``, ``Shard.sum``). One process drives the
mesh's devices, a thread a model shard, each running the stock module
forward (or the fused MobileNetV2 forward) on its rows under a
thread-local ``Shard`` context (``current``). The layer functions that
cross a boundary (``nn/layers.py``: ``conv2d_same``, ``mean_hw``;
``nn/fused_infer.py``: the fused block) ask it for "rows [a, b) of this
level's map", which it takes from the shards that own them (more than
one neighbour where a halo is deeper than a shard) and copies to its own
device on its current stream, or for a sum over the group. Every shard
calls them in the same order (they run the same layers), so the i-th
call of each shard meets the others' i-th at a rendezvous of the group.
One shard thread runs at a time: at a rendezvous it hands the turn to
the next (``_Turns``), so the threads enqueue their work one after the
other without contending for the interpreter lock. Each wait has a
timeout, and an exception in one shard fails the call.

Copies between two devices run on the source device's current stream
and wait for the destination's (PyTorch's cross-device copy); every
shard thread runs on the streams that were current in the caller.

``spatial_apply`` is the counterpart of ``jax.jit(model.apply,
in_shardings=(replicate, spatial_sharding(mesh)), out_shardings=
replicate)``: inference only, weights on each device once
(``spatial_params``; the int8 backbone's params too), the three heads
whole on the mesh's first device. ``spatial_forward``'s ``crop`` runs
the zoom ensemble's centre crop as an image of its own.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from yoloret_tpu_torch.device import on_device
from yoloret_tpu_torch.parallel.mesh import Mesh

DEEPEST_STRIDE = 32
TIMEOUT = 300.0  # seconds a row shard thread waits for its turn

_local = threading.local()


class Replica(NamedTuple):
    """One device's weights of the inference forward: the model, its int8
    params (``nn/int8_infer.quantize_from_data``'s tree, or None) and its
    fused MobileNetV2 params (``nn/fused_infer.fused_params``, or None);
    a replica with int8 params has no fused ones."""
    model: Any
    qp: Optional[Dict[str, Any]]
    fused: Any


def partition_rows(height: int, parts: int) -> List[Tuple[int, int]]:
    """Input rows [r0, r1) of each of ``parts`` row shards of a
    ``height``-row image: cuts at multiples of the deepest stride (32),
    shard k's first row ``32 * round(k * R / parts)`` (halves up), R =
    height / 32; e.g. 320 rows over 4 shards: 96/64/96/64."""
    if height % DEEPEST_STRIDE:
        raise ValueError(f"image height {height} is not a multiple of {DEEPEST_STRIDE}")
    deep = height // DEEPEST_STRIDE
    if parts > deep:
        raise ValueError(f"the mesh model axis ({parts}) exceeds the {deep} rows of the deepest "
                         f"(/{DEEPEST_STRIDE}) map of a {height}-row image")
    cuts = [DEEPEST_STRIDE * ((2 * k * deep + parts) // (2 * parts)) for k in range(parts + 1)]
    return list(zip(cuts[:-1], cuts[1:]))


def current() -> Optional["Shard"]:
    """The row shard this thread runs, or None outside ``spatial_apply``."""
    return getattr(_local, "shard", None)


class _Aborted(RuntimeError):
    """Another shard of the group failed."""


class _Turns:
    """One runnable shard thread at a time: a thread runs until it waits
    at an exchange or ends, then hands the turn to the next unfinished
    thread in order. The threads then never contend for the interpreter
    lock, which made free-running shard threads enqueue their work several
    times slower than the same work one thread after the other."""

    def __init__(self, n: int):
        self.go = [threading.Event() for _ in range(n)]
        self.done = [False] * n

    def wait(self, t: int) -> None:
        if not self.go[t].wait(TIMEOUT):
            raise TimeoutError(f"row shard thread {t} waited {TIMEOUT} s for its turn")
        self.go[t].clear()

    def hand_on(self, t: int) -> bool:
        """Wake the next unfinished thread after ``t``; False if none."""
        n = len(self.go)
        for d in range(1, n):
            u = (t + d) % n
            if not self.done[u]:
                self.go[u].set()
                return True
        return False

    def finish(self, t: int) -> None:
        self.done[t] = True
        self.hand_on(t)


class _Group:
    """The rendezvous of one data shard's row shards, threads ``members``
    of ``turns``: at its n-th call each shard posts a value and, once
    every shard has, receives all of them."""

    def __init__(self, turns: _Turns, members: Sequence[int]):
        self.turns, self.members = turns, list(members)
        self.posts: Dict[int, list] = {}
        self.taken: Dict[int, int] = {}
        self.error: Optional[BaseException] = None

    def fail(self, e: BaseException) -> None:
        if self.error is None:
            self.error = e

    def exchange(self, index: int, step: int, value: Any) -> list:
        size = len(self.members)
        slot = self.posts.setdefault(step, [_EMPTY] * size)
        slot[index] = value
        while self.error is None and any(v is _EMPTY for v in slot):
            missing = [k for k, v in enumerate(slot) if v is _EMPTY]
            if all(self.turns.done[self.members[k]] for k in missing):
                raise RuntimeError(f"row shards {missing} ended before exchange {step}")
            if self.turns.hand_on(self.members[index]):
                self.turns.wait(self.members[index])
        if self.error is not None:
            raise _Aborted("another row shard of this data shard failed") from self.error
        self.taken[step] = self.taken.get(step, 0) + 1
        if self.taken[step] == size:
            del self.posts[step], self.taken[step]
        return list(slot)


_EMPTY = object()


class Shard:
    """Row shard ``index`` of ``group``: input rows ``bounds[index]`` of a
    ``height``-row image, on ``device``."""

    def __init__(self, group: _Group, index: int, bounds: Sequence[Tuple[int, int]],
                 height: int, device: torch.device):
        self.group, self.index, self.bounds = group, index, list(bounds)
        self.height, self.device = height, device
        self._step = 0

    def level(self, rows: int, stride: int = 1) -> Tuple[int, int, int]:
        """(first row, rows, global rows) of this shard's part of a map
        of which it holds ``rows`` rows; raises unless the part starts and
        ends at multiples of ``stride`` (an op reading whole groups of
        ``stride`` rows is then local to the shard)."""
        r0, r1 = self.bounds[self.index]
        if (r1 - r0) % rows or r0 % ((r1 - r0) // rows):
            raise ValueError(f"a map of {rows} rows on a shard of input rows [{r0}, {r1}) is not "
                             "at a level of the row partition")
        s = (r1 - r0) // rows
        first = r0 // s
        if first % stride or rows % stride:
            raise ValueError(f"shard rows [{first}, {first + rows}) do not align to stride "
                             f"{stride}")
        return first, rows, self.height // s

    def _exchange(self, value: Any) -> list:
        self._step += 1
        run_groups.exchanges += 1
        return self.group.exchange(self.index, self._step, value)

    def rows(self, x: torch.Tensor, a: int, b: int) -> torch.Tensor:
        """Rows [a, b) of the whole map of which ``x`` [B, h, W, C] is this
        shard's part, contiguous, on this shard's device; rows outside the
        map are zeros. Every shard of the group must call it in turn."""
        _, _, total = self.level(x.shape[1])
        s = self.height // total
        parts = self._exchange(x)
        pieces = []
        if a < 0:
            pieces.append(x.new_zeros((x.shape[0], min(-a, b - a), *x.shape[2:])))
        for (r0, r1), part in zip(self.bounds, parts):
            lo, hi = max(a, r0 // s), min(b, r1 // s)
            if lo < hi:
                pieces.append(part[:, lo - r0 // s:hi - r0 // s].to(self.device))
        if b > total:
            pieces.append(x.new_zeros((x.shape[0], min(b - total, b - a), *x.shape[2:])))
        return torch.cat(pieces, dim=1) if len(pieces) > 1 else pieces[0].contiguous()

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every shard's ``t`` (same shape), added in shard
        order, so each shard gets the same bits, on this shard's device."""
        parts = self._exchange(t)
        out = parts[0].to(self.device)
        for p in parts[1:]:
            out = out + p.to(self.device)
        return out


def _streams(devices: Sequence[torch.device]) -> List[torch.cuda.Stream]:
    return [torch.cuda.current_stream(d) for d in dict.fromkeys(devices) if d.type == "cuda"]


def run_groups(fn: Callable[[torch.Tensor], Any], mesh: Mesh, shards: Sequence[torch.Tensor]
               ) -> List[List[Any]]:
    """``fn(rows)`` on every row shard of every data shard, a thread each
    under its ``Shard`` context and without autograd, one thread running
    at a time (``_Turns``): ``shards[i]`` is data shard i's images [b, H,
    W, C], split by ``partition_rows`` over ``mesh.group(i)``. Returns,
    per data shard, each row shard's result in order. Raises the first
    shard's exception (a timed-out wait included) after every thread has
    ended. ``run_groups.exchanges`` counts the row shards' calls of the
    exchange (``Shard.rows``, ``Shard.sum``), each shard's call once."""
    height = shards[0].shape[1]
    if any(x.shape[1] != height for x in shards):
        raise ValueError("every data shard must have the same height")
    bounds = partition_rows(height, mesh.model)
    streams = _streams(mesh.devices)
    cpu_threads = torch.get_num_threads()  # a new thread would take every core
    results: List[List[Any]] = [[None] * mesh.model for _ in shards]
    errors: List[BaseException] = []
    turns = _Turns(len(shards) * mesh.model)

    def work(t: int, i: int, k: int, group: _Group, x: torch.Tensor, dev: torch.device) -> None:
        try:
            turns.wait(t)
            torch.set_num_threads(cpu_threads)
            for st in streams:
                torch.cuda.set_stream(st)
            _local.shard = Shard(group, k, bounds, height, dev)
            with torch.no_grad(), on_device(dev):
                results[i][k] = fn(x[:, bounds[k][0]:bounds[k][1]].to(dev))
        except Exception as e:  # every failure ends the whole call
            if not isinstance(e, _Aborted):
                errors.append(e)
            group.fail(e)
        finally:
            _local.shard = None
            turns.finish(t)

    threads = []
    for i, x in enumerate(shards):
        members = range(i * mesh.model, (i + 1) * mesh.model)
        group = _Group(turns, members)
        for k, (t, dev) in enumerate(zip(members, mesh.group(i))):
            threads.append(threading.Thread(target=work, args=(t, i, k, group, x, dev),
                                            name=f"row-shard-{i}-{k}", daemon=True))
    for t in threads:
        t.start()
    turns.go[0].set()
    for t in threads:
        t.join(TIMEOUT * 4)
        if t.is_alive():
            raise TimeoutError(f"{t.name} did not end within {TIMEOUT * 4} s")
    if errors:
        raise errors[0]
    return results


run_groups.exchanges = 0


def spatial_params(model, mesh: Mesh, qp: Optional[Dict[str, Any]] = None
                   ) -> Dict[torch.device, Replica]:
    """{device: Replica} for every distinct device of the mesh: ``model``
    itself on its own device, a copy elsewhere; with ``qp``
    (``nn/int8_infer.quantize_from_data``'s tree, calibrated once) that
    tree, copied once a device, else the fused MobileNetV2 weights
    (folded and packed, None for another backbone) once a device. The
    shards that run on a device share its entry."""
    import copy

    from yoloret_tpu_torch.nn.fused_infer import fused_params
    from yoloret_tpu_torch.parallel.mesh import _copy_to

    home = next(model.parameters()).device
    out = {}
    for dev in dict.fromkeys(mesh.devices):
        m = model if dev == home else copy.deepcopy(model).to(dev)
        if qp is not None:
            out[dev] = Replica(m, qp if dev == home else _copy_to(qp, dev), None)
            continue
        with on_device(dev):
            out[dev] = Replica(m, None, fused_params(m))
    return out


def _shard_forward(params: Dict[torch.device, Replica]) -> Callable:
    from yoloret_tpu_torch.nn.fused_infer import mobilenetv2_fused_features
    from yoloret_tpu_torch.nn.int8_infer import int8_detector_apply

    def fn(x: torch.Tensor):
        model, qp, fused = params[current().device]
        if qp is not None:
            return int8_detector_apply(model, qp, x)
        x = x.to(model.dtype)
        if fused is not None:
            return model.neck_heads(mobilenetv2_fused_features(x.contiguous(), fused))
        return model.forward_unchecked(x)

    return fn


def spatial_forward(model, mesh: Mesh, shards: Sequence[torch.Tensor],
                    params: Dict[torch.device, Replica],
                    crop: Optional[Tuple[int, int, int, int]] = None
                    ) -> List[Tuple[torch.Tensor, ...]]:
    """The inference heads of each data shard's images (``shards[i]``,
    whole images [b, H, W, 3]) over its model group's row shards, each
    head whole on the group's first device: the int8 forward where
    ``params`` holds int8 params, else the fused forward for a
    MobileNetV2 backbone and the stock forward for any other. ``params``
    is ``spatial_params(model, mesh[, qp])``. ``crop`` (y0, x0, h, w)
    takes rows [y0, y0 + h) and columns [x0, x0 + w) of each image
    instead, cut on the data shard's device and split over the row
    shards as an image of its own (``partition_rows(h, model)``)."""
    if crop is not None:
        y0, x0, h, w = crop
        shards = [x[:, y0:y0 + h, x0:x0 + w].contiguous() for x in shards]
    for x in shards:
        model.check_input(x)
    outs = run_groups(_shard_forward(params), mesh, shards)
    return [tuple(torch.cat([h.to(mesh.data_devices[i]) for h in heads], dim=1)
                  for heads in zip(*group))
            for i, group in enumerate(outs)]


def spatial_apply(model, mesh: Mesh, images: torch.Tensor,
                  params: Dict[torch.device, Replica]) -> Tuple[torch.Tensor, ...]:
    """``model``'s inference heads for ``images`` [B, H, W, 3] with the
    batch split over the mesh's ``data`` axis and the rows over its
    ``model`` axis, returned whole on the mesh's first device (the heads
    of ``nn/fused_infer.fused_detector_apply``, or of
    ``nn/int8_infer.int8_detector_apply`` with int8 params). ``params``
    (``spatial_params(model, mesh[, qp])``) holds the weights on each
    device, made once and reused across calls."""
    n = mesh.data
    if images.shape[0] % n:
        raise ValueError(f"batch of {images.shape[0]} rows does not split over the mesh data "
                         f"axis ({n})")
    k = images.shape[0] // n
    heads = spatial_forward(model, mesh, [images[i * k:(i + 1) * k] for i in range(n)], params)
    first = mesh.devices[0]
    return tuple(torch.cat([h[j].to(first) for h in heads]) for j in range(len(heads[0])))
