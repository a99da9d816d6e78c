"""Weight files and training checkpoints in the port's own ``torch.save``
format. Port of ``yoloret_tpu/utils/checkpoint.py``, whose files are
Orbax directories.

  * ``save_params`` / ``load_params``: one weight file, the stage-end
    ``*_trained_weights_{stage_1,final}.pt`` that ``--mode=MAP --model=``
    and ``--train_unfreeze`` read: the model's state dict, with the EMA
    of the parameters under ``ema_params.<name>`` when there is one.
    ``load_params`` also reads the JAX package's weight directories (its
    ``save_params``, e.g. its trainer's stage-end
    ``*_trained_weights_{stage_1,final}``) with ``tensorstore`` alone:
    ``orbax.checkpoint`` imports JAX, which the port does not. The port
    writes only its own files.
  * ``CheckpointManager``: a checkpoint every ``every`` epochs, at most
    ``max_to_keep`` kept, the best by validation loss (the reference's
    ModelCheckpoint(period=3, save_best_only=True, monitor='val_loss')),
    and ``restore`` for ``--resume``. Unlike Orbax it always keeps the
    latest checkpoint too, the one a resumed run reads.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

EMA_PREFIX = "ema_params."


def _atomic_save(obj: Any, path: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_params(path: str, state_dict: Mapping[str, torch.Tensor],
                ema: Optional[Mapping[str, torch.Tensor]] = None) -> None:
    """Write a weight file (overwrites): ``state_dict`` and, given, the
    EMA parameters, as CPU tensors."""
    out = {k: v.detach().cpu() for k, v in state_dict.items()}
    for k, v in (ema or {}).items():
        out[EMA_PREFIX + k] = v.detach().cpu()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _atomic_save(out, path)


def load_params(path: str, use_ema: bool = False) -> Dict[str, torch.Tensor]:
    """The model state dict of a weight file: its parameters, or with
    ``use_ema`` its EMA parameters (the BatchNorm statistics are the
    model's either way). A plain state dict (``torch.save(model.
    state_dict())``) reads as it is; a directory is read by
    ``load_orbax_params``."""
    if os.path.isdir(path):
        return load_orbax_params(path, use_ema)
    tree = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v for k, v in tree.items() if not k.startswith(EMA_PREFIX)}
    if use_ema:
        ema = {k[len(EMA_PREFIX):]: v for k, v in tree.items() if k.startswith(EMA_PREFIX)}
        if not ema:
            raise ValueError(f"{path} holds no EMA weights (train with --use_ema)")
        sd.update(ema)
    return sd


ORBAX_COLLECTIONS = ("params", "batch_stats", "ema_params")


def read_orbax_tree(path: str) -> dict:
    """The ``ORBAX_COLLECTIONS`` of an Orbax weight directory written by
    the JAX package's ``save_params`` (a ``StandardCheckpointer`` tree,
    OCDBT), as a nested dict of numpy arrays in their stored dtype.

    ``_METADATA`` (JSON) names every leaf by its key path; a leaf
    ``('params', 'a', 'kernel')`` is the zarr array ``params.a.kernel/``
    inside the OCDBT store at the directory's root. Needs
    ``tensorstore``."""
    import tensorstore as ts

    path = os.path.abspath(path)
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.exists(meta_path):
        raise ValueError(f"{path} is a directory without _METADATA: not a weight directory "
                         "of the JAX package's save_params")
    with open(meta_path) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{path}: only OCDBT checkpoints of zarr v2 arrays are read, as "
                         "save_params writes them")
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        if keys[0] not in ORBAX_COLLECTIONS:
            continue
        store = ts.open({"driver": "zarr", "kvstore": {
            "driver": "ocdbt", "base": f"file://{path}/", "path": ".".join(keys) + "/"}},
            open=True, read=True).result()
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.asarray(store.read().result())
    return tree


def load_orbax_params(path: str, use_ema: bool = False) -> Dict[str, torch.Tensor]:
    """The port's state dict (float32) of a JAX weight directory: its
    ``params`` and ``batch_stats`` through ``weights.from_flax``; with
    ``use_ema`` its ``ema_params`` in place of the parameters where the
    tree has them, as the JAX ``Predictor`` reads it. The directory's
    other entries are not read: a JAX training checkpoint's optimizer
    state is optax's, so ``--resume`` reads only the port's own
    ``CheckpointManager``."""
    from yoloret_tpu_torch.weights import from_flax

    tree = read_orbax_tree(path)
    if "params" not in tree:
        raise ValueError(f"{path} holds no params")
    params = tree["ema_params"] if use_ema and "ema_params" in tree else tree["params"]
    return from_flax({"params": params, "batch_stats": tree.get("batch_stats", {})})


class CheckpointManager:
    """Periodic checkpoints ``epoch_<e>.pt`` in ``directory``, each a dict
    ``{"tree": ..., "val_loss": float}``."""

    def __init__(self, directory: str, every: int = 3, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.every = every
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._metrics_path = os.path.join(self.directory, "metrics.json")
        self._metrics: Dict[int, float] = {}
        if os.path.exists(self._metrics_path):
            with open(self._metrics_path) as f:
                self._metrics = {int(k): v for k, v in json.load(f).items()}
        self._metrics = {e: v for e, v in self._metrics.items() if os.path.exists(self._path(e))}

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch:06d}.pt")

    def maybe_save(self, epoch: int, tree: Any, val_loss: float) -> bool:
        if self.every and (epoch + 1) % self.every != 0:
            return False
        _atomic_save({"tree": tree, "val_loss": float(val_loss)}, self._path(epoch))
        self._metrics[epoch] = float(val_loss)
        latest = max(self._metrics)
        by_loss = sorted(self._metrics, key=lambda e: (self._metrics[e], -e))
        keep = set(by_loss[:self.max_to_keep]) | {latest}
        for e in list(self._metrics):
            if e not in keep:
                os.remove(self._path(e))
                del self._metrics[e]
        with open(self._metrics_path, "w") as f:
            json.dump(self._metrics, f)
        return True

    def latest_epoch(self) -> Optional[int]:
        return max(self._metrics) if self._metrics else None

    def restore(self, epoch: int) -> Any:
        return torch.load(self._path(epoch), map_location="cpu", weights_only=True)["tree"]
