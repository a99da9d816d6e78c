"""Weight files and training checkpoints in the port's own ``torch.save``
format. Port of ``yoloret_tpu/utils/checkpoint.py``, whose files are
Orbax directories; reading those waits for ROADMAP.md, queue 1, item 5.

  * ``save_params`` / ``load_params``: one weight file, the stage-end
    ``*_trained_weights_{stage_1,final}.pt`` that ``--mode=MAP --model=``
    and ``--train_unfreeze`` read: the model's state dict, with the EMA
    of the parameters under ``ema_params.<name>`` when there is one.
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
    state_dict())``) reads as it is."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory (an Orbax checkpoint of the JAX package?): reading Orbax "
            "weight files is not ported to yoloret_tpu_torch yet: it waits for side paths, "
            "item 5 (ROADMAP.md, queue 1)")
    tree = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v for k, v in tree.items() if not k.startswith(EMA_PREFIX)}
    if use_ema:
        ema = {k[len(EMA_PREFIX):]: v for k, v in tree.items() if k.startswith(EMA_PREFIX)}
        if not ema:
            raise ValueError(f"{path} holds no EMA weights (train with --use_ema)")
        sd.update(ema)
    return sd


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
