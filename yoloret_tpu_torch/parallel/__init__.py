"""Data parallelism: the device mesh, the process group and its
collectives (``parallel.mesh``), and device prefetch
(``parallel.prefetch``). Port of ``yoloret_tpu/parallel/``."""

from yoloret_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    make_mesh,
    replicate,
    shard_batch,
)
from yoloret_tpu_torch.parallel.prefetch import device_prefetch

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "make_mesh", "replicate", "shard_batch",
           "device_prefetch"]
