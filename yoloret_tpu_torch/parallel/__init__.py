"""Data and spatial parallelism: the device mesh, the process group and
its collectives (``parallel.mesh``), device prefetch
(``parallel.prefetch``), and the forward with image rows split over the
mesh's model axis (``parallel.spatial``). Port of
``yoloret_tpu/parallel/``."""

from yoloret_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    make_mesh,
    replicate,
    shard_batch,
)
from yoloret_tpu_torch.parallel.prefetch import device_prefetch
from yoloret_tpu_torch.parallel.spatial import partition_rows, spatial_apply, spatial_params

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "make_mesh", "replicate", "shard_batch",
           "device_prefetch", "partition_rows", "spatial_apply", "spatial_params"]
