"""Run configuration: typed dataclass + YAML overlay. A copy of the JAX
package's ``yoloret_tpu/configs/config.py`` (``RunConfig``,
``load_config``), host-only. The port's CLI reads the fields of MAP mode;
the others wait for the modes that read them.

Mirrors the reference's absl-flag surface (reference: code/main.py:20-97)
and its optional YAML config overlay (code/main.py:111-135), as one
``RunConfig`` dataclass.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass
class RunConfig:
    # model
    backbone: str = "mobilenetv2x75"
    input_size: Tuple[int, int] = (320, 320)  # multiples of 32
    num_scales: int = 3
    model: Optional[str] = None  # checkpoint to load
    # data
    train_dataset: Optional[str] = None
    val_dataset: Optional[str] = None
    test_dataset: Optional[str] = None
    classes_path: Optional[str] = None
    anchors_path: Optional[str] = None
    max_boxes: int = 20
    augment: Optional[dict] = None  # AugmentConfig field overrides (e.g.
    # {"hue": 0.1, "min_scale": 0.5}); None = reference defaults
    autoaugment_policy: Optional[str] = None  # online AutoAugment-for-
    # detection policy ("v0".."v3") applied per training sample on host
    # (tools/autoaugment.py). The reference only ships AutoAugment as an
    # unused offline script; this wires it into the live pipeline.
    multi_scale: Optional[List[int]] = None  # e.g. [288, 320, 352]: each
    # epoch trains at a size sampled round-robin from this list (all
    # multiples of 32); one compiled step per size, fully-convolutional
    # heads make weights size-agnostic. None = fixed input_size.
    # training (two-stage schedule, reference code/train.py:153-216)
    batch_size: int = 8  # per chip; global = batch_size * data-parallel size
    epochs: Tuple[int, int] = (100, 150)
    learning_rate: Tuple[float, float] = (1e-3, 1e-4)
    freeze: bool = True
    train_unfreeze: Optional[str] = None  # stage-1 ckpt to resume unfrozen
    truncate_block: Optional[float] = None  # freeze only backbone blocks
    # <= this depth index (the paper's truncation-point study); None
    # freezes the whole backbone in stage 1 (reference main configs)
    box_loss: str = "giou"
    class_loss: str = "bce"  # or "focal" (the reference defines focal but
    # leaves it commented out, model.py:660-661)
    ignore_thresh: float = 0.5
    use_adv: bool = False
    use_ema: bool = False
    ema_decay: float = 0.9999  # reference train.py:42-45 hard-codes
    # 0.9999 (horizon ~10k steps). On short schedules that average never
    # warms up (round-4 measurement: -0.01 mAP on a 360-step run); match
    # the decay horizon to the schedule — decay ~ 1 - 10/total_steps —
    # for the average to help (measured: docs/design.md EMA table).
    rfcr: str = "weighted_sum"  # RFCR fusion — the paper's ablation axis
    # (reference code/yolo3/model.py:117-168): 'weighted_sum' (the
    # contribution), 'concat' (the legacy scarf proto-RFCR), 'none'
    # (backbone taps feed the neck directly — the no-RFCR baseline).
    # Measured deltas: tools/ablation.py; table in docs/design.md.
    remat: bool = False  # jax.checkpoint the backbone in the train
    # step: backward recomputes the backbone forward instead of keeping
    # its activations resident — O(taps) not O(depth) activation memory,
    # for ~+30% backbone forward FLOPs. Lets the batch grow past the
    # HBM activation budget (gradients equal the stock path bitwise-
    # modulo-reassociation, tests/test_remat.py).
    checkpoint_every: int = 3  # epochs (reference train.py:74-79)
    early_stopping: bool = False  # stop the stage when val_loss has not
    # improved for `early_stopping_patience` epochs (reference
    # code/train.py:101-105: EarlyStopping(val_loss, patience=epochs//2))
    early_stopping_patience: Optional[int] = None  # None = stage epochs // 2
    map_every: int = 0  # if > 0 and test_dataset is set, run the VOC mAP
    # evaluator every N epochs; mAP always runs once at stage end when
    # test_dataset is set (reference MAPCallback-as-training-callback
    # intent, code/yolo3/map.py:237-248 — mis-wired there, train.py:69-70)
    tb_images: int = 0  # if > 0, write N augmented training inputs (with
    # current-model detections drawn) per epoch to TensorBoard
    # (write_images parity, reference code/train.py:71-73)
    resume: bool = False  # restore the latest periodic checkpoint (incl.
    # optimizer state) and continue — preemption recovery the reference
    # lacks (SURVEY §5: manual restart only)
    log_dir: str = "logs"
    # inference / eval
    score_threshold: float = 0.6
    nms_iou: float = 0.5
    exact_nms: bool = False  # MAP mode: reference-exact per-class NMS
    # over every grid position (exact top-k, per-class pools) instead of
    # the measured-lossless shared-pool fast path (tools/topk_study.py)
    # runtime
    opt: Optional[str] = None
    seed: int = 0
    bf16: bool = True
    mesh_data: Optional[int] = None  # data-parallel size; default all devices
    multihost: bool = False  # call jax.distributed.initialize() (DCN multi-
    # host; coordinator from env: JAX_COORDINATOR_ADDRESS etc.)
    quantize: bool = False
    int8: bool = False  # serve IMAGE/VIDEO/MAP through the on-TPU W8A8
    # backbone (nn/int8_infer.py); calibration images come from the
    # test/train annotation lists when set
    quantize_samples: int = 32  # calibration images for full-int8 TFLite
    # (drawn from test/train annotation lists when set, synthetic noise
    # otherwise)
    prune: bool = False
    export: Optional[str] = None
    image: Optional[str] = None  # input for IMAGE mode
    video: Optional[str] = None  # input for VIDEO mode (0 = webcam)
    track_interval: int = 1  # VIDEO mode: re-detect every N frames and
    # track (OpenCV CSRT/MIL) in between (reference yolo.py:470-520);
    # 1 = detect every frame (TPU-native default)
    output: Optional[str] = None  # output path for IMAGE/VIDEO/EXPORT

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


def _coerce(value, field_type, current):
    if isinstance(current, tuple) and isinstance(value, (list, tuple)):
        return tuple(value)
    return value


def load_config(path: str, base: Optional[RunConfig] = None) -> RunConfig:
    """YAML overlay onto a RunConfig (reference: code/main.py:111-135)."""
    import yaml

    cfg = base or RunConfig()
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    fields = {f.name: f for f in dataclasses.fields(RunConfig)}
    unknown = set(data) - set(fields)
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    kw = {}
    for k, v in data.items():
        kw[k] = _coerce(v, fields[k].type, getattr(cfg, k))
    return cfg.replace(**kw)
