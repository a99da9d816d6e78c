"""Run configuration of the port's CLI."""

from yoloret_tpu_torch.configs.config import RunConfig, load_config

__all__ = ["RunConfig", "load_config"]
