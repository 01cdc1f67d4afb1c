from video_vae_tpu_torch.core.config import (
    DynamicHParams,
    LossConfig,
    ModelConfig,
    OptimConfig,
    VAEConfig,
    tiny_config,
)
from video_vae_tpu_torch.core.device import resolve_device

__all__ = [
    "DynamicHParams",
    "LossConfig",
    "ModelConfig",
    "OptimConfig",
    "VAEConfig",
    "resolve_device",
    "tiny_config",
]
