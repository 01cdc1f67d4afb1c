from video_vae_tpu_torch.core.config import (
    DataConfig,
    DynamicHParams,
    LossConfig,
    MeshConfig,
    ModelConfig,
    OptimConfig,
    TrainConfig,
    VAEConfig,
    tiny_config,
)
from video_vae_tpu_torch.core.device import resolve_device

__all__ = [
    "DataConfig",
    "DynamicHParams",
    "LossConfig",
    "MeshConfig",
    "ModelConfig",
    "OptimConfig",
    "TrainConfig",
    "VAEConfig",
    "resolve_device",
    "tiny_config",
]
