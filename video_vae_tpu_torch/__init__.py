"""PyTorch + CUDA port of the video VAE, beside the JAX package ``video_vae_tpu``.

It mirrors the JAX package's layout (``core``, ``ops``, ``models``, ``train``)
and its module and parameter names, and imports nothing of JAX. Entry points
run on the card unless the caller passes ``device="cpu"``; on a CPU tensor a
kernel's plain PyTorch version runs, on a CUDA tensor the CUDA kernel.
"""

from video_vae_tpu_torch.core.config import (
    DynamicHParams,
    LossConfig,
    ModelConfig,
    OptimConfig,
    VAEConfig,
    tiny_config,
)
from video_vae_tpu_torch.models.vae import VideoVAE
from video_vae_tpu_torch.train.checkpoint import load_jax_params
from video_vae_tpu_torch.train.setup import create_optimizer
from video_vae_tpu_torch.train.step import build_perceptual, eval_step, reconstruct, train_step

__all__ = [
    "DynamicHParams",
    "LossConfig",
    "ModelConfig",
    "OptimConfig",
    "VAEConfig",
    "VideoVAE",
    "build_perceptual",
    "create_optimizer",
    "eval_step",
    "load_jax_params",
    "reconstruct",
    "tiny_config",
    "train_step",
]
